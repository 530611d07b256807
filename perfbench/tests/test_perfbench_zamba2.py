"""The Zamba2 cell's pieces: its readers (its own three, and ``b4_roofline``
and ``update_roofline``, which it shares) on a summary made by hand and on
one recorded from a traced run on the card (``record_zamba2_summary.py``),
B9's count (``count/ssd.py``) and the model flops (``count/flops_zamba2.py``)
against hand counts, and the plain reference against the program at a tiny
size."""

import importlib
import json
from pathlib import Path

import pytest
import torch

from perfbench import count, harness, trace
from perfbench.count import flops_zamba2, ssd
from perfbench.kinds.train import port_config
from perfbench.reference import common, train
from perfbench.tests import small
from perfbench.traffic import TokenWalk

DATA = Path(__file__).resolve().parent / "data"
CELL = "zamba2-7b-l12.ring-f32.w4"
READERS = ("b9_roofline", "b4_roofline", "update_roofline", "shared_block_device_ms",
           "mamba_device_ms")
X, DT, A, BC = [1, 128, 4, 32], [1, 128, 4], [4], [1, 128, 2, 16]
SSD_FWD = [X, DT, A, BC, BC, []]
SSD_BWD = [X, DT, A, BC, BC, [1, 4, 2, 16, 32], X, [], []]
FA = [[1, 64, 2, 224], [1, 64, 2, 224], [1, 64, 2, 224], [], [], [], []]


def read(name, summary):
    return importlib.import_module(f"perfbench.metrics.{name}").read(summary)


def made_by_hand():
    names = [trace.WINDOW, "repro_torch::hybrid.shared", "repro_torch::mamba.layer",
             "repro_torch::ssd_scan_fwd", "repro_torch::ssd_scan_bwd",
             "repro_torch::flash_attention_fwd", "aten::mm",
             "ssd_kernel", "fa_kernel", "mm_kernel",
             "autograd::engine::evaluate_function: SsdBackward"]
    ops = [[0, -1, [], [], []],
           [1, 0, [], [], [0, 1]],
           [2, 0, [], [], [3]],
           [3, 2, SSD_FWD, ["float"] * 6, [None] * 6],
           [5, 1, FA, ["float"] * 7, [None, None, None, True, None, 0, 0.1]],
           [6, 1, [[64, 448], [448, 224]], ["float", "float"], [None, None]],
           [10, -1, [], [], []],
           [4, 6, SSD_BWD, ["float"] * 9, [None] * 8 + [False]]]
    kernels = [[0.0, 0.02, 7, 3], [0.1, 0.01, 8, 4], [0.2, 0.03, 9, 5],
               [0.3, 0.04, 7, 7], [0.5, 0.05, 9, 2]]
    return {"window_s": 1.0, "names": names, "ops": ops, "kernels": kernels,
            "steps": 2, "step_flops": 1e12}


def test_readers_by_hand():
    s = made_by_hand()
    fwd = count.bound_s(*ssd.ssd_scan("fwd", SSD_FWD, ["float"] * 6))
    bwd = count.bound_s(*ssd.ssd_scan("bwd", SSD_BWD, ["float"] * 9))
    assert read("b9_roofline", s) == pytest.approx(100 * (fwd + bwd) / (0.02 + 0.04))
    fa = count.bound_s(*count.flash_attention("fwd", FA, ["float"] * 7))
    assert read("b4_roofline", s) == pytest.approx(100 * fa / 0.01)
    # the span's kernels: B4's and the product's (0.01 + 0.03) over 2 steps
    assert read("shared_block_device_ms", s) == pytest.approx(1000 * 0.04 / 2)
    # the layer's own kernels and its SSD forward's (0.05 + 0.02); the
    # backward on the engine's thread is outside the span
    assert read("mamba_device_ms", s) == pytest.approx(1000 * 0.07 / 2)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_their_work(name):
    s = made_by_hand()
    s["kernels"] = []
    assert read(name, s) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_on_the_recorded_summary(name):
    summary = json.loads((DATA / f"zamba2_summary_{CELL}.json").read_text())
    value = read(name, summary)
    assert value is not None and value > 0, (name, value)
    if name.endswith("roofline"):
        assert value <= 105, (name, value)
    assert {m["name"] for m in harness.per_layer(small.bench(), CELL)} >= set(READERS)


def test_ssd_count_by_hand():
    # b 1, s 128, h 4, p 32, n 16, g 2; chunks of 64: 2 chunks, 2080 pairs
    pairs, nc = 64 * 65 // 2, 2
    ops = nc * (2 * pairs * 2 * 16 + 4 * (pairs * 2 * 32 + 4 * 64 * 16 * 32))
    assert ssd.forward_ops(1, 128, 4, 32, 16, 2) == ops
    got_ops, got_bytes = ssd.ssd_scan("fwd", SSD_FWD, ["float"] * 6)
    x, dt, a, bc, state = 128 * 4 * 32 * 4, 128 * 4 * 4, 4 * 4, 128 * 2 * 16 * 4, 4 * 16 * 32 * 4
    assert (got_ops, got_bytes) == (ops, x + dt + a + 2 * bc + x + state)
    got_ops, got_bytes = ssd.ssd_scan("bwd", SSD_BWD, ["float"] * 9, with_initial=True)
    reads = x + dt + a + 2 * bc + x          # x, dt, A, B, C, dy; no d_final
    assert (got_ops, got_bytes) == (2 * ops, reads + (x + dt + a + 2 * bc) + state)
    # one group in the (B, S, N) layout: C B^T once
    flat = [X, DT, A, [1, 128, 16], [1, 128, 16], []]
    assert ssd.ssd_scan("fwd", flat, ["float"] * 6)[0] == \
        nc * (pairs * 2 * 16 + 4 * (pairs * 2 * 32 + 4 * 64 * 16 * 32))


def test_model_flops_by_hand():
    conf = harness.load_config("zamba2-7b-l12")
    s, seq = conf["sizes"], 4096
    d, a, f, r, v = 3584, 7168, 14336, 128, 32000
    mamba = 2 * d * (2 * 7168 + 2 * 2 * 64 + 112) + 2 * 7168 * d
    shared = 3 * 2 * a * 32 * 224 + 2 * 32 * 224 * d + 3 * 2 * d * f \
        + 2 * d * r + 2 * r * 2 * f + 2 * d * d
    attn = 4 * 224 * 32 * (seq * (seq + 1) // 2)
    scan = ssd.forward_ops(1, seq, 112, 64, 64, 2)
    want = (12 * mamba + 2 * shared + 2 * d * v) * seq + 2 * attn + 12 * scan
    assert flops_zamba2.forward(s, seq) == want
    assert 3.6e9 < want / seq < 3.7e9


def test_reference_against_the_program():
    from repro_torch.models.model import build_model
    from repro_torch.models.module import _flatten

    conf, mix = small.cell_inputs(CELL, seq=40)
    fam = train.family(conf)
    weights = common.draw(fam.layout(conf["sizes"]), 7, "cpu")
    batch = {k: torch.as_tensor(v[:2])
             for k, v in TokenWalk(mix, conf["sizes"]["vocab_size"], 7).batch(0).items()}
    leaves = {p: t.clone().requires_grad_(True) for p, t in weights.items()}
    ref_loss = fam.loss(conf["sizes"], leaves, batch["tokens"], batch["labels"])
    ref_grads = torch.autograd.grad(ref_loss, list(leaves.values()))
    model = build_model(port_config(conf))
    mine = {p: t.clone().requires_grad_(True) for p, t in weights.items()}
    loss = model.loss(common.nest(mine), batch)
    grads = torch.autograd.grad(loss, list(mine.values()))
    assert set(dict(_flatten(model.param_specs()))) == set(weights)
    # f32 sums in other orders on both sides (tests/test_torch_zamba2_7b.py)
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()), rel=1e-6)
    for path, g, r in zip(mine, grads, ref_grads):
        assert float((g - r).abs().max()) <= 2e-4 * float(r.abs().max()), path
