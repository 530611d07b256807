"""``fused_inplace_share`` on summaries made by hand, each value worked out
beside it, and on a small summary recorded on the card from a program with
the ``fused.layout`` span (``record_fused_layout_summary.py``, kept as
``data/fused_layout_summary_<cell>.json``); on the older recordings, made
before the span, it reads nothing."""

import importlib
import json
import math
from pathlib import Path

import pytest

from perfbench import harness, trace
from perfbench.count import ring
from perfbench.kinds import train
from perfbench.metrics import fused_inplace_share
from perfbench.tests import record_fused_layout_summary, record_ring_layout_summaries, small

DATA = Path(__file__).resolve().parent / "data"
CELL = record_fused_layout_summary.CELL
OLDER = sorted(p.name for p in DATA.glob("*.json")
               if not p.name.startswith("fused_layout_summary_"))


def made_by_hand():
    names = [trace.WINDOW, "repro_torch::step.reduce", "repro_torch::fused.layout",
             "repro_torch::ring.hop", "aten::copy_", "copy_kernel"]
    ops = [[0, -1, [], [], []],
           [1, 0, [], [], []],                      # step.reduce
           [2, 1, [[], []], ["Scalar"] * 2, [65600, 0]],   # a leaf in place
           [3, 1, [[]], ["Scalar"], [12300]],       # its hop
           [4, 3, [], [], []],
           [2, 1, [[], []], ["Scalar"] * 2, [592, 64]],    # scales copied
           [2, 1, [[]], ["Scalar"], [None]]]        # not a layout's two counts
    kernels = [[0.001, 0.000002, 5, 4]]             # under the hop
    return {"window_s": 1.0, "names": names, "ops": ops, "kernels": kernels,
            "steps": 1}


def test_fused_inplace_share_by_hand():
    assert fused_inplace_share.read(made_by_hand()) == pytest.approx(
        100 * (65600 + 592) / (65600 + 592 + 64))


def test_fused_inplace_share_reads_nothing_without_its_spans_or_hops():
    s = made_by_hand()
    s["names"] = [n.replace("fused.layout", "fused.other") for n in s["names"]]
    assert fused_inplace_share.read(s) is None
    assert fused_inplace_share.read(dict(made_by_hand(), kernels=[])) is None
    s = made_by_hand()
    for op in s["ops"]:
        if op[0] == 2 and len(op[4]) == 2:
            op[4] = [0, 0]                          # layouts of no bytes
    assert fused_inplace_share.read(s) is None


def in_place_share(cell):
    """The share of the fused ring's message bytes written in place at the
    recording's small size: every message of a leaf but the scales of a
    trailer that is off 4 bytes (a chunk under a sub-block of a size 4 does
    not divide)."""
    from repro_torch.models.model import build_model
    from repro_torch.models.module import _flatten

    conf, _ = record_ring_layout_summaries.small_inputs(cell)
    w = 4
    in_place = copied = 0
    for _, spec in _flatten(build_model(train.port_config(conf)).param_specs()):
        nb, b = ring.chunk_layout(math.prod(spec.shape), w)
        trailer = ring.SCALE_BYTES * nb if nb * b % 4 else 0
        in_place += w * w * (nb * (b + ring.SCALE_BYTES) - trailer)
        copied += w * w * trailer
    return in_place / (in_place + copied)


def test_readers_on_the_summary_recorded_with_the_fused_layout_span():
    summary = json.loads((DATA / f"fused_layout_summary_{CELL}.json").read_text())
    got = fused_inplace_share.read(summary)
    assert got == pytest.approx(100 * in_place_share(CELL), rel=1e-12)
    names = [m["name"] for m in harness.per_layer(small.bench(), CELL)]
    assert "fused_inplace_share" in names
    for name in names:
        value = importlib.import_module(f"perfbench.metrics.{name}").read(summary)
        assert value is not None and 0 < value <= 105, (name, value)


@pytest.mark.parametrize("name", OLDER)
def test_fused_inplace_share_reads_nothing_before_the_span(name):
    assert fused_inplace_share.read(json.loads((DATA / name).read_text())) is None
