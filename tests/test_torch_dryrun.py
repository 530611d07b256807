"""The port's dry run (``repro_torch.launch.dryrun``) and its cost model
(``repro_torch.launch.cost_analysis``) against the reference's
(``repro.launch.dryrun``, ``repro.launch.hlo_analysis``).

The cost model:

  * per-device flops of a ``(256, 128, 1024) @ (1024, 4096)`` product and
    its weight gradient on a fake 16x16 mesh, inputs ``[Shard(0),
    Replicate()]``, weights ``[Replicate(), Shard(1)]`` and the output's
    gradient laid out as the output, equal the local shards' flops and the
    global count (``FlopCounterMode``) over 256;
  * ten chained products count ten times one (the counterpart of
    ``test_analyze_hlo_multiplies_trip_counts``), a rematerialized loop
    counts its recompute (``test_analyze_hlo_remat_grad_counts_recompute``),
    and on reduced qwen3-0.6b one more layer adds the same flops each time,
    and remat adds each layer's forward up to its last saved tensor (torch's
    checkpoint stops its recompute there: all but the MLP's last product);
  * each collective DTensor issues (all-gather, all-reduce, reduce-scatter;
    the CPU process groups have no all-to-all, so its formula alone) has
    the wire bytes the reference's ``parse_collectives`` gives an HLO line
    of the same result bytes and group;
  * ``Roofline``'s terms are its flops, bytes and wire over the H100
    datasheet constants, and ``model_flops_for`` is the reference's.

The dry run, for every reduced ``DenseLM`` config (the dense family and
the VLM) at train, prefill and decode on a 2x4 mesh: the record's keys are
the reference's, its argument bytes are those of the reference's shard
shapes (``NamedSharding.shard_shape`` over an ``AbstractMesh``) of
parameters, optimizer state, inputs and (decode) cache, and its
``model_flops`` is the reference's ``model_flops_for(active_params)``. A
config of another family fails with ``NotImplementedError``.

What needs a fake world runs in subprocesses (this file run as a script),
one world of 8 ranks and one of 256, side by side.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P
from torch.utils.checkpoint import checkpoint

import repro.launch.hlo_analysis as H
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.dist.sharding import make_rules as jax_make_rules
from repro.models.model import build_model as jax_build_model
from repro.models.module import _flatten as jax_flatten
from repro_torch.configs import get_arch
from repro_torch.launch import cost_analysis as C

DENSE = ("granite-3-2b", "h2o-danube-1.8b", "internvl2-26b", "phi3-medium-14b",
         "qwen3-0.6b")
SHAPES_RUN = ("train_4k", "prefill_32k", "decode_32k")
MESH = ((2, 4), ("data", "model"))
# the reduced qwen3 cells that count layers and remat: a short sequence
SMALL = dict(seq_len=64, global_batch=8)
REFERENCE = os.path.join(os.path.dirname(__file__), "..", "src", "repro",
                         "launch", "dryrun.py")


def _cells(out: str) -> None:
    """World of 8: every reduced dense cell's record, the layer and remat
    counts, the collectives' rows and another family's failure."""
    from torch.distributed.tensor import (
        DTensor,
        Partial,
        Replicate,
        Shard,
        distribute_tensor,
    )

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dev_mesh, start_fake_world

    start_fake_world(8)
    mesh = make_dev_mesh(2, 4)
    res = {"records": {}, "counts": {}}
    for arch in DENSE:
        for shape in SHAPES_RUN:
            res["records"][f"{arch}|{shape}"] = dryrun.run_cell(
                get_arch(arch).reduced(), shape, multi_pod=False, mesh=mesh,
                out_dir=None, verbose=False)
    base = get_arch("qwen3-0.6b").reduced()
    for kind in ("train", "prefill"):
        shape = ShapeConfig(f"small_{kind}", kind=kind, **SMALL)
        for nl in (1, 2, 4):
            for remat in (False, True):
                cfg = dataclasses.replace(base, n_layers=nl, remat=remat)
                res["counts"][f"{kind}|{nl}|{remat}"] = dryrun.run_cell(
                    cfg, shape, multi_pod=False, mesh=mesh, out_dir=None,
                    verbose=False, sequence_parallel=False)["flops_per_device"]
    try:
        dryrun.run_cell(get_arch("rwkv6-7b").reduced(), "train_4k",
                        multi_pod=False, mesh=mesh, out_dir=None)
        res["other_family"] = None
    except NotImplementedError as e:
        res["other_family"] = str(e)

    x = distribute_tensor(torch.zeros(16, 8), mesh, [Shard(0), Shard(1)])
    p = DTensor.from_local(torch.zeros(8, 8), mesh, [Shard(0), Partial()],
                           run_check=False)
    cm = C.OpCostModel()
    with cm:
        x.redistribute(mesh, [Shard(0), Replicate()])                  # all-gather
        p.redistribute(mesh, [Shard(0), Replicate()])                  # all-reduce
        p.redistribute(mesh, [Shard(0), Shard(1)])                     # reduce-scatter
    res["collectives"] = [{k: r[k] for k in ("kind", "payload", "wire", "group")}
                          for r in cm.rows if r["kind"]]
    res["collective_stats"] = dataclasses.asdict(cm.collectives())
    with open(out, "w") as f:
        json.dump(res, f)


def _matmul(out: str) -> None:
    """World of 256: the 16x16 product's per-device and global flops."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import make_production_mesh, start_fake_world

    start_fake_world(256)
    mesh = make_production_mesh()
    with FakeTensorMode():
        x = DTensor.from_local(torch.zeros(16, 128, 1024), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.zeros(1024, 256), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        # the output's gradient laid out as the output is
        gy = DTensor.from_local(torch.zeros(16, 128, 256), mesh,
                                [Shard(0), Shard(2)], run_check=False)
        xl, wl = torch.zeros(16, 128, 1024), torch.zeros(1024, 256)
    w.requires_grad_(True)
    cm = C.OpCostModel()
    with cm:
        (x @ w).backward(gy)
    w.grad = None
    with FlopCounterMode(display=False) as fc:
        (x @ w).backward(gy)
    wl.requires_grad_(True)
    with FlopCounterMode(display=False) as local:
        (xl @ wl).backward(gy.to_local())
    with open(out, "w") as f:
        json.dump({"per_device": cm.entry_cost().flops,
                   "global": fc.get_total_flops(),
                   "local": local.get_total_flops()}, f)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]))
    runs = {kind: subprocess.Popen([sys.executable, __file__, kind, str(d / kind)],
                                   env=env) for kind in ("cells", "matmul")}
    for kind, proc in runs.items():
        assert proc.wait(timeout=600) == 0, kind
    out = {}
    for kind in runs:
        with open(d / kind) as f:
            out[kind] = json.load(f)
    return out


# -- the cost model -------------------------------------------------------------

def test_per_device_flops_on_16x16_equal_local_shards(port):
    m = port["matmul"]
    assert m["global"] == 2 * 2 * 256 * 128 * 1024 * 4096      # forward + dW
    assert m["per_device"] == m["local"] == m["global"] / 256


def test_chained_products_count_each_time():
    x = torch.randn(128, 128)
    cm = C.OpCostModel()
    with cm:
        for _ in range(10):
            x = x @ x
    assert cm.entry_cost().flops == 10 * 2 * 128 ** 3
    assert cm.entry_cost().unresolved_whiles == 0


def test_remat_grad_counts_recompute():
    x = torch.randn(64, 64, requires_grad=True)
    cm = C.OpCostModel()
    with cm:
        c = x
        for _ in range(5):
            c = checkpoint(lambda z: torch.tanh(z @ z), c, use_reentrant=False)
        torch.autograd.grad(c.sum(), x)
    # forward + remat recompute + 2 backward products = 4x forward
    assert cm.entry_cost().flops == 4 * 5 * 2 * 64 ** 3


def test_layers_and_remat_count_on_the_model(port):
    n = port["cells"]["counts"]
    for kind in ("train", "prefill"):
        one = n[f"{kind}|2|False"] - n[f"{kind}|1|False"]
        assert one > 0
        assert n[f"{kind}|4|False"] - n[f"{kind}|1|False"] == 3 * one
    # torch's checkpoint recomputes a layer only up to its last saved tensor:
    # every product of the forward but the MLP's last (w_down)
    cfg = get_arch("qwen3-0.6b").reduced()
    tokens = SMALL["seq_len"] * SMALL["global_batch"] // MESH[0][0]
    w_down = 2 * tokens * (cfg.d_ff // MESH[0][1]) * cfg.d_model
    layer_fwd = n["prefill|2|False"] - n["prefill|1|False"]
    for nl in (1, 2, 4):
        assert n[f"train|{nl}|True"] - n[f"train|{nl}|False"] == nl * (
            layer_fwd - w_down)
        # prefill runs under no_grad: remat changes nothing
        assert n[f"prefill|{nl}|True"] == n[f"prefill|{nl}|False"]


def test_collective_wire_bytes_match_reference_formula(port):
    kinds = {r["kind"] for r in port["cells"]["collectives"]}
    # the CPU process groups have no all-to-all: DTensor all-gathers instead
    assert kinds == {"all-gather", "all-reduce", "reduce-scatter"}
    stats = port["cells"]["collective_stats"]
    for kind in kinds:
        mine = [r for r in port["cells"]["collectives"] if r["kind"] == kind]
        assert stats["counts"][kind] == len(mine)
        assert stats["wire_bytes"][kind] == sum(r["wire"] for r in mine)
        assert stats["payload_bytes"][kind] == sum(r["payload"] for r in mine)
    rows = port["cells"]["collectives"] + [
        {"kind": "all-to-all", "payload": 4096.0, "group": 4,
         "wire": C.ring_wire("all-to-all", 4096, 4)}]
    for r in rows:
        n, g = int(r["payload"]), int(r["group"])
        line = (f"%c = u8[{n}]{{0}} {r['kind']}(u8[{n}]{{0}} %p), "
                f"replica_groups=[{8 // g},{g}]<=[8]")
        want = H.parse_collectives(line, default_group=1)
        assert want.counts[r["kind"]] == 1
        assert r["wire"] == pytest.approx(want.wire_bytes[r["kind"]], rel=1e-12)
        assert C.ring_wire(r["kind"], n, g) == r["wire"]


def test_roofline_terms_and_model_flops():
    rf = C.Roofline(arch="a", shape="s", mesh="m", n_devices=4,
                    flops_per_device=2e12, bytes_per_device=6e11,
                    collective_wire_bytes=3e9, peak_memory_bytes=1.0,
                    model_flops=4e12)
    assert (C.PEAK_FLOPS, C.HBM_BW, C.LINK_BW) == (989e12, 3.35e12, 50e9)
    d = rf.to_dict()
    ref = H.Roofline(**{f.name: getattr(rf, f.name)
                        for f in dataclasses.fields(rf)}).to_dict()
    assert list(d) == list(ref)
    assert d["compute_s"] == 2e12 / 989e12 and d["memory_s"] == 6e11 / 3.35e12
    assert d["collective_s"] == 3e9 / 50e9
    assert d["bottleneck"] == "memory"
    assert d["useful_flops_fraction"] == ref["useful_flops_fraction"] == 0.5
    assert d["roofline_fraction"] == 4e12 / 4 / 989e12 / d["memory_s"]
    for arch in DENSE:
        for shape in SHAPES_RUN:
            args = (jax_get_arch(arch), JAX_SHAPES[shape], 1.5e9, 2e9)
            assert C.model_flops_for(*args) == H.model_flops_for(*args)


# -- the dry run -------------------------------------------------------------------

def _reference_record_keys() -> list:
    """The keys of the reference's record: ``Roofline.to_dict`` and those
    ``run_cell`` adds (read from its source: importing it sets the
    process's device count)."""
    rf = H.Roofline("a", "s", "m", 1, 1.0, 1.0, 1.0, None, 1.0).to_dict()
    tree = ast.parse(open(REFERENCE).read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    update = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                  and getattr(n.func, "attr", None) == "update")
    return list(rf) + [k.value for k in update.args[0].keys]


def _shard_bytes(mesh, rules, specs, dtype_bytes=None) -> int:
    total = 0
    for _, s in jax_flatten(specs):
        shape = NamedSharding(mesh, rules.spec_for_shape(s.axes, s.shape)
                              ).shard_shape(s.shape)
        total += int(np.prod(shape)) * (dtype_bytes or np.dtype(s.dtype).itemsize)
    return total


def _reference_argument_bytes(arch: str, shape_name: str) -> int:
    """Parameters (bf16), AdamW's moments (f32) and step, and the inputs or
    the decode cache, at the reference's shard shapes on the 2x4 mesh, with
    its ``build_cell``'s rules."""
    cfg = jax_get_arch(arch).reduced()
    shape = JAX_SHAPES[shape_name]
    mesh = AbstractMesh(*MESH)
    sp = cfg.sequence_parallel or shape.kind == "prefill"
    rules = jax_make_rules(mesh, fsdp=cfg.fsdp, sequence_parallel=sp)
    model = jax_build_model(cfg)
    specs = model.param_specs()
    total = _shard_bytes(mesh, rules, specs, dtype_bytes=2)
    divisible = shape.global_batch % mesh.shape["data"] == 0
    bspec = rules.spec_for(("batch", None)) if divisible else P()
    if shape.kind == "train":
        assert cfg.optimizer == "adamw"
        total += 2 * _shard_bytes(mesh, rules, specs, dtype_bytes=4) + 4
    if shape.kind in ("train", "prefill"):
        for leaf in jax_flatten(model.input_specs(shape)):
            a = leaf[1]
            spec = P(*(tuple(bspec) + (None,) * (len(a.shape) - len(bspec))))
            total += int(np.prod(NamedSharding(mesh, spec).shard_shape(a.shape))
                         ) * np.dtype(a.dtype).itemsize
        return total
    b = shape.global_batch
    if not divisible:
        rules.rules["batch"] = None
        rules.rules["seq"] = ("data",)
    if cfg.n_kv_heads % mesh.shape["model"] != 0:
        rules.rules["seq"] = "model"
    total += _shard_bytes(mesh, rules, model.cache_specs(b, shape.seq_len))
    tok = NamedSharding(mesh, bspec).shard_shape((b, 1))
    return total + int(np.prod(tok)) * 4


@pytest.mark.parametrize("shape", SHAPES_RUN)
@pytest.mark.parametrize("arch", DENSE)
def test_dry_run_cell_matches_reference(port, arch, shape):
    import repro.launch.hlo_analysis as jh
    rec = port["cells"]["records"][f"{arch}|{shape}"]
    assert list(rec) == _reference_record_keys()
    assert rec["memory"]["argument_size_in_bytes"] == _reference_argument_bytes(
        arch, shape)
    assert rec["mesh"] == "2x4" and rec["n_devices"] == 8
    jcfg = jax_get_arch(arch).reduced()
    n_active = float(sum(np.prod(s.shape) for _, s in jax_flatten(
        jax_build_model(jcfg).param_specs())))
    assert rec["n_params_active"] == rec["n_params_total"] == n_active
    assert rec["model_flops"] == jh.model_flops_for(
        jcfg, JAX_SHAPES[shape], n_active, n_active)
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert rec["unresolved_whiles"] == 0


def test_other_family_fails_clearly(port):
    msg = port["cells"]["other_family"]
    assert msg is not None and "'rwkv' family does not run on DTensors" in msg


if __name__ == "__main__":
    {"cells": _cells, "matmul": _matmul}[sys.argv[1]](sys.argv[2])
