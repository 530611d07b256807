"""AdamW's one-operator leaf update (``repro_torch.kernels.adamw``) on the
CPU: its plain version and ``adamw_update`` through it bit for bit equal to
the update as the port wrote it before, a loop of torch ops a leaf
(:func:`adamw_before`, kept here as the reference), over three steps of f32
and bf16 trees from step 0 and from a later step; new tensors out; the
wrapper's checks; no launch on the CPU; the profiler's record of the
operator (what ``perfbench/metrics/update_roofline.py`` reads); and a
DTensor tree on a one-rank (1, 1) gloo mesh against the plain tree (in a
subprocess: a process group is process-wide). The CUDA kernel itself is
held to the plain version on the card, at every leaf shape of the
benchmark's configurations (``chip_smoke.py``)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import adamw as A
from repro_torch.models.module import _flatten, _unflatten
from repro_torch.training.optimizer import adamw_init, adamw_update

LR = 3e-4
HYPER = dict(lr=LR, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
SHAPES = {"embed": (13, 8), "blocks/w": (2, 5, 7), "blocks/norm": (7,),
          "head": (8, 13), "one": (1,)}


@torch.no_grad()
def adamw_before(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    """``adamw_update`` as the port wrote it before the kernel."""
    step = state["step"] + 1
    t = step.float()
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    g_flat, m_flat, v_flat = dict(_flatten(grads)), dict(_flatten(state["m"])), \
        dict(_flatten(state["v"]))
    new_p, new_m, new_v = {}, {}, {}
    for path, p in _flatten(params):
        g = g_flat[path].float()
        m = b1 * m_flat[path] + (1 - b1) * g
        v = b2 * v_flat[path] + (1 - b2) * g * g
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        new_p[path] = (p.float() - lr * delta).to(p.dtype)
        new_m[path], new_v[path] = m, v
    return _unflatten(new_p), {"m": _unflatten(new_m), "v": _unflatten(new_v),
                               "step": step}


def same_bits(a, b) -> bool:
    ints = {4: torch.int32, 2: torch.int16}
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(ints[a.element_size()]),
                            b.view(ints[b.element_size()])))


def trees_equal(a, b) -> bool:
    fa, fb = dict(_flatten(a)), dict(_flatten(b))
    return fa.keys() == fb.keys() and all(same_bits(fa[k], fb[k]) for k in fa)


def make_tree(gen, dtype, scale=1.0):
    """A parameter-shaped tree; every fifth element of a gradient is 0."""
    out = {}
    for path, shape in SHAPES.items():
        x = torch.randn(shape, generator=gen) * scale
        if scale < 1:
            x.view(-1)[::5] = 0.0
        out[path] = x.to(dtype)
    return _unflatten(out)


def start_state(gen, params, start: int):
    """Zero moments at step 0; at a later step, moments of the size three
    steps' gradients leave."""
    state = adamw_init(params)
    if start:
        state["m"] = _unflatten({k: torch.randn(v.shape, generator=gen) * 1e-3
                                 for k, v in _flatten(state["m"])})
        state["v"] = _unflatten({k: torch.rand(v.shape, generator=gen) * 1e-6
                                 for k, v in _flatten(state["v"])})
        state["step"] = torch.tensor(start, dtype=torch.int32)
    return state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("start", [0, 997])
def test_update_equals_the_loop_it_replaced(dtype, start):
    gen = torch.Generator().manual_seed(start + 7)
    params = make_tree(gen, dtype, 0.02)
    state = start_state(gen, params, start)
    ref_p, ref_s = params, state
    for _ in range(3):
        grads = make_tree(gen, dtype, 1e-3)
        ref_p, ref_s = adamw_before(grads, ref_s, ref_p, lr=LR)
        new_p, new_s = adamw_update(grads, state, params, lr=LR)
        # the plain version leaf by leaf, from the same state
        step = state["step"] + 1
        bc1, bc2 = (1.0 - b ** step.float() for b in (0.9, 0.95))
        g, m, v = (dict(_flatten(t)) for t in (grads, state["m"], state["v"]))
        leaf = {k: A.adamw_leaf_plain(p, g[k], m[k], v[k], bc1, bc2, **HYPER)
                for k, p in _flatten(params)}
        assert trees_equal(new_p, ref_p) and trees_equal(new_s, ref_s)
        assert trees_equal(_unflatten({k: o[0] for k, o in leaf.items()}), ref_p)
        assert trees_equal(_unflatten({k: o[1] for k, o in leaf.items()}), ref_s["m"])
        assert trees_equal(_unflatten({k: o[2] for k, o in leaf.items()}), ref_s["v"])
        params, state = new_p, new_s
    assert int(state["step"]) == start + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_update_returns_new_tensors(dtype):
    gen = torch.Generator().manual_seed(3)
    params = make_tree(gen, dtype, 0.02)
    grads = make_tree(gen, dtype, 1e-3)
    state = start_state(gen, params, 5)
    ins = [t for tree in (params, grads, state) for _, t in _flatten(tree)]
    before = [t.clone() for t in ins]
    new_p, new_s = adamw_update(grads, state, params, lr=LR)
    taken = {t.untyped_storage().data_ptr() for t in ins}
    assert all(t.untyped_storage().data_ptr() not in taken
               for tree in (new_p, new_s) for _, t in _flatten(tree))
    assert all(same_bits(a, b) for a, b in zip(ins, before))


def leaf_inputs(shape=(4, 6), dtype=torch.float32):
    p = torch.randn(shape).to(dtype)
    return [p, torch.randn(shape).to(dtype), torch.zeros(shape), torch.zeros(shape),
            torch.tensor(0.1), torch.tensor(0.05)]


# each case: which input (p, g, m, v, bc1, bc2) it replaces, by what, and
# the error
BAD_INPUTS = {
    "g shape": (1, lambda t: torch.zeros(4, 5), ValueError),
    "m shape": (2, lambda t: torch.zeros(24), ValueError),
    "p f16": (0, lambda t: t.half(), TypeError),
    "g f64": (1, lambda t: t.double(), TypeError),
    "m bf16": (2, lambda t: t.bfloat16(), TypeError),
    "bc1 f64": (4, lambda t: t.double(), TypeError),
    "bc2 not 0-d": (5, lambda t: t.reshape(1), ValueError),
    "p not contiguous": (0, lambda t: torch.zeros(6, 4).t(), ValueError),
    "v not contiguous": (3, lambda t: torch.zeros(4, 12)[:, ::2], ValueError),
    "g on meta": (1, lambda t: torch.empty(4, 6, device="meta"), ValueError),
}


@pytest.mark.parametrize("case", BAD_INPUTS)
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    ins = leaf_inputs()
    which, bad, error = BAD_INPUTS[case]
    ins[which] = bad(ins[which])
    with pytest.raises(error):
        A.adamw_leaf(*ins, **HYPER)


def test_cpu_leaves_launch_nothing():
    gen = torch.Generator().manual_seed(1)
    params = make_tree(gen, torch.float32, 0.02)
    A.reset_launches()
    adamw_update(make_tree(gen, torch.float32, 1e-3), adamw_init(params), params,
                 lr=LR)
    assert A.LAUNCHES == {"adamw_leaf": 0}


@pytest.mark.parametrize("dtype,name", [(torch.float32, "float"),
                                        (torch.bfloat16, "c10::BFloat16")])
def test_profiler_records_each_leaf_with_its_shapes(dtype, name):
    """One ``repro_torch::adamw_leaf`` a leaf, p, g, m, v first with their
    shapes and dtypes: what the update's roofline counts its bytes from."""
    gen = torch.Generator().manual_seed(2)
    params = make_tree(gen, dtype, 0.02)
    grads = make_tree(gen, dtype, 1e-3)
    state = adamw_init(params)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        adamw_update(grads, state, params, lr=LR)
    # the kineto records the benchmark's trace summary reads
    calls = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "repro_torch::adamw_leaf"]
    assert sorted(tuple(e.shapes()[0]) for e in calls) == sorted(SHAPES.values())
    for e in calls:
        assert all(s == e.shapes()[0] for s in e.shapes()[1:4])
        assert [list(s) for s in e.shapes()[4:6]] == [[], []]
        assert list(e.dtypes()[:6]) == [name, name] + ["float"] * 4


# -- a DTensor tree on a one-rank (1, 1) mesh ---------------------------------

PLACEMENTS = {"embed": ("S0", "R"), "blocks/w": ("R", "S1"),
              "blocks/norm": ("R", "R"), "head": ("S1", "S0"), "one": ("S0", "S0")}


def _mesh_side(out: str) -> None:
    """Three steps of a tree as DTensors on a (1, 1) gloo mesh and as plain
    tensors, f32 and bf16, both sides' leaves to ``out``."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import mesh_of

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    mesh = mesh_of((1, 1), ("data", "model"))

    def place(code):
        return Shard(int(code[1])) if code[0] == "S" else Replicate()

    def on_mesh(tree):
        return _unflatten({k: distribute_tensor(v, mesh, [place(c) for c in PLACEMENTS[k]])
                           for k, v in _flatten(tree)})

    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator().manual_seed(11)
        params = make_tree(gen, dtype, 0.02)
        state = start_state(gen, params, 41)
        plain = (params, state)
        mesh_p = on_mesh(params)
        mesh_s = {"m": on_mesh(state["m"]), "v": on_mesh(state["v"]),
                  "step": distribute_tensor(state["step"], mesh, [Replicate()] * 2)}
        for _ in range(3):
            grads = make_tree(gen, dtype, 1e-3)
            plain = adamw_update(grads, plain[1], plain[0], lr=LR)
            mesh_p, mesh_s = adamw_update(on_mesh(grads), mesh_s, mesh_p, lr=LR)
        for tree in (mesh_p, mesh_s["m"], mesh_s["v"]):
            for k, v in _flatten(tree):
                assert list(v.placements) == [place(c) for c in PLACEMENTS[k]], k
        for side, tree in (("plain", {"p": plain[0], "s": plain[1]}),
                           ("mesh", {"p": mesh_p, "s": mesh_s})):
            for k, v in _flatten(tree):
                if isinstance(v, DTensor):
                    v = v.full_tensor()
                results[f"{dtype}/{side}/{k}"] = v.view(
                    torch.int16 if v.element_size() == 2 else torch.int32).numpy()
    np.savez(out, **results)
    dist.destroy_process_group()


def test_dtensor_tree_on_a_one_rank_mesh_equals_the_plain_tree(tmp_path):
    out = str(tmp_path / "mesh.npz")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, __file__, out], check=True, env=env,
                   timeout=300)
    got = dict(np.load(out))
    mesh_keys = [k for k in got if "/mesh/" in k]
    assert len(mesh_keys) == 2 * (3 * len(SHAPES) + 1)
    for k in mesh_keys:
        np.testing.assert_array_equal(got[k], got[k.replace("/mesh/", "/plain/")],
                                      err_msg=k)


if __name__ == "__main__":
    _mesh_side(sys.argv[1])
