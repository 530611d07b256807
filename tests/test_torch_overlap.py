"""The port's gradient bucketing (``repro_torch.dist.overlap``) held against
the JAX package's ``repro.dist.overlap``.

The planners are pure Python and must give the reference's plans exactly.
The leaves are bucketed in ``jax.tree.flatten``'s order (``tree_leaves``),
so the trees here are built with their keys out of sorted order.
``bucketed_ring_reduce`` (the fused int8 ring per bucket) and
``bucketed_psum`` run against the reference under
``jax.shard_map(..., check_vma=False)`` on w host devices, in one
subprocess (this file run as a script) that writes ``.npz``.

Tolerances, with the gaps measured on these inputs:
  * ``bucketed_psum``: rtol 1e-6 (the port sums in rank order, the
    reference's XLA all-reduce in an order of its own). Measured:
    identical.
  * ``bucketed_ring_reduce``: at most w-1 int8 steps of each element's
    final block scale, computed over the bucket's concatenated payload, as
    ``tests/test_torch_ring.py`` holds the fused ring. Measured: no whole
    step; gaps of at most 4.8e-7.
  * ``bucketed_ring_reduce`` of reduced qwen3-0.6b's gradients: the same,
    and each leaf's error against the exact sum equal to the reference's
    within 1e-6 of the leaf's largest sum. Measured: at most 3e-8 apart
    elementwise, so the per-leaf errors agree to 4 digits.
"""

import os
import subprocess
import sys

import functools

import jax
import numpy as np
import pytest
import torch

from repro.dist import overlap as jax_overlap
from repro_torch.configs import get_arch
from repro_torch.core.rar_model import wire_formula
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.dist import overlap
from repro_torch.dist.collectives import LocalRing
from repro_torch.dist.compression import _fused_chunk_layout
from repro_torch.models.model import build_model
from repro_torch.training.train_step import rank_grads, shard_batch

WS = (2, 3, 4)
BUCKETS = (2, 4)
MODEL_W, MODEL_BUCKETS = 4, 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# leaf shapes, keys deliberately out of sorted order
SHAPES = {"z": (13,), "blocks": {"w2": (517,), "w1": (41, 9), "b": (3, 7)},
          "a": (64,), "a-c": (5,)}


def _tree_of(fn, spec=SHAPES):
    return {k: _tree_of(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in spec.items()}


def _inputs():
    rng = np.random.default_rng(31)
    out = {}
    for w in WS:
        for path, shape in overlap.tree_leaves(SHAPES):
            out[f"w{w}|{path}"] = rng.standard_normal((w,) + shape).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _model_grads():
    """Reduced qwen3-0.6b's per-rank gradients at w=4 on the first batch:
    ``{path: (4, *shape)}``, leaves of very different magnitudes."""
    cfg = get_arch("qwen3-0.6b").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)
    devices = [torch.device("cpu")] * MODEL_W
    batch = {k: torch.as_tensor(v) for k, v in
             SyntheticTokens(cfg.vocab, 16, 8, seed=0).batch(0).items()}
    _, grads = rank_grads(model, {devices[0]: params},
                          shard_batch(batch, devices), devices)
    return {p: np.stack([g[p].numpy() for g in grads]) for p in grads[0]}


def _rank_trees(w):
    inp = _inputs()
    return [_tree_of_paths({p: torch.from_numpy(inp[f"w{w}|{p}"][r].copy())
                            for p, _ in overlap.tree_leaves(SHAPES)})
            for r in range(w)]


def _tree_of_paths(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("overlap_ref")
    np.savez(tmp / "in.npz", **_inputs(),
             **{f"model|{p}": g for p, g in _model_grads().items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(tmp / "in.npz"),
         str(tmp / "out.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / "out.npz") as f:
        return dict(f)


@pytest.mark.parametrize("seed", range(6))
def test_planners_match_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 30))
    sizes = [int(s) for s in rng.integers(1, 10_000, size=n)]
    if seed == 5:
        sizes = [1] * 7 + [151936 * 1024] + [3072 * 1024] * 3
    for n_buckets in range(-1, 12):
        for reverse in (False, True):
            assert overlap.plan_buckets(sizes, n_buckets, reverse=reverse) == \
                jax_overlap.plan_buckets(sizes, n_buckets, reverse=reverse)
            assert overlap.plan_bucket_sizes(sizes, n_buckets, reverse=reverse) \
                == jax_overlap.plan_bucket_sizes(sizes, n_buckets, reverse=reverse)
    for d in [0, 1, 2, 7, *sizes[:5]]:
        for k in range(-1, 9):
            assert overlap.even_bucket_sizes(d, k) == \
                jax_overlap.even_bucket_sizes(d, k)


def test_tree_leaves_in_jax_flatten_order():
    tree = _tree_of(lambda s: s)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))
    want = ["/".join(k.key for k in path) for path, _ in flat]
    assert [p for p, _ in overlap.tree_leaves(tree)] == want
    assert want[:3] == ["a", "a-c", "blocks/b"]     # sorted per level


def _bucket_tolerance(want_flat, sizes, n_buckets, w):
    """Per-leaf tolerance of the bucketed fused ring: w-1 int8 steps of the
    final block scale of each element's block in its bucket's payload."""
    tol = [None] * len(sizes)
    for bucket in overlap.plan_buckets(sizes, n_buckets, reverse=True):
        payload = np.concatenate([want_flat[i].reshape(-1) for i in bucket])
        c_pad, nb, pad = _fused_chunk_layout(payload.size, w, 4096)
        blocks = np.pad(payload, (0, pad)).reshape(w * nb, -1)
        step = np.abs(blocks).max(axis=1, keepdims=True) / 127.0
        t = np.broadcast_to((w - 1) * step * (1 + 1e-6), blocks.shape)
        t = t.reshape(-1)[:payload.size]
        off = 0
        for i in bucket:
            tol[i] = t[off: off + sizes[i]].reshape(want_flat[i].shape)
            off += sizes[i]
    return tol


@pytest.mark.parametrize("n_buckets", BUCKETS)
@pytest.mark.parametrize("w", WS)
def test_bucketed_ring_reduce_matches_reference(jax_out, w, n_buckets):
    ring = LocalRing(["cpu"] * w)
    out = overlap.bucketed_ring_reduce(_rank_trees(w), ring, variant="int8-fused",
                                       n_buckets=n_buckets)
    paths = [p for p, _ in overlap.tree_leaves(SHAPES)]
    assert all(list(o) == paths for o in out)
    want = [jax_out[f"ring_w{w}_b{n_buckets}|{p}"] for p in paths]
    sizes = [int(np.prod(wt.shape[1:])) for wt in want]
    tol = _bucket_tolerance([wt[0] for wt in want], sizes, n_buckets, w)
    for i, p in enumerate(paths):
        got = np.stack([o[p].numpy() for o in out])
        assert (got == got[0]).all() and (want[i] == want[i][0]).all()
        assert (np.abs(got[0] - want[i][0]) <= tol[i]).all(), p
    # one fused ring per bucket, priced as the overlap mode prices it
    f = wire_formula("int8-fused")
    bucket_sizes = overlap.plan_bucket_sizes(sizes, n_buckets)
    assert ring.messages == [len(bucket_sizes) * f.messages(w)] * w
    assert ring.bytes == [sum(f.bytes_per_worker(b, w) for b in bucket_sizes)] * w


def test_bucketed_ring_reduce_on_model_grads_matches_reference(jax_out):
    """The overlap mode's reduction of a real model's gradients. A bucket
    concatenates leaves, so one quantization block can hold the end of one
    leaf and the start of the next: a leaf of small gradients beside one of
    large gradients takes the larger leaf's block scale, and its own error
    is large against its own largest sum (``blocks/ln2``, between
    ``blocks/q_norm`` and ``blocks/ln1``: 0.083 here).
    The port must give the reference's per-leaf errors, neither smaller nor
    larger."""
    flat = _model_grads()
    w = MODEL_W
    ring = LocalRing(["cpu"] * w)
    out = overlap.bucketed_ring_reduce(
        [_tree_of_paths({p: torch.from_numpy(g[r].copy()) for p, g in flat.items()})
         for r in range(w)], ring, variant="int8-fused", n_buckets=MODEL_BUCKETS)
    paths = [p for p, _ in overlap.tree_leaves(out[0])]
    want = [jax_out[f"model_ring|{p}"][0] for p in paths]
    sizes = [x.size for x in want]
    tol = _bucket_tolerance(want, sizes, MODEL_BUCKETS, w)
    for i, p in enumerate(paths):
        got = out[0][p].numpy()
        assert all(torch.equal(o[p], out[0][p]) for o in out[1:]), p
        assert (np.abs(got - want[i]) <= tol[i]).all(), p
        exact = flat[p].sum(axis=0)
        peak = np.abs(exact).max()
        rel_port = np.abs(got - exact).max() / peak
        rel_ref = np.abs(want[i] - exact).max() / peak
        assert abs(rel_port - rel_ref) <= 1e-6, (p, rel_port, rel_ref)


@pytest.mark.parametrize("n_buckets", BUCKETS)
@pytest.mark.parametrize("w", WS)
def test_bucketed_psum_matches_reference(jax_out, w, n_buckets):
    ring = LocalRing(["cpu"] * w)
    out = overlap.bucketed_psum(_rank_trees(w), ring, n_buckets=n_buckets)
    for p, _ in overlap.tree_leaves(SHAPES):
        got = np.stack([o[p].numpy() for o in out])
        np.testing.assert_allclose(got, jax_out[f"psum_w{w}_b{n_buckets}|{p}"],
                                   rtol=1e-6)
    sizes = [int(np.prod(s)) for _, s in overlap.tree_leaves(SHAPES)]
    assert ring.psums == [len(overlap.plan_buckets(sizes, n_buckets))] * w
    assert ring.messages == [0] * w


def test_bucketed_reduce_edge_cases():
    ring = LocalRing(["cpu"] * 2)
    assert overlap.bucketed_psum([{}, {}], ring) == [{}, {}]
    x = [{"b": torch.ones(3), "a": torch.arange(3.0)}] * 2
    out = overlap.bucketed_psum(x, ring, n_buckets=99)   # clamps to 2 leaves
    assert ring.psums == [2, 2]
    assert torch.equal(out[1]["a"], torch.tensor([0.0, 2.0, 4.0]))
    with pytest.raises(KeyError):
        overlap.bucketed_ring_reduce(x, ring, variant="int4")
    with pytest.raises(TypeError):
        overlap.bucketed_ring_reduce(x, ring, variant=3)


def _jax_reference(inp, out):
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    def run(fn, tree, w):
        """``fn`` over the w ranks' trees (leading axis w): ``{path: (w, ...)}``."""
        mesh = Mesh(np.array(jax.devices()[:w]), ("d",))
        spec = jax.tree.map(lambda _: P("d"), tree)
        f = jax.jit(jax.shard_map(
            lambda g: jax.tree.map(lambda t: t[None],
                                   fn(jax.tree.map(lambda t: t[0], g))),
            mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False))
        return {"/".join(k.key for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(f(tree))[0]}

    data = dict(np.load(inp))
    res = {}
    for w in WS:
        tree = _tree_of_paths({p: jnp.asarray(data[f"w{w}|{p}"])
                               for p, _ in overlap.tree_leaves(SHAPES)})
        for nb in BUCKETS:
            fns = {
                "ring": lambda g, nb=nb: jax_overlap.bucketed_ring_reduce(
                    g, "d", variant="int8-fused", n_buckets=nb),
                "psum": lambda g, nb=nb: jax_overlap.bucketed_psum(
                    g, "d", n_buckets=nb),
            }
            for name, fn in fns.items():
                for key, v in run(fn, tree, w).items():
                    res[f"{name}_w{w}_b{nb}|{key}"] = v
    model = _tree_of_paths({k[len("model|"):]: jnp.asarray(v)
                            for k, v in data.items() if k.startswith("model|")})
    for key, v in run(lambda g: jax_overlap.bucketed_ring_reduce(
            g, "d", variant="int8-fused", n_buckets=MODEL_BUCKETS),
            model, MODEL_W).items():
        res[f"model_ring|{key}"] = v
    np.savez(out, **res)


if __name__ == "__main__":
    _jax_reference(sys.argv[1], sys.argv[2])
