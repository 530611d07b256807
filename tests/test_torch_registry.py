"""The port's ring registry (``repro_torch.dist.registry``) held against the
JAX package's ``repro.dist.registry``: names, order and wire annotations of
all 12 ring variants and all 8 step modes; each variant run on the same
inputs at w = 2, 3, 4; ``LocalRing``'s own counts against the variants'
priced messages and bytes; error feedback with a residual, fused and
unfused; and the error-feedback first-hop pin.

The JAX references run under ``jax.shard_map(..., check_vma=False)`` on w
host devices, in one subprocess (this file run as a script) that writes
``.npz``.

Tolerances, with the gaps measured on these inputs:
  * ``f32``, ``f32-reverse``, ``bidir``, ``reduce-scatter``,
    ``f32-bucketed`` and ``bf16-fused``: bit-identical (they keep the
    reference's hop order and rounding; measured: identical).
  * ``psum``: rtol 1e-6 (the port sums in rank order, the reference's XLA
    all-reduce in an order of its own). Measured: identical.
  * the int8 family (``int8``, ``int8-fused``, ``ef-int8``,
    ``ef-int8-fused``): at most w-1 int8 steps of the final scale (per
    block fused, per ring chunk unfused), as ``tests/test_torch_ring.py``
    holds the fused ring. Measured: no whole step; where a final scale is
    one ulp apart, gaps of at most 4.8e-7.
  * ``fp8-fused``: at most w-1 e4m3 steps at each element's magnitude, as
    in ``tests/test_torch_wires.py``. Measured: no whole step; gaps of at
    most 9.6e-7.
  * error feedback with a residual: the reduced sum as the int8 family;
    each rank's new residual within one int8 step of its own quantization
    scale. Measured: no whole step; gaps of at most 9.6e-7 in the sum and
    2.4e-7 in the residuals.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.dist import registry as jax_reg
from repro_torch.core.rar_model import wire_formula
from repro_torch.dist import registry as reg
from repro_torch.dist.collectives import LocalRing
from repro_torch.dist.compression import (
    _fused_chunk_layout,
    compressed_ring_all_reduce,
    ef_compressed_all_reduce,
)

WS = (2, 3, 4)
D = 513
EF_D, EF_BLOCK = 700, 128
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = [v.name for v in reg.RING_VARIANTS]
EXACT = {"f32", "f32-reverse", "bidir", "reduce-scatter", "f32-bucketed",
         "bf16-fused"}
INT8 = {"int8": False, "int8-fused": True, "ef-int8": False,
        "ef-int8-fused": True}          # name -> per-block (fused) scales


def _inputs():
    rng = np.random.default_rng(21)
    out = {}
    for w in WS:
        out[f"x_w{w}"] = rng.standard_normal((w, D)).astype(np.float32)
        out[f"g_w{w}"] = rng.standard_normal((w, EF_D)).astype(np.float32)
        out[f"r_w{w}"] = (rng.standard_normal((w, EF_D)) * 0.01).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("registry_ref")
    np.savez(tmp / "in.npz", **_inputs())
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


def _ranks(x):
    return [torch.from_numpy(x[r].copy()) for r in range(x.shape[0])]


def _annotations(v):
    return {f.name: getattr(v, f.name) for f in dataclasses.fields(v)
            if f.name != "build"}


def test_variants_match_reference_names_order_and_annotations():
    assert NAMES == [v.name for v in jax_reg.RING_VARIANTS]
    assert len(NAMES) == 12
    for v, jv in zip(reg.RING_VARIANTS, jax_reg.RING_VARIANTS):
        want = _annotations(jv)
        want["source"] = want["source"].replace("src/repro/", "src/repro_torch/")
        assert _annotations(v) == want
        assert os.path.exists(os.path.join(ROOT, v.source))
    assert reg.BUCKETED_VARIANT_SEGMENTS == jax_reg.BUCKETED_VARIANT_SEGMENTS
    with pytest.raises(KeyError):
        reg.variant_by_name("int4")


def test_step_modes_match_reference():
    assert list(reg.STEP_MODES) == list(jax_reg.STEP_MODES)
    assert len(reg.STEP_MODES) == 8
    assert reg.DEFAULT_OVERLAP_BUCKETS == jax_reg.DEFAULT_OVERLAP_BUCKETS
    for mode, spec in reg.STEP_MODES.items():
        jspec = jax_reg.STEP_MODES[mode]
        assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
        assert spec.leaf_variant().name == jspec.leaf_variant().name
        assert spec.wire_dtype == jspec.wire_dtype


@pytest.mark.parametrize("name", NAMES)
def test_priced_messages_and_bytes_match_reference(name):
    v, jv = reg.variant_by_name(name), jax_reg.variant_by_name(name)
    for w in range(1, 9):
        assert v.expected_messages(w) == jv.expected_messages(w)
        for d in (1, 2, 5, 513, 4096 * 3 + 7, 751632384):
            assert v.expected_messages(w, d) == jv.expected_messages(w, d)
            assert v.expected_bytes(d, w) == jv.expected_bytes(d, w)


def _steps_within(got, want, w, *, qmax, rows):
    """|got - want| within w-1 quantization steps of want's final scales:
    ``rows`` splits the flat output into its scale groups (max |group| is
    qmax * scale exactly: the amax element codes to +-qmax)."""
    d = want.size
    pad = (-d) % rows
    groups = np.pad(want, (0, pad)).reshape(rows, -1)
    step = np.abs(groups).max(axis=1, keepdims=True) / qmax
    tol = np.broadcast_to((w - 1) * step * (1 + 1e-6), groups.shape)
    return bool((np.abs(got - want) <= tol.reshape(-1)[:d]).all())


@pytest.mark.parametrize("w", WS)
@pytest.mark.parametrize("name", NAMES)
def test_variant_matches_reference(jax_out, name, w):
    v = reg.variant_by_name(name)
    x = _inputs()[f"x_w{w}"]
    ring = LocalRing(["cpu"] * w)
    got = np.stack([o.numpy() for o in v.build(ring)(_ranks(x))])
    want = jax_out[f"{name}_w{w}"]
    assert got.shape == want.shape
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
    elif name == "psum":
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        assert (got == got[0]).all() and (want == want[0]).all()
        if name in INT8:
            rows = (w * _fused_chunk_layout(D, w, 4096)[1] if INT8[name]
                    else w)
            assert _steps_within(got[0], want[0], w, qmax=127.0, rows=rows)
        else:   # fp8-fused
            c_pad, nb, pad = _fused_chunk_layout(D, w, 4096)
            blocks = np.pad(want[0], (0, pad)).reshape(w * nb, -1)
            scale = np.abs(blocks).max(axis=1, keepdims=True) / 448.0
            e = np.floor(np.log2(np.maximum(np.abs(blocks) / scale, 2.0 ** -6)))
            tol = (w - 1) * 2.0 ** (e - 3) * scale * (1 + 1e-6)
            assert (np.abs(got[0] - want[0]) <= tol.reshape(-1)[:D]).all()
    # LocalRing's own counts equal what the registry prices
    assert ring.messages == [v.expected_messages(w, D)] * w
    assert ring.bytes == [v.expected_bytes(D, w)] * w
    assert ring.psums == [1 if v.collective == "psum" else 0] * w
    assert len(ring.directions) == v.directions


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("w", WS)
def test_ef_with_residual_matches_reference(jax_out, w, fused):
    inp = _inputs()
    g, r = inp[f"g_w{w}"], inp[f"r_w{w}"]
    ring = LocalRing(["cpu"] * w)
    reduced, residual = ef_compressed_all_reduce(
        _ranks(g), _ranks(r), ring, fused=fused, block=EF_BLOCK)
    got = np.stack([o.numpy() for o in reduced])
    got_res = np.stack([o.numpy() for o in residual])
    tag = "fused" if fused else "xla"
    want, want_res = jax_out[f"ef_{tag}_w{w}"], jax_out[f"ef_{tag}_res_w{w}"]
    assert (got == got[0]).all()
    rows = w * _fused_chunk_layout(EF_D, w, EF_BLOCK)[1] if fused else w
    assert _steps_within(got[0], want[0], w, qmax=127.0, rows=rows)
    # each rank's residual: within one step of its own quantization scale
    corrected = g + r
    for k in range(w):
        if fused:
            c_pad, nb, pad = _fused_chunk_layout(EF_D, w, EF_BLOCK)
            blocks = np.pad(corrected[k], (0, pad)).reshape(w * nb, -1)
            step = np.abs(blocks).max(axis=1, keepdims=True) / 127.0
            tol = np.broadcast_to(step, blocks.shape).reshape(-1)[:EF_D]
        else:
            tol = np.abs(corrected[k]).max() / 127.0
        assert (np.abs(got_res[k] - want_res[k]) <= tol * (1 + 1e-6)).all()
    v = reg.variant_by_name("ef-int8-fused" if fused else "ef-int8")
    assert ring.messages == [v.expected_messages(w, EF_D)] * w
    if fused:
        assert ring.bytes == [wire_formula("int8-fused", block=EF_BLOCK)
                              .bytes_per_worker(EF_D, w)] * w
    else:
        assert ring.bytes == [v.expected_bytes(EF_D, w)] * w


@pytest.mark.parametrize("fused", [False, True])
def test_ef_one_rank_quantizes_once(fused):
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(300)
                         .astype(np.float32))
    ring = LocalRing(["cpu"])
    (out,), (res,) = ef_compressed_all_reduce([g], None, ring, fused=fused,
                                              block=EF_BLOCK)
    assert not torch.equal(out, g)                  # quantized, unlike the ring
    torch.testing.assert_close(out + res, g, rtol=0, atol=1e-6)
    assert ring.messages == [0]
    assert torch.equal(compressed_ring_all_reduce([g], ring, fused=fused)[0], g)


def test_ef_first_hop_bitexact_no_double_quantization():
    """The port's copy of the reference's pin
    (tests/test_dist.py::test_ef_first_hop_bitexact_no_double_quantization):
    the first Share-Reduce hop forwards error feedback's already-quantized
    payload verbatim. The inputs are integer multiples of a power-of-two
    scale (amax = 127 * 2^-3), so every operation on that path is exact in
    f32 and the result must equal a numpy model of the skip-requantization
    schedule bit for bit, while the schedule that re-quantizes on hop 0
    differs on the same inputs."""
    s0 = np.float32(0.125)
    rng = np.random.default_rng(0)
    n, c = 64, 32                            # a w=2 ring, chunks of 32
    k = rng.integers(-100, 101, size=(2, n)).astype(np.float32)
    k[:, 0] = 127.0                          # pin the amax in chunk 0
    g = (k * s0).astype(np.float32)

    def requantize(v):
        amax = np.float32(np.abs(v).max())
        scale = amax / np.float32(127.0) if amax > 0 else np.float32(1)
        return np.clip(np.round(v / scale), -127, 127).astype(np.float32) * scale

    def model(double_quantize):
        q = [np.round(gg / s0).astype(np.float32) for gg in g]
        final = np.zeros((2, c), np.float32)
        for i in (0, 1):
            peer = 1 - i
            sent = q[peer].reshape(2, c)[peer] * s0
            if double_quantize:
                sent = requantize(sent)
            final[peer] = requantize(g[i].reshape(2, c)[peer] + sent)
        return final.reshape(-1)

    want = model(double_quantize=False)
    assert np.abs(want - model(double_quantize=True)).max() > 0, \
        "the inputs must tell the two schedules apart"
    ring = LocalRing(["cpu"] * 2)
    out, _ = ef_compressed_all_reduce(_ranks(g), [torch.zeros(n)] * 2, ring)
    for o in out:
        np.testing.assert_array_equal(o.numpy(), want)


def _jax_reference(inp, out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.dist.compression import ef_compressed_all_reduce as jax_ef

    res = {}
    data = dict(np.load(inp))
    for w in WS:
        mesh = Mesh(np.array(jax.devices()[:w]), ("d",))
        for v in jax_reg.RING_VARIANTS:
            fn = v.build("d")
            f = jax.jit(jax.shard_map(
                lambda a, fn=fn: fn(a[0])[None], mesh=mesh,
                in_specs=P("d", None), out_specs=P("d", None),
                check_vma=False))
            res[f"{v.name}_w{w}"] = np.asarray(f(jnp.asarray(data[f"x_w{w}"])))
        for tag, fused in (("xla", False), ("fused", True)):
            def ef(a, r, fused=fused):
                red, new_r = jax_ef(a[0], r[0], "d", fused=fused,
                                    block=EF_BLOCK, interpret=True)
                return red[None], new_r[None]
            f = jax.jit(jax.shard_map(
                ef, mesh=mesh, in_specs=(P("d", None), P("d", None)),
                out_specs=(P("d", None), P("d", None)), check_vma=False))
            red, new_r = f(jnp.asarray(data[f"g_w{w}"]),
                           jnp.asarray(data[f"r_w{w}"]))
            res[f"ef_{tag}_w{w}"] = np.asarray(red)
            res[f"ef_{tag}_res_w{w}"] = np.asarray(new_r)
    np.savez(out, **res)


if __name__ == "__main__":
    _jax_reference(sys.argv[1], sys.argv[2])
