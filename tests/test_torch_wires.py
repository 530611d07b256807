"""The fp8 and bf16 wires of the port held against the JAX package.

Kernels: the plain versions of the fp8 forms of ``quantize_pack``,
``dequant_add_quantize`` and ``dequant_accumulate`` and of the three bf16
kernels (on the CPU every wrapper takes its plain version) against the
Pallas kernels in interpret mode, on the same numpy inputs. Rings: the
port's ``fused_wire_all_reduce`` over a ``LocalRing`` against the
reference's under ``jax.shard_map(..., check_vma=False)`` on w host
devices, in one subprocess (this file run as a script) that writes
``.npz``. Wire accounting: ``LocalRing``'s counts against both packages'
``fused_wire_bytes`` and the port's ``wire_formula``.

Tolerances, with the gaps measured on these inputs:
  * bf16, kernels and ring: bit-identical (measured: identical). The cast
    rounds to nearest even on both sides and ``acc + f32(recv)`` is one
    rounding.
  * fp8 kernels: scales within rtol 1e-6 and each e4m3 code within one
    step (one position in e4m3's ordered codes), the tolerance int8 has.
    XLA's CPU backend may divide ``amax / 448`` through a reciprocal and
    contracts ``acc + q * scale`` into an FMA, which the port never does.
    Measured: identical codes on every input here, the ±448, all-zero,
    tie and subnormal rows included, and scales at most 1.2e-7 apart (one
    ulp of a scale near 1).
  * fp8 dequantization with ``acc``: rtol/atol 1e-6 (the FMA; measured
    9.5e-7 at most); without ``acc`` it is one rounding, so exact
    (measured: identical).
  * fp8 ring: at most w-1 e4m3 steps of each element's final block scale,
    where a step is e4m3's spacing at the element's own magnitude; the
    int8 ring's rule with int8's uniform step replaced by e4m3's.
    Measured: no element a whole step apart; where a final block scale is
    one ulp apart, its elements differ by at most 1.5e-6.
"""

import os
import subprocess
import sys
from functools import partial

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.dist import compression as jax_comp
from repro.kernels import quant_ring as jax_qr
from repro_torch.core.rar_model import wire_formula
from repro_torch.dist.collectives import LocalRing
from repro_torch.dist.compression import (
    FUSED_WIRES,
    _fused_chunk_layout,
    compressed_ring_all_reduce,
    fused_wire_all_reduce,
    fused_wire_bytes,
    pack_hop_message,
    unpack_hop_message,
)
from repro_torch.kernels import quant_ring as qr

FP8 = torch.float8_e4m3fn
BLOCK = 128
WS = (2, 3, 4)
SIZES = (513, 1000)
WIRES = ("bf16", "fp8")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(1, 128), (3, 512), (16, 64), (7, 33), (2, 4096)]


def make_rows(nb, block, seed, scale=3.0, special=False):
    """Seeded f32 rows. With ``special`` (and three or more rows), row 0
    has amax 448, so its fp8 scale is 1 and x / scale is x itself: it holds
    +-448, e4m3 ties (1.0625 lies halfway between 1 and 1.125) and values
    in e4m3's subnormal range (below 2^-6), ties between subnormals
    included; row 1 is all zero."""
    x = (np.random.default_rng(seed).standard_normal((nb, block)) * scale
         ).astype(np.float32)
    if special and nb >= 3:
        k = np.arange(block, dtype=np.float32)
        row = np.where(k % 4 == 0, (k % 13 - 6) * 2.0 ** -9,          # subnormal
              np.where(k % 4 == 1, (k % 7 + 0.5) * 2.0 ** -9,         # their ties
              np.where(k % 4 == 2, 1.0625 * (1 + k % 3), -(k % 50))))  # normal ties
        row[0], row[1] = 448.0, -448.0
        x[0] = row.astype(np.float32)
        x[1] = 0.0
    return x


CASES = [(nb, b, False) for nb, b in SHAPES] + [(4, 64, True), (3, 256, True)]


def e4m3_ordinal(q) -> np.ndarray:
    """e4m3 codes as ordered integers: neighbouring values one apart, +0
    and -0 both 0."""
    bits = np.asarray(q).view(np.uint8).astype(np.int32)
    mag = bits & 0x7F
    return np.where(bits & 0x80, -mag, mag)


def fp8_bits(q: torch.Tensor) -> np.ndarray:
    return q.view(torch.uint8).numpy()


def assert_fp8_close(q, s, q_ref, s_ref):
    np.testing.assert_allclose(s, s_ref, rtol=1e-6)
    gap = np.abs(e4m3_ordinal(fp8_bits(q)) - e4m3_ordinal(q_ref)).max()
    assert int(gap) <= 1, gap


def _jax(a):
    return jnp.asarray(a)


def _torch_fp8(a) -> torch.Tensor:
    """A reference fp8 array as a torch float8_e4m3fn tensor, bit for bit."""
    return torch.from_numpy(np.asarray(a).view(np.uint8).copy()).view(FP8)


@pytest.mark.parametrize("nb,block,special", CASES)
def test_fp8_quantize_pack_matches_pallas(nb, block, special):
    x = make_rows(nb, block, seed=nb * block, special=special)
    q_ref, s_ref = jax_qr.quantize_pack_pallas(_jax(x), interpret=True,
                                               wire_dtype=jnp.float8_e4m3fn)
    q, s = qr.quantize_pack(torch.from_numpy(x), FP8)
    assert q.dtype == FP8 and s.dtype == torch.float32
    assert_fp8_close(q, s.numpy(), q_ref, np.asarray(s_ref))
    if special and nb >= 3:
        assert s[0] == 1.0 and s[1] == 1.0 and (fp8_bits(q)[1] == 0).all()
        got = q[0].float().numpy()
        assert got[0] == 448.0 and got[1] == -448.0
        # 3.1875 is no tie; the ties round to even: 1.0625 -> 1.0, 2.125 -> 2.0
        np.testing.assert_array_equal(got[2::4][:3], [3.25, 1.0, 2.0])


@pytest.mark.parametrize("nb,block,special", CASES)
def test_fp8_dequant_add_quantize_matches_pallas(nb, block, special):
    x = make_rows(nb, block, seed=1 + nb * block, special=special)
    acc = make_rows(nb, block, seed=2 + nb * block, scale=2.0)
    q, s = jax_qr.quantize_pack_pallas(_jax(x), interpret=True,
                                       wire_dtype=jnp.float8_e4m3fn)
    q2_ref, s2_ref = jax_qr.dequant_add_quantize_pallas(q, s, _jax(acc),
                                                         interpret=True)
    q2, s2 = qr.dequant_add_quantize(_torch_fp8(q), torch.from_numpy(np.array(s)),
                                     torch.from_numpy(acc))
    assert q2.dtype == FP8
    assert_fp8_close(q2, s2.numpy(), q2_ref, np.asarray(s2_ref))


@pytest.mark.parametrize("with_acc", [True, False])
@pytest.mark.parametrize("nb,block,special", CASES)
def test_fp8_dequant_accumulate_matches_pallas(nb, block, special, with_acc):
    x = make_rows(nb, block, seed=3 + nb * block, special=special)
    acc = make_rows(nb, block, seed=4 + nb * block, scale=2.0)
    q, s = jax_qr.quantize_pack_pallas(_jax(x), interpret=True,
                                       wire_dtype=jnp.float8_e4m3fn)
    ref = jax_qr.dequant_accumulate_pallas(
        q, s, _jax(acc) if with_acc else None, interpret=True)
    out = qr.dequant_accumulate(_torch_fp8(q), torch.from_numpy(np.array(s)),
                                torch.from_numpy(acc) if with_acc else None)
    assert out.dtype == torch.float32
    if with_acc:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("nb,block,special", CASES)
def test_bf16_kernels_match_pallas(nb, block, special):
    x = make_rows(nb, block, seed=5 + nb * block, special=special)
    acc = make_rows(nb, block, seed=6 + nb * block, scale=2.0)
    tx, tacc = torch.from_numpy(x), torch.from_numpy(acc)

    def bits(t):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy().view(np.int32)

    def ref_bits(a):
        a = np.asarray(a)
        return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a.view(np.int32)

    h_ref = jax_qr.cast_pack_bf16_pallas(_jax(x), interpret=True)
    h = qr.cast_pack_bf16(tx)
    assert h.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(h), ref_bits(h_ref))
    a_ref = jax_qr.bf16_add_cast_pallas(h_ref, _jax(acc), interpret=True)
    np.testing.assert_array_equal(bits(qr.bf16_add_cast(h, tacc)), ref_bits(a_ref))
    for a, want in ((tacc, jax_qr.bf16_accumulate_pallas(h_ref, _jax(acc),
                                                          interpret=True)),
                    (None, jax_qr.bf16_accumulate_pallas(h_ref, None,
                                                         interpret=True))):
        got = qr.bf16_accumulate(h, a)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(bits(got), ref_bits(want))


def test_cast_pack_bf16_off_16_bytes_matches_pallas():
    """Views that do not start on 16 bytes (one, two and three elements
    past a 16-byte boundary), with a size not a multiple of 8, give the
    Pallas kernel's bits through the wrapper."""
    n = 7 * 33
    base = torch.empty(n + 8)  # the CPU allocator starts it on 64 bytes
    base.copy_(torch.from_numpy(make_rows(1, n + 8, seed=10).reshape(-1)))
    assert base.data_ptr() % 16 == 0
    for off in (1, 2, 3):
        x = base[off:off + n].view(7, 33)
        assert x.data_ptr() % 16 != 0 and x.numel() % 8 != 0
        h = qr.cast_pack_bf16(x)
        want = jax_qr.cast_pack_bf16_pallas(_jax(x.numpy()), interpret=True)
        np.testing.assert_array_equal(h.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))


@pytest.mark.parametrize("nb,block", SHAPES)
def test_fp8_hop_message_byte_identical(nb, block):
    x = make_rows(nb, block, seed=7)
    q, s = jax_qr.quantize_pack_pallas(_jax(x), interpret=True,
                                       wire_dtype=jnp.float8_e4m3fn)
    want = np.asarray(jax_comp.pack_hop_message(q, s))
    tq, ts = _torch_fp8(q), torch.from_numpy(np.array(s))
    msg = pack_hop_message(tq, ts)
    assert msg.dtype == torch.int8 and msg.numel() == qr.HopMessageLayout(
        nb, block).message_bytes
    np.testing.assert_array_equal(msg.numpy(), want)
    q2, s2 = unpack_hop_message(msg, nb, block, FP8)
    assert q2.dtype == FP8 and torch.equal(q2.view(torch.uint8), tq.view(torch.uint8))
    assert torch.equal(s2, ts)
    jq, js = jax_comp.unpack_hop_message(jnp.asarray(msg.numpy()), nb, block,
                                         jnp.float8_e4m3fn)
    np.testing.assert_array_equal(fp8_bits(q2), np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(js))


def test_cpu_wrappers_take_plain_path_and_count_nothing():
    qr.reset_launches()
    x = torch.from_numpy(make_rows(3, 64, seed=8))
    q, s = qr.quantize_pack(x, FP8)
    q2, s2 = qr.dequant_add_quantize(q, s, x)
    h = qr.cast_pack_bf16(x)
    gq, gs = q.view(3, 1, 64), s.view(3, 1)
    pairs = [((q, s), qr.quantize_pack_plain(x, FP8)),
             ((qr.dequant_gather(gq, gs, 1),), (qr.dequant_gather_plain(gq, gs, 1),)),
             ((q2, s2), qr.dequant_add_quantize_plain(q, s, x)),
             ((qr.dequant_accumulate(q2, s2, x),),
              (qr.dequant_accumulate_plain(q2, s2, x),)),
             ((qr.dequant_accumulate(q2, s2),), (qr.dequant_accumulate_plain(q2, s2),)),
             ((h,), (qr.cast_pack_bf16_plain(x),)),
             ((qr.bf16_add_cast(h, x),), (qr.bf16_add_cast_plain(h, x),)),
             ((qr.bf16_accumulate(h, x),), (qr.bf16_accumulate_plain(h, x),)),
             ((qr.bf16_accumulate(h),), (qr.bf16_accumulate_plain(h),))]
    for got, want in pairs:
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    assert len(qr.LAUNCHES) == 12 and set(qr.LAUNCHES.values()) == {0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((2, 8))
    h = qr.cast_pack_bf16(x)
    with pytest.raises(ValueError):
        qr.quantize_pack(x, torch.bfloat16)                  # not a quantized wire
    with pytest.raises(TypeError):
        qr.dequant_add_quantize(h, torch.ones(2), x)         # bf16 payload
    with pytest.raises(TypeError):
        qr.bf16_add_cast(h.float(), x)
    with pytest.raises(TypeError):
        qr.bf16_accumulate(h, x.double())
    with pytest.raises(ValueError):
        qr.cast_pack_bf16(x.reshape(-1))
    with pytest.raises(ValueError):
        qr.cast_pack_bf16(torch.zeros((2, 8), device="meta"))


# ---------------------------------------------------------------------------
# the rings against the reference
# ---------------------------------------------------------------------------

def _key(w, d):
    return f"w{w}_d{d}"


def _inputs():
    rng = np.random.default_rng(12)
    return {_key(w, d): rng.standard_normal((w, d)).astype(np.float32)
            for w in WS for d in SIZES}


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wires_ref")
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


def e4m3_spacing(v: np.ndarray) -> np.ndarray:
    """e4m3's spacing at magnitude |v| (in units of the scale): 2^(e-3) in
    the binade [2^e, 2^(e+1)), 2^-9 below 2^-6."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -6)))
    return 2.0 ** (e - 3)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("d", SIZES)
@pytest.mark.parametrize("w", WS)
def test_fused_wire_ring_matches_reference(jax_out, wire, w, d):
    x = _inputs()[_key(w, d)]
    ring = LocalRing(["cpu"] * w)
    out = fused_wire_all_reduce([torch.from_numpy(x[r].copy()) for r in range(w)],
                                ring, wire=wire, block=BLOCK)
    got = np.stack([o.numpy() for o in out])
    want = jax_out[f"{wire}_{_key(w, d)}"]
    # every rank ends bit-identical, in the port and in the reference
    assert (got == got[0]).all() and (want == want[0]).all()
    if wire == "bf16":
        np.testing.assert_array_equal(got[0], want[0])
    else:
        # at most w-1 e4m3 steps at each element's magnitude, in units of
        # its final block scale (max |block| = 448 * scale exactly)
        c_pad, nb, pad = _fused_chunk_layout(d, w, BLOCK)
        blocks = np.pad(want[0], (0, pad)).reshape(w * nb, c_pad // nb)
        scale = np.abs(blocks).max(axis=1, keepdims=True) / 448.0
        safe = np.where(scale > 0, scale, 1.0)
        tol = (w - 1) * e4m3_spacing(blocks / safe) * scale * (1 + 1e-6)
        assert (np.abs(got[0] - want[0]) <= tol.reshape(-1)[:d]).all()
    # the reference's accuracy bound against the exact sum
    # (tests/test_dist.py::test_fused_wire_all_reduce_close_to_exact)
    exact = x.sum(axis=0)
    rel = np.abs(got[0] - exact).max() / (np.abs(exact).max() + 1e-9)
    assert rel < {"bf16": 0.02, "fp8": 0.25}[wire], rel
    # LocalRing's counts equal both packages' accounting and wire_formula
    nbytes = fused_wire_bytes(d, w, wire=wire, block=BLOCK)
    f = wire_formula(f"{wire}-fused", block=BLOCK)
    assert ring.messages == [2 * (w - 1)] * w == [f.messages(w)] * w
    assert ring.bytes == [nbytes] * w
    assert nbytes == jax_comp.fused_wire_bytes(d, w, wire=wire, block=BLOCK)
    assert nbytes == f.bytes_per_worker(d, w)


@pytest.mark.parametrize("d", SIZES)
@pytest.mark.parametrize("w", WS)
def test_int8_wire_is_the_fused_int8_ring(w, d):
    x = _inputs()[_key(w, d)]
    xs = [torch.from_numpy(x[r].copy()) for r in range(w)]
    a = fused_wire_all_reduce(xs, LocalRing(["cpu"] * w), wire="int8", block=BLOCK)
    b = compressed_ring_all_reduce(xs, LocalRing(["cpu"] * w), fused=True,
                                   block=BLOCK)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def test_wire_bytes_over_sweep_and_errors():
    for wire in FUSED_WIRES:
        layout = {"int8": "int8-fused", "fp8": "fp8-fused", "bf16": "bf16-fused"}[wire]
        for w in range(1, 9):
            for d in (1, 33, 513, 4096 * 3 + 1, 151936 * 1024):
                for block in (128, 4096):
                    got = fused_wire_bytes(d, w, wire=wire, block=block)
                    assert got == jax_comp.fused_wire_bytes(d, w, wire=wire,
                                                            block=block)
                    assert got == wire_formula(layout, block=block
                                               ).bytes_per_worker(d, w)
    x = torch.zeros(8)
    with pytest.raises(ValueError):
        fused_wire_bytes(8, 2, wire="int4")
    with pytest.raises(ValueError):
        fused_wire_all_reduce([x, x], LocalRing(["cpu"] * 2), wire="int4")
    ring = LocalRing(["cpu"])                 # one rank: no hop, no rounding
    assert fused_wire_all_reduce([x], ring, wire="fp8")[0] is x
    assert ring.messages == [0]


def _jax_reference(inp, out):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    res = {}
    with np.load(inp) as data:
        for key in data.files:
            x = data[key]
            mesh = Mesh(np.array(jax.devices()[: x.shape[0]]), ("d",))
            for wire in WIRES:
                fn = partial(jax_comp.fused_wire_all_reduce, wire=wire,
                             block=BLOCK, interpret=True)
                f = jax.jit(jax.shard_map(
                    lambda a, fn=fn: fn(a[0], axis_name="d")[None], mesh=mesh,
                    in_specs=P("d", None), out_specs=P("d", None),
                    check_vma=False))
                res[f"{wire}_{key}"] = np.asarray(f(jnp.asarray(x)))
    np.savez(out, **res)


if __name__ == "__main__":
    _jax_reference(sys.argv[1], sys.argv[2])
