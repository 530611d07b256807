"""The port's quant-ring kernels (``repro_torch.kernels.quant_ring``) held
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

On the CPU every wrapper takes its plain PyTorch version, so these tests
hold the plain versions (the arithmetic the CUDA kernels reproduce bit for
bit on the card) against the TPU kernels on the same numpy inputs.

Tolerances are those of ``tests/test_kernels.py::_assert_quant_equiv``:
scales within rtol 1e-6 and int8 codes within one step. XLA's CPU backend
may lower ``amax / 127`` as a multiply by the reciprocal (one ulp on a few
scales) and contracts ``acc + q * scale`` into an FMA, which the port never
does; so the f32 dequantization is held at rtol/atol 1e-6, as the
reference's own dequant test holds it.

The fused ring's in-place forms (B1 and B2 writing into one message buffer,
``dequant_gather`` reading the Share-Only messages where they landed and
writing chunk order) are held bit for bit to the copying forms they replace.
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import compression as jax_comp
from repro.kernels import quant_ring as jax_qr
from repro_torch.dist import compression as comp
from repro_torch.kernels import quant_ring as qr

SHAPES = [(1, 128), (3, 512), (16, 64), (7, 33), (2, 4096)]


def make_rows(nb, block, seed, scale=3.0, special=None):
    """Seeded f32 rows. ``special="zeros"`` zeroes every other row;
    ``special="ties"`` makes row 0 hit exact .5 ties (its amax is 127, so
    its scale is 1 and x / scale is x itself)."""
    x = (np.random.default_rng(seed).standard_normal((nb, block)) * scale
         ).astype(np.float32)
    if special == "zeros":
        x[::2] = 0.0
    elif special == "ties":
        ties = (np.arange(block) % 40 - 20.5).astype(np.float32)
        ties[0] = 127.0
        x[0] = ties
    return x


def assert_quant_close(q, s, q_ref, s_ref):
    np.testing.assert_allclose(s, s_ref, rtol=1e-6)
    assert int(np.abs(q.astype(np.int32) - q_ref.astype(np.int32)).max()) <= 1


CASES = [(nb, b, None) for nb, b in SHAPES] + [(4, 64, "zeros"),
                                               (3, 128, "ties")]


@pytest.mark.parametrize("nb,block,special", CASES)
def test_quantize_pack_matches_pallas(nb, block, special):
    x = make_rows(nb, block, seed=nb * block, special=special)
    q_ref, s_ref = jax_qr.quantize_pack_pallas(jnp.asarray(x), interpret=True)
    q, s = qr.quantize_pack(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert_quant_close(q.numpy(), s.numpy(), np.asarray(q_ref), np.asarray(s_ref))
    if special == "zeros":
        assert (s.numpy()[::2] == 1.0).all() and (q.numpy()[::2] == 0).all()
    if special == "ties":
        # round half to even, as jnp.round does: -20.5 -> -20, -19.5 -> -20
        assert s.numpy()[0] == 1.0
        np.testing.assert_array_equal(q.numpy()[0], np.round(x[0]).astype(np.int8))


@pytest.mark.parametrize("nb,block,special", CASES)
def test_dequant_add_quantize_matches_pallas(nb, block, special):
    x = make_rows(nb, block, seed=1 + nb * block, special=special)
    acc = make_rows(nb, block, seed=2 + nb * block, scale=2.0, special=special)
    q, s = jax_qr.quantize_pack_pallas(jnp.asarray(x), interpret=True)
    q2_ref, s2_ref = jax_qr.dequant_add_quantize_pallas(q, s, jnp.asarray(acc),
                                                         interpret=True)
    q2, s2 = qr.dequant_add_quantize(torch.from_numpy(np.array(q)),
                                     torch.from_numpy(np.array(s)),
                                     torch.from_numpy(acc))
    assert_quant_close(q2.numpy(), s2.numpy(), np.asarray(q2_ref),
                       np.asarray(s2_ref))


@pytest.mark.parametrize("with_acc", [True, False])
@pytest.mark.parametrize("nb,block,special", CASES)
def test_dequant_accumulate_matches_pallas(nb, block, special, with_acc):
    x = make_rows(nb, block, seed=3 + nb * block, special=special)
    acc = make_rows(nb, block, seed=4 + nb * block, scale=2.0)
    q, s = jax_qr.quantize_pack_pallas(jnp.asarray(x), interpret=True)
    ref = jax_qr.dequant_accumulate_pallas(
        q, s, jnp.asarray(acc) if with_acc else None, interpret=True)
    out = qr.dequant_accumulate(torch.from_numpy(np.array(q)),
                                torch.from_numpy(np.array(s)),
                                torch.from_numpy(acc) if with_acc else None)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    if not with_acc:  # q * s alone is one rounding on both sides: exact
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("nb,block", SHAPES)
def test_pack_hop_message_byte_identical(nb, block):
    x = make_rows(nb, block, seed=5)
    q, s = jax_qr.quantize_pack_pallas(jnp.asarray(x), interpret=True)
    want = np.asarray(jax_comp.pack_hop_message(q, s))
    tq, ts = torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s))
    msg = comp.pack_hop_message(tq, ts)
    assert msg.dtype == torch.int8
    np.testing.assert_array_equal(msg.numpy(), want)
    q2, s2 = comp.unpack_hop_message(msg, nb, block)
    assert torch.equal(q2, tq) and torch.equal(s2, ts)


def test_layouts_match_reference_over_sweep():
    for chunk in [1, 2, 31, 33, 127, 128, 129, 256, 513, 4095, 4096, 4097,
                  38_895_616]:
        for block in [1, 7, 33, 128, 4096]:
            assert qr.hop_message_layout(chunk, block=block) == \
                qr.HopMessageLayout(**vars(jax_qr.hop_message_layout(
                    chunk, block=block)))
    for n in [1, 5, 33, 513, 1000, 4096 * 3 + 1, 151936 * 1024]:
        for w in [1, 2, 3, 4, 8]:
            for block in [128, 4096]:
                assert comp._fused_chunk_layout(n, w, block) == \
                    jax_comp._fused_chunk_layout(n, w, block)
    assert qr.SCALE_BYTES == jax_qr.SCALE_BYTES and qr.QMAX == jax_qr.QMAX
    assert qr.wire_qmax(torch.int8) == jax_qr.wire_qmax(jnp.int8)
    assert qr.wire_qmax(torch.float8_e4m3fn) == jax_qr.wire_qmax(jnp.float8_e4m3fn)


def test_cpu_wrappers_take_plain_path_and_count_nothing():
    qr.reset_launches()
    x = torch.from_numpy(make_rows(3, 64, seed=6))
    q, s = qr.quantize_pack(x)
    q2, s2 = qr.dequant_add_quantize(q, s, x)
    out = qr.dequant_accumulate(q2, s2, x)
    deq = qr.dequant_accumulate(q2, s2)
    for got, want in [((q, s), qr.quantize_pack_plain(x)),
                      ((q2, s2), qr.dequant_add_quantize_plain(q, s, x)),
                      ((out,), (qr.dequant_accumulate_plain(q2, s2, x),)),
                      ((deq,), (qr.dequant_accumulate_plain(q2, s2),))]:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert set(qr.LAUNCHES.values()) == {0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((2, 8))
    q, s = qr.quantize_pack(x)
    with pytest.raises(TypeError):
        qr.quantize_pack(x.double())
    with pytest.raises(ValueError):
        qr.quantize_pack(x.reshape(-1))
    with pytest.raises(ValueError):
        qr.quantize_pack(torch.zeros((8, 2)).t())          # not contiguous
    with pytest.raises(ValueError):
        qr.dequant_add_quantize(q, s[:1], x)                 # scales shape
    with pytest.raises(TypeError):
        qr.dequant_accumulate(q.float(), s, x)
    with pytest.raises(ValueError):
        # no kernel and no plain fallback for a device that is neither
        qr.quantize_pack(torch.zeros((2, 8), device="meta"))


# ---------------------------------------------------------------------------
# the in-place forms against the copying forms they replace
# ---------------------------------------------------------------------------

WIRES = [torch.int8, torch.float8_e4m3fn]
# (7, 33) and (2, 37): 231 and 74 payload bytes, trailers off 4 bytes
GATHER_SHAPES = [(1, 1), (2, 37), (3, 128), (7, 33)]


def same_bits(*pairs) -> bool:
    """Every pair of tensors of one dtype and shape, byte for byte (torch
    has no fp8 comparison on the CPU)."""
    return all(a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))
        for a, b in pairs)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("nb,block", SHAPES)
def test_messages_written_in_place_equal_packed_ones(wire, nb, block):
    """B1 and B2 writing into a message buffer (``_write_message``) leave
    the bytes ``pack_hop_message`` packs; ``_message_parts`` reads the
    payload where it lies, and the scales too where the trailer is on 4
    bytes."""
    x, acc = (torch.from_numpy(make_rows(nb, block, seed=s)) for s in (9, 10))
    size = nb * (block + qr.SCALE_BYTES)
    msg = comp._write_message(torch.full((size,), 7, dtype=torch.int8),
                              partial(qr.quantize_pack, x, wire), nb, block, wire)
    assert torch.equal(msg, comp.pack_hop_message(*qr.quantize_pack(x, wire)))
    q, scales = comp._message_parts(msg, nb, block, wire)
    assert q.dtype == wire and q.data_ptr() == msg.data_ptr()
    assert (scales.data_ptr() == msg.data_ptr() + nb * block) == (
        nb * block % 4 == 0)
    assert same_bits(*zip((q, scales), comp.unpack_hop_message(msg, nb, block, wire)))
    hop = comp._write_message(torch.full((size,), 7, dtype=torch.int8),
                              partial(qr.dequant_add_quantize, q, scales, acc),
                              nb, block, wire)
    assert torch.equal(hop, comp.pack_hop_message(
        *qr.dequant_add_quantize(q, scales, acc)))


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("nb,block", GATHER_SHAPES)
@pytest.mark.parametrize("w", (2, 3, 4, 5))
def test_dequant_gather_equals_stack_dequant_and_placement(wire, w, nb, block):
    """One ``dequant_gather`` over a rank's gather buffer, its messages a
    row apart, equals the stack of the w messages, one ``dequant_accumulate``
    and ``_place_gathered``, for every rank's chunk map."""
    x = torch.from_numpy(make_rows(w * nb, block, seed=w * nb + block))
    q, scales = qr.quantize_pack(x, wire)
    gather = torch.stack([comp.pack_hop_message(q[r * nb:(r + 1) * nb],
                                                scales[r * nb:(r + 1) * nb])
                          for r in range(w)])
    deq = qr.dequant_accumulate(q, scales).view(w, nb, block)
    for i in range(w):
        got = qr.dequant_gather(*comp._message_parts(gather, nb, block, wire),
                                (i + 1) % w)
        assert got.shape == (w, nb, block)
        assert torch.equal(got, comp._place_gathered(deq, i, w))
    # one message in place order is dequant_accumulate's plain form
    one = qr.dequant_gather(q[None, :nb], scales[None, :nb], 0)
    assert torch.equal(one[0], qr.dequant_accumulate(q[:nb], scales[:nb]))


@pytest.mark.parametrize("wire", WIRES)
def test_quantizing_wrappers_write_the_given_tensors(wire):
    x = torch.from_numpy(make_rows(3, 64, seed=11))
    out = (torch.empty((3, 64), dtype=wire), torch.empty(3))
    got = qr.quantize_pack(x, wire, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    assert same_bits(*zip(got, qr.quantize_pack_plain(x, wire)))
    out2 = (torch.empty((3, 64), dtype=wire), torch.empty(3))
    got = qr.dequant_add_quantize(out[0], out[1], x, out=out2)
    assert got[0] is out2[0] and got[1] is out2[1]
    assert same_bits(*zip(got, qr.dequant_add_quantize_plain(out[0], out[1], x)))
    with pytest.raises(TypeError):
        qr.quantize_pack(x, wire, out=(torch.empty((3, 64)), out[1]))
    with pytest.raises(ValueError):
        qr.quantize_pack(x, wire, out=(out[0], torch.empty(4)))
    with pytest.raises(ValueError):
        qr.dequant_add_quantize(out[0], out[1], x,
                                out=(torch.empty((64, 3), dtype=wire).t(), out[1]))


def test_dequant_gather_rejects_what_the_kernel_does_not_take():
    q, s = qr.quantize_pack(torch.from_numpy(make_rows(6, 8, seed=12)))
    q3, s2 = q.view(3, 2, 8), s.view(3, 2)
    with pytest.raises(ValueError, match="first"):
        qr.dequant_gather(q3, s2, 3)
    with pytest.raises(ValueError, match="3-D"):
        qr.dequant_gather(q, s2, 0)
    with pytest.raises(ValueError, match="scales"):
        qr.dequant_gather(q3, s, 0)
    with pytest.raises(TypeError):
        qr.dequant_gather(q3.float(), s2, 0)
    with pytest.raises(ValueError, match="contiguous"):
        qr.dequant_gather(q.view(3, 8, 2).transpose(1, 2), s2, 0)
