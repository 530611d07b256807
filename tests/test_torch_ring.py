"""The port's rings (``repro_torch.dist``) held against the JAX package's
``ring_all_reduce`` and ``compressed_ring_all_reduce(fused=True)``.

The fused ring writes each message where it crosses the wire and reads it
where it lands; its copying form (each message packed by a copy, the
Share-Only messages stacked, dequantized and put in chunk order by copies)
is kept below as the oracle the in-place form is held to bit for bit.

The JAX references run under ``jax.shard_map(..., check_vma=False)`` on w
host devices, all in one subprocess (this file run as a script) that
writes ``.npz``; ``check_vma=False`` is what the reference's own trainer
passes (a Pallas call under ``shard_map`` fails the default check on
jax 0.9). The port runs the same w ranks in this process over a
:class:`LocalRing` on the CPU, where the quant-ring wrappers take their
plain versions.

Tolerances:
  * the f32 ring keeps the reference's hop order, so its sums are
    bit-identical;
  * the fused int8 ring may differ where XLA's CPU backend contracts
    ``acc + q * scale`` into an FMA (the port never does): one ulp of a
    partial sum can move a requantized code by one step at each of the
    w-2 Share-Reduce requantizations and the final quantization, so at
    most w-1 steps of the final block scale are allowed. Measured on these
    inputs: a block scale one ulp apart (at most 1.4e-5 of a step) in every
    case, and besides that two elements one full step apart at w=3, d=513.
"""

import math
import os
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch

from repro.core.rar_model import wire_formula
from repro_torch import spans
from repro_torch.dist import compression as comp
from repro_torch.dist.collectives import (
    LocalRing,
    ring_all_reduce,
    ring_all_reduce_,
    ring_wire_elements,
)
from repro_torch.training.train_step import reduce_grads
from repro_torch.dist.compression import (
    _fused_chunk_layout,
    compressed_ring_all_reduce,
    compressed_ring_ppermutes,
    compressed_wire_bytes,
    ef_compressed_all_reduce,
    fused_wire_all_reduce,
)
from repro_torch.dist.overlap import (
    bucketed_ring_reduce,
    plan_bucket_sizes,
    tree_leaves,
)
from repro_torch.kernels import quant_ring as qr

BLOCK = 128
WS = (2, 3, 4)
SIZES = (513, 1000)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _key(w, d):
    return f"w{w}_d{d}"


def _inputs():
    rng = np.random.default_rng(11)
    return {_key(w, d): rng.standard_normal((w, d)).astype(np.float32)
            for w in WS for d in SIZES}


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring_ref")
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


@pytest.mark.parametrize("d", SIZES)
@pytest.mark.parametrize("w", WS)
def test_f32_ring_bit_identical_to_reference(jax_out, w, d):
    x = _inputs()[_key(w, d)]
    ring = LocalRing(["cpu"] * w)
    out = ring_all_reduce(_ranks(x), ring)
    want = jax_out["ring_" + _key(w, d)]
    for r in range(w):
        np.testing.assert_array_equal(out[r].numpy(), want[r])
    # wire: 2(w-1) messages of the zero-padded ceil(d/w) chunk per rank
    d_wire = -(-d // w) * w
    assert ring.messages == [2 * (w - 1)] * w
    assert ring.bytes == [4 * ring_wire_elements(d_wire, w)] * w
    assert ring.bytes == [wire_formula(None).bytes_per_worker(d, w)] * w


@pytest.mark.parametrize("d", SIZES)
@pytest.mark.parametrize("w", WS)
def test_fused_ring_matches_reference(jax_out, w, d):
    x = _inputs()[_key(w, d)]
    ring = LocalRing(["cpu"] * w)
    out = compressed_ring_all_reduce(_ranks(x), ring, fused=True,
                                     block=BLOCK)
    got = np.stack([o.numpy() for o in out])
    want = jax_out["fused_" + _key(w, d)]
    # every rank ends bit-identical, in the port and in the reference
    assert (got == got[0]).all() and (want == want[0]).all()
    # at most w-1 int8 steps of the final block scale off the reference
    # (max |block| = 127 * scale exactly: the amax element codes to +-127)
    c_pad, nb, pad = _fused_chunk_layout(d, w, BLOCK)
    blocks = np.pad(want[0], (0, pad)).reshape(w * nb, c_pad // nb)
    step = np.abs(blocks).max(axis=1, keepdims=True) / 127.0
    tol = np.broadcast_to((w - 1) * step * (1 + 1e-6), blocks.shape)
    tol = tol.reshape(-1)[:d]
    assert (np.abs(got[0] - want[0]) <= tol).all()
    # the reference's accuracy bound against the exact sum
    exact = x.sum(axis=0)
    rel = np.abs(got[0] - exact).max() / (np.abs(exact).max() + 1e-9)
    assert rel < 0.15, rel
    # LocalRing's own counts equal the wire accounting of both packages
    msgs = compressed_ring_ppermutes(w, fused=True)
    nbytes = compressed_wire_bytes(d, w, fused=True, block=BLOCK)
    f = wire_formula("int8-fused", block=BLOCK)
    assert ring.messages == [msgs] * w and msgs == f.messages(w)
    assert ring.bytes == [nbytes] * w and nbytes == f.bytes_per_worker(d, w)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("d", SIZES)
@pytest.mark.parametrize("w", WS)
def test_in_place_ring_bit_identical_to_copying_ring_and_reference(
        jax_out, w, d, reverse):
    """The consuming form runs the same hops and adds: the same bits as the
    copying form and the reference, the same messages and bytes. A size w
    divides is reduced in its inputs' own storage, any other through a
    padded copy; the copying form leaves its inputs as they were."""
    x = _inputs()[_key(w, d)]
    copying, consuming = LocalRing(["cpu"] * w), LocalRing(["cpu"] * w)
    ins = _ranks(x)
    want = ring_all_reduce(ins, copying, reverse=reverse)
    for r in range(w):
        np.testing.assert_array_equal(ins[r].numpy(), x[r])
    ptrs = [t.data_ptr() for t in ins]
    got = ring_all_reduce_(ins, consuming, reverse=reverse)
    ref = jax_out[("ring_rev_" if reverse else "ring_") + _key(w, d)]
    for r in range(w):
        assert torch.equal(got[r], want[r])
        np.testing.assert_array_equal(got[r].numpy(), ref[r])
        assert (got[r].data_ptr() == ptrs[r]) == (d % w == 0)
    assert consuming.messages == copying.messages
    assert consuming.bytes == copying.bytes
    assert consuming.directions == copying.directions


def _aliased(w, gen):
    base = torch.randn(w, 48, generator=gen)
    return list(base)                     # rows of one storage


def _one_tensor(w, gen):
    x = torch.randn(48, generator=gen)
    return [x] * w


def _expanded(w, gen):
    return [torch.randn(1, 6, generator=gen).expand(8, 6) for _ in range(w)]


def _transposed(w, gen):
    return [torch.randn(6, 8, generator=gen).t() for _ in range(w)]


UNOWNABLE = {"aliased ranks": _aliased, "one tensor": _one_tensor,
             "expanded": _expanded, "non-contiguous": _transposed}


@pytest.mark.parametrize("case", list(UNOWNABLE))
def test_in_place_ring_copies_what_it_cannot_own(case):
    """Inputs that share a storage, an expanded (stride-0) input and a
    non-contiguous one take the padded copy: the same bits as the copying
    form, and the inputs left as they were."""
    w = 4
    xs = UNOWNABLE[case](w, torch.Generator().manual_seed(5))
    before = [x.clone() for x in xs]
    want = ring_all_reduce([x.clone() for x in xs], LocalRing(["cpu"] * w))
    got = ring_all_reduce_(xs, LocalRing(["cpu"] * w))
    for r in range(w):
        assert got[r].shape == xs[r].shape
        assert torch.equal(got[r], want[r])
        assert torch.equal(xs[r], before[r])
        assert got[r].untyped_storage().data_ptr() != xs[r].untyped_storage().data_ptr()


@pytest.mark.parametrize("reverse", [False, True])
def test_permute_into_writes_the_given_tensors(reverse):
    """``permute(..., into=...)`` copies each message into the receiver's
    given tensor and returns it, counting what a plain permute counts."""
    w = 3
    gen = torch.Generator().manual_seed(2)
    sends = [torch.randn(5, generator=gen) for _ in range(w)]
    perm = [(0, 2), (2, 1), (1, 0)]
    plain, given = LocalRing(["cpu"] * w), LocalRing(["cpu"] * w)
    want = plain.permute(sends, perm)
    into = [torch.zeros(5) for _ in range(w)]
    got = given.permute(sends, perm, into=into)
    for r in range(w):
        assert got[r] is into[r] and torch.equal(into[r], want[r])
    hops = plain.hop(sends, reverse=reverse)
    got = given.hop(sends, reverse=reverse, into=into)
    assert all(g is t and torch.equal(t, h) for g, t, h in zip(got, into, hops))
    assert (given.messages, given.bytes, given.directions) == (
        plain.messages, plain.bytes, plain.directions)
    with pytest.raises(ValueError, match="one destination per rank"):
        given.permute(sends, perm, into=into[:2])


def test_ring_mode_reduces_unshared_leaves_in_place():
    """``reduce_grads`` in mode ``ring`` reduces a leaf in its own storage
    only where no other leaf of its rank shares that storage; a pair of
    leaves that are one tensor, or views of one buffer, goes through the
    copying ring. Every leaf is the copying ring's sum over w."""
    w, gen = 2, torch.Generator().manual_seed(7)
    grads = []
    for _ in range(w):
        one, buf = torch.randn(12, generator=gen), torch.randn(20, generator=gen)
        grads.append({"alone": torch.randn(3, 4, generator=gen), "b": one, "c": one,
                      "d": buf[:8], "e": buf[8:]})
    want = {p: ring_all_reduce([g[p].clone() for g in grads], LocalRing(["cpu"] * w))
            for p in grads[0]}
    ins = [dict(g) for g in grads]
    before = {p: [g[p].clone() for g in grads] for p in grads[0]}
    out = reduce_grads(grads, LocalRing(["cpu"] * w), "ring")
    for p in want:
        for r in range(w):
            assert torch.equal(out[r][p], want[p][r] / w), p
    for r in range(w):
        assert torch.equal(ins[r]["alone"], want["alone"][r])     # consumed
        for p in "bcde":
            assert torch.equal(ins[r][p], before[p][r]), p


def test_one_rank_rings_pass_through():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(77)
                         .astype(np.float32))
    ring = LocalRing(["cpu"])
    for fused in (True, False):
        assert torch.equal(compressed_ring_all_reduce([x], ring, fused=fused)[0], x)
    assert torch.equal(ring_all_reduce([x], ring)[0], x)
    assert ring.messages == [0] and ring.bytes == [0]
    # the unfused ring over two ranks: two messages per hop, ranks agree
    ring2 = LocalRing(["cpu"] * 2)
    out = compressed_ring_all_reduce([x, x], ring2)
    assert torch.equal(out[0], out[1])
    assert ring2.messages == [compressed_ring_ppermutes(2)] * 2 == [4, 4]
    assert ring2.bytes == [compressed_wire_bytes(77, 2)] * 2


# ---------------------------------------------------------------------------
# the fused ring in place, held to its copying form
# ---------------------------------------------------------------------------

FUSED_WS = (2, 3, 4, 5)
# one element; a chunk under a sub-block whose trailer is off 4 bytes at
# w = 2, 3, 4 (on them at 5); padded chunks of whole sub-blocks
FUSED_SIZES = (1, 37, 4 * 4096 + 5, 70_001)
FUSED_WIRES = {"int8": torch.int8, "fp8": qr.FP8_DTYPE}


def copying_fused_ring(xs, ring, *, block, wire_dtype=torch.int8,
                       first_hop=None):
    """The fused ring in its copying form: every message packed by
    ``pack_hop_message`` and its scales cloned out on receipt, the w
    Share-Only messages stacked, dequantized in arrival order and put in
    chunk order by ``_place_gathered``."""
    w = ring.size
    c_pad, nb, pad = _fused_chunk_layout(xs[0].numel(), w, block)
    b = c_pad // nb
    chunks = [comp._padded_blocks(x, pad, w * nb).view(w, nb, b) for x in xs]

    def quant_pack(blocks2d):
        return comp.pack_hop_message(*qr.quantize_pack(blocks2d, wire_dtype))

    sends = list(first_hop) if first_hop is not None else [
        quant_pack(chunks[i][i]) for i in range(w)]
    reduced_own = [None] * w
    for s in range(w - 1):
        recvs = ring.hop(sends)
        sends = []
        for i in range(w):
            local = chunks[i][(i - s - 1) % w]
            q, scales = comp.unpack_hop_message(recvs[i], nb, b, wire_dtype)
            if s < w - 2:
                sends.append(comp.pack_hop_message(
                    *qr.dequant_add_quantize(q, scales, local)))
            else:
                reduced_own[i] = qr.dequant_accumulate(q, scales, local)
    msgs = [[quant_pack(reduced_own[i])] for i in range(w)]
    sends = [m[0] for m in msgs]
    for s in range(w - 1):
        sends = ring.hop(sends)
        for i in range(w):
            msgs[i].append(sends[i])
    outs = []
    for i, x in enumerate(xs):
        q_all = torch.stack([m[:nb * b] for m in msgs[i]]).view(
            w * nb, b).view(wire_dtype)
        scales_all = torch.stack([m[nb * b:] for m in msgs[i]]).view(
            torch.float32).view(-1)
        deq = qr.dequant_accumulate(q_all, scales_all, None).view(w, nb, b)
        outs.append(comp._unpad(comp._place_gathered(deq, i, w), x))
    return outs


class RecordingRing(LocalRing):
    """A ring that keeps a copy of every message it carries, in order."""

    def __init__(self, devices):
        super().__init__(devices)
        self.sent = []

    def permute(self, sends, perm, into=None):
        self.sent.append([m.clone() for m in sends])
        return super().permute(sends, perm, into)


def _traced(fn):
    """``fn()``'s result, and the inputs of its ``ring.hop`` and
    ``fused.layout`` spans in order."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        out = fn()
    events = sorted((e for e in prof.events() if e.name.startswith(spans.PREFIX)),
                    key=lambda e: e.time_range.start)
    return out, {name: [list(e.concrete_inputs) for e in events
                        if e.name == spans.PREFIX + name]
                 for name in ("ring.hop", "fused.layout")}


def _both_forms(run, w, monkeypatch):
    """``run(ring)`` through the in-place ring and through its copying
    form: each side's result, ring and spans."""
    sides = []
    for form in ("in place", "copying"):
        if form == "copying":
            monkeypatch.setattr(comp, "_fused_ring_all_reduce", copying_fused_ring)
        ring = RecordingRing(["cpu"] * w)
        out, traced = _traced(lambda: run(ring))
        sides.append((out, ring, traced))
    monkeypatch.undo()
    return sides


def _assert_same_wire(got, want):
    """The same hops with the same messages, byte for byte, and counts."""
    (_, ring, traced), (_, ring0, traced0) = got, want
    assert len(ring.sent) == len(ring0.sent)
    for hop, hop0 in zip(ring.sent, ring0.sent):
        assert all(torch.equal(m, m0) for m, m0 in zip(hop, hop0))
    assert (ring.messages, ring.bytes, ring.directions) == (
        ring0.messages, ring0.bytes, ring0.directions)
    assert traced["ring.hop"] == traced0["ring.hop"]
    assert sum(i[0] for i in traced["ring.hop"]) == sum(ring.bytes)


def _layout_counts(n, w, *, first_hop=False):
    """``fused.layout``'s (in_place, copied) for one all-reduce of n
    elements: w messages a rank, the scales copied where the trailer is off
    4 bytes, error feedback's w packed first hops copied."""
    c_pad, nb, _ = _fused_chunk_layout(n, w, 4096)
    msg = c_pad + 4 * nb
    trailer = 4 * nb if c_pad % 4 else 0
    made = w * (w - 1) if first_hop else w * w
    return [made * (msg - trailer), made * trailer + (w * w - made) * msg]


def _rank_inputs(w, n, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(n, generator=gen) * (r + 1) for r in range(w)]


@pytest.mark.parametrize("n", FUSED_SIZES)
@pytest.mark.parametrize("w", FUSED_WS)
@pytest.mark.parametrize("wire", list(FUSED_WIRES))
def test_fused_ring_in_place_bit_identical_to_its_copying_form(
        wire, w, n, monkeypatch):
    """Every rank's sum, every message and every count equal the copying
    form's; ``fused.layout`` counts w messages a rank in place, and copies
    only the scales of a trailer that is off 4 bytes."""
    xs = _rank_inputs(w, n, 31 * w + n)
    if wire == "int8":
        def run(ring):
            return compressed_ring_all_reduce(xs, ring, fused=True)
    else:
        def run(ring):
            return fused_wire_all_reduce(xs, ring, wire=wire)
    got, want = _both_forms(run, w, monkeypatch)
    for a, b in zip(got[0], want[0]):
        assert a.shape == b.shape and torch.equal(a, b)
    _assert_same_wire(got, want)
    counts = _layout_counts(n, w)
    assert got[2]["fused.layout"] == [counts]
    c_pad, _, _ = _fused_chunk_layout(n, w, 4096)
    assert (counts[1] == 0) == (c_pad % 4 == 0)


@pytest.mark.parametrize("n", FUSED_SIZES)
@pytest.mark.parametrize("w", FUSED_WS)
def test_ef_fused_ring_in_place_bit_identical_to_its_copying_form(
        w, n, monkeypatch):
    """Error feedback's fused ring, whose first hop forwards each rank's
    packed payload: the same sums, residuals, messages and counts as
    through the copying form; the w packed first hops count as copied."""
    gs = _rank_inputs(w, n, 7 * w + n)
    res = [g * 1e-3 for g in _rank_inputs(w, n, 5 * w + n)]
    got, want = _both_forms(
        lambda ring: ef_compressed_all_reduce(gs, res, ring, fused=True),
        w, monkeypatch)
    for part, part0 in zip(got[0], want[0]):
        assert all(torch.equal(a, b) for a, b in zip(part, part0))
    _assert_same_wire(got, want)
    assert got[2]["fused.layout"] == [_layout_counts(n, w, first_hop=True)]


@pytest.mark.parametrize("w", FUSED_WS)
def test_overlap_mode_in_place_bit_identical_to_its_copying_form(
        w, monkeypatch):
    """The overlap mode's buckets through the int8 fused ring: the same
    sums, messages and counts as through the copying form."""
    sizes = {"a": (3, 5), "b": (4096 + 3,), "c": (2, 37), "d": (70_001,),
             "e": (1,)}
    gen = torch.Generator().manual_seed(w)
    grads = [{k: torch.randn(shape, generator=gen) for k, shape in sizes.items()}
             for _ in range(w)]
    got, want = _both_forms(
        lambda ring: bucketed_ring_reduce(grads, ring, variant="int8-fused",
                                          n_buckets=3), w, monkeypatch)
    for tree, tree0 in zip(got[0], want[0]):
        assert tree.keys() == tree0.keys()
        assert all(torch.equal(tree[k], tree0[k]) for k in tree)
    _assert_same_wire(got, want)
    leaves = [math.prod(shape) for _, shape in tree_leaves(sizes)]
    assert got[2]["fused.layout"] == [
        _layout_counts(n, w) for n in plan_bucket_sizes(leaves, 3, reverse=True)]


def _jax_reference(inp, out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.dist.collectives import ring_all_reduce as jax_ring
    from repro.dist.compression import compressed_ring_all_reduce as jax_fused

    fns = {"ring": jax_ring, "ring_rev": partial(jax_ring, reverse=True),
           "fused": partial(jax_fused, fused=True, block=BLOCK, interpret=True)}
    res = {}
    with np.load(inp) as data:
        for key in data.files:
            x = data[key]
            mesh = Mesh(np.array(jax.devices()[: x.shape[0]]), ("d",))
            for name, fn in fns.items():
                f = jax.jit(jax.shard_map(
                    lambda a, fn=fn: fn(a[0], axis_name="d")[None], mesh=mesh,
                    in_specs=P("d", None), out_specs=P("d", None),
                    check_vma=False))
                res[f"{name}_{key}"] = np.asarray(f(jnp.asarray(x)))
    np.savez(out, **res)


if __name__ == "__main__":
    _jax_reference(sys.argv[1], sys.argv[2])
