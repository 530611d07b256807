"""Deliberately broken collectives — the verifier's mutation suite (the
counterpart of ``repro.analysis.fixtures``).

Each fixture is a ring collective over a
:class:`~repro_torch.analysis.collectives.RecordingRing` with exactly one
seeded defect, and the axis of :mod:`repro_torch.analysis.collectives` that
must fire on it:

  * ``broken-wrong-permutation`` — hops permute ``i -> i+2``: a bijection,
    but for even world sizes the "ring" splits into two disjoint cycles
    (**ring-topology**);
  * ``broken-mixed-direction`` — alternate hops reverse direction in a
    variant declared unidirectional: each perm is a valid cycle, but a
    chunk bounces between two workers (**ring-topology**, direction
    consistency; needs w >= 3, where forward and reverse differ);
  * ``broken-branch-nested`` — the first hop is issued only if rank 0's
    chunk sums above 0: ranks in separate processes whose data disagree
    would issue mismatched collective sequences and hang
    (**deadlock-order**, caught by the differential check);
  * ``broken-f32-payload-int8`` — a ring priced as the two-message int8
    layout that ships f32 payloads: the message count matches, the bytes
    are 4x (**pricing**);
  * ``broken-trailer-mismatch`` — a fused-layout ring whose trailer carries
    :data:`TRAILER_MISMATCH_SCALE_BYTES` bytes a sub-block instead of the
    f32 itemsize the bitcast needs (**pricing**; the kernel checker's
    must-reject suite seeds the same defect through
    :func:`trailer_mismatch_kernel_spec`);
  * ``broken-fp8-trailer-mismatch`` — the same short trailer on a ring
    priced as the fp8 wire, which shares int8's message layout
    (**pricing**);
  * ``broken-bucket-missing-segment`` — a pipeline declared
    ``n_buckets=3`` that rings only two of its three segments: the
    message count falls short (**pricing**);
  * ``broken-bucket-shared-chain`` — declared ``n_buckets=3`` but all
    buckets go through one ring: the bytes match the per-segment plan, only
    the per-message accounting catches it (**pricing**);
  * :func:`python_scalar_template` — a parameter template with a Python
    float leaf, which stands in for the reference's weak-typed leaf
    (**recompile-hazard**).

The CLI's self-test (run by default) records every broken variant and fails
if its axis stops firing.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.dist import collectives
from repro_torch.dist.collectives import LocalRing, _as_chunks, _ring_perm
from repro_torch.dist.compression import DEFAULT_BLOCK
from repro_torch.dist.overlap import even_bucket_sizes
from repro_torch.dist.registry import RingVariant
from repro_torch.kernels.quant_ring import hop_message_layout

__all__ = ["TRAILER_MISMATCH_SCALE_BYTES", "broken_ring_variants",
           "python_scalar_template", "trailer_mismatch_kernel_spec"]

_SOURCE = "src/repro_torch/analysis/fixtures.py"

# a trailer the wire accounting must reject: 2 bytes a sub-block scale, vs
# the 4-byte f32 itemsize the bitcast trailer needs. Shared by the
# collective verifier's broken-trailer rings and the kernel checker's
# must-reject spec, so both analyses catch the same defect class.
TRAILER_MISMATCH_SCALE_BYTES = 2

Ranks = List[torch.Tensor]


def _first_chunks(xs: Sequence[torch.Tensor], w: int) -> Ranks:
    """Each rank's first ring chunk: flat f32, zero-padded to ceil(n/w)."""
    return [_as_chunks(x.float(), w)[0][0].clone() for x in xs]


def _wrong_permutation(ring: LocalRing):
    def run(xs: Ranks) -> Ranks:
        w = ring.size
        chunks = _first_chunks(xs, w)
        perm = [(i, (i + 2) % w) for i in range(w)]  # skips every other rank
        for _ in range(2 * (w - 1)):
            chunks = ring.permute(chunks, perm)
        return list(xs)
    return run


def _mixed_direction(ring: LocalRing):
    def run(xs: Ranks) -> Ranks:
        w = ring.size
        chunks = _first_chunks(xs, w)
        for s in range(2 * (w - 1)):
            chunks = ring.permute(chunks, _ring_perm(w, reverse=s % 2 == 1))
        return list(xs)
    return run


def _branch_nested(ring: LocalRing):
    def run(xs: Ranks) -> Ranks:
        w = ring.size
        chunks = _first_chunks(xs, w)
        perm = _ring_perm(w)
        # a data-dependent predicate: ranks in separate processes, each
        # deciding on its own data, may disagree and issue mismatched hops
        if float(chunks[0].sum()) > 0:
            chunks = ring.permute(chunks, perm)
        for _ in range(2 * (w - 1) - 1):
            chunks = ring.permute(chunks, perm)
        return list(xs)
    return run


def _f32_payload_int8(ring: LocalRing):
    def run(xs: Ranks) -> Ranks:
        w = ring.size
        chunks = _first_chunks(xs, w)        # f32: 4x the priced payload
        scales = [c[0].clone() for c in chunks]
        perm = _ring_perm(w)
        for _ in range(2 * (w - 1)):         # the right count: 2 a hop
            chunks = ring.permute(chunks, perm)
            scales = ring.permute(scales, perm)
        return list(xs)
    return run


def _trailer_mismatch(ring: LocalRing):
    def run(xs: Ranks) -> Ranks:
        w = ring.size
        layout = hop_message_layout(-(-xs[0].numel() // w), block=DEFAULT_BLOCK)
        msgs = []
        for x in xs:
            payload = torch.zeros(layout.payload_bytes, dtype=torch.int8,
                                  device=x.device)
            trailer = torch.zeros(layout.n_blocks * TRAILER_MISMATCH_SCALE_BYTES,
                                  dtype=torch.int8, device=x.device)
            msgs.append(torch.cat([payload, trailer]))  # 2 B short a block
        perm = _ring_perm(w)
        for _ in range(2 * (w - 1)):
            msgs = ring.permute(msgs, perm)
        return list(xs)
    return run


def _bucket_missing_segment(ring: LocalRing):
    def run(xs: Ranks) -> Ranks:
        flats = [x.reshape(-1) for x in xs]
        segs = even_bucket_sizes(flats[0].numel(), 3)
        parts: List[Ranks] = [[] for _ in xs]
        off = 0
        for k, seg in enumerate(segs):
            part = [f[off: off + seg] for f in flats]
            if k < len(segs) - 1:   # the last segment never rings
                part = collectives.ring_all_reduce(part, ring)
            for r, t in enumerate(part):
                parts[r].append(t)
            off += seg
        return [torch.cat(p).reshape(x.shape) for p, x in zip(parts, xs)]
    return run


def _bucket_shared_chain(ring: LocalRing):
    def run(xs: Ranks) -> Ranks:
        # one ring where three per-bucket chains are declared: the same
        # padded elements overall, so the same bytes, but one chain's
        # 2(w-1) messages stand in for the priced 3 x 2(w-1)
        return collectives.ring_all_reduce(list(xs), ring)
    return run


def broken_ring_variants() -> List[Tuple[RingVariant, str]]:
    """(variant, check axis that must fire) — the seeded mutation suite."""
    return [
        (RingVariant(name="broken-wrong-permutation",
                     build=_wrong_permutation, source=_SOURCE),
         "ring-topology"),
        (RingVariant(name="broken-mixed-direction",
                     build=_mixed_direction, source=_SOURCE),
         "ring-topology"),
        (RingVariant(name="broken-branch-nested",
                     build=_branch_nested, source=_SOURCE),
         "deadlock-order"),
        (RingVariant(name="broken-f32-payload-int8",
                     build=_f32_payload_int8, compression="int8",
                     source=_SOURCE),
         "pricing"),
        (RingVariant(name="broken-trailer-mismatch",
                     build=_trailer_mismatch, compression="int8-fused",
                     source=_SOURCE),
         "pricing"),
        (RingVariant(name="broken-fp8-trailer-mismatch",
                     build=_trailer_mismatch, compression="fp8-fused",
                     source=_SOURCE),
         "pricing"),
        (RingVariant(name="broken-bucket-missing-segment",
                     build=_bucket_missing_segment, n_buckets=3,
                     source=_SOURCE),
         "pricing"),
        (RingVariant(name="broken-bucket-shared-chain",
                     build=_bucket_shared_chain, n_buckets=3,
                     source=_SOURCE),
         "pricing"),
    ]


def python_scalar_template() -> dict:
    """A params template with a Python float leaf (a recompile hazard: the
    counterpart of the reference's weak-typed scalar)."""
    return {"w": torch.zeros((4, 4), dtype=torch.float32), "lr_scale": 1.0}


def trailer_mismatch_kernel_spec():
    """The kernel checker's must-reject spec for the shared trailer defect."""
    from repro_torch.analysis.kernels import KernelSpec

    return KernelSpec(64, 4096, scale_bytes=TRAILER_MISMATCH_SCALE_BYTES)
