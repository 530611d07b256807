"""Analytical model for ring-all-reduce (RAR) DDL training — paper §III
(the counterpart of ``repro.core.rar_model``, in numpy).

Implements Eq. (1): the per-iteration training time of a w-worker RAR job,

    tau(w) = d(w-1)/w * (2/b + 1/G) + t_f * M + t_b + gamma

and its inverse (iterations per unit time), which instantiates the
"excessive training avoidance" per-worker efficiency ``zeta_i`` of §IV.
All quantities use SI base units: d in parameters (grad elements), b in
elements/second (bandwidth divided by element width), G in elements/second
reduction throughput, times in seconds.

The functions take plain floats *and* arrays. A scalar worker count gives
the same Python float as the reference; an array of worker counts is
computed in float32, as the reference's ``jnp`` path is, and gives the same
array bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np

Array = Union[float, np.ndarray]


@dataclasses.dataclass(frozen=True)
class RarJobProfile:
    """Static profile of one RAR training job (inputs to Eq. (1)).

    Attributes:
      d: model/gradient size in elements (the paper's ``d``).
      bandwidth: per-link worker<->worker bandwidth in elements/sec (``b``).
      reduce_speed: per-worker reduction throughput in elements/sec (``G``).
      t_fwd_per_sample: per-sample forward time ``t^f`` (seconds).
      t_bwd: backward time ``t^b`` (seconds; batch-independent per paper).
      batch_size: mini-batch size ``M``.
      overhead: per-iteration negotiation/ACK latency ``gamma`` (seconds).
      compression: ring wire layout — ``None`` (f32 ring), ``"int8"`` (XLA
        compressed ring: two ppermutes per hop) or one of the
        single-ppermute fused pipelines (``"int8-fused"``, ``"fp8-fused"``
        — e4m3 payload + per-block scales, ``"bf16-fused"`` — trailer-free
        2-byte payload). Changes Eq. (1)'s wire term to the compressed byte
        count, so the scheduler prices what the ring actually sends
        (``repro_torch.dist.compression`` layouts).
      message_overhead: optional per-ppermute latency slice of gamma
        (seconds/message), priced uniformly across layouts via
        :func:`rar_ring_messages` — one message per hop for the f32 and
        fused rings, two for the XLA int8 layout.
      overlap_hidden_fraction: fraction h in [0, 1] of the collective term
        hidden behind the backward pass by per-bucket overlapped rings (the
        ``"compressed-fused-overlap"`` step mode); Eq. (1) prices only the
        exposed ``(1 - h) * comm``. 0 (default) is the fully-serial ring,
        bit-identical to the pre-overlap pricing.
    """

    d: float
    bandwidth: float
    reduce_speed: float
    t_fwd_per_sample: float
    t_bwd: float
    batch_size: float
    overhead: float = 0.0
    compression: Optional[str] = None
    message_overhead: float = 0.0
    overlap_hidden_fraction: float = 0.0

    def iteration_time(self, w: Array) -> Array:
        return rar_iteration_time(
            w,
            d=self.d,
            bandwidth=self.bandwidth,
            reduce_speed=self.reduce_speed,
            t_fwd_per_sample=self.t_fwd_per_sample,
            t_bwd=self.t_bwd,
            batch_size=self.batch_size,
            overhead=self.overhead,
            compression=self.compression,
            message_overhead=self.message_overhead,
            overlap_hidden_fraction=self.overlap_hidden_fraction,
        )

    def iterations_per_slot(self, w: Array, slot_seconds: float) -> Array:
        """zeta_i: training iterations per time slot per Eq. (1) inverted."""
        return slot_seconds / self.iteration_time(w)


def rar_ring_bytes_per_worker(d: float, w: Array, elem_bytes: int = 4) -> Array:
    """Total wire bytes each worker sends in one all-reduce: 2d(w-1)/w."""
    if isinstance(w, (int, float)):
        return 2.0 * d * (w - 1.0) / max(w, 1.0) * elem_bytes
    w = np.asarray(w, dtype=np.float32)
    return 2.0 * d * (w - 1.0) / np.maximum(w, 1.0) * elem_bytes


def rar_allreduce_time(w: Array, d: float, bandwidth: float, reduce_speed: float) -> Array:
    """Time of one RAR collective: d(w-1)/w * (2/b + 1/G) — paper §III-3.

    Share-Reduce phase: (w-1) steps, each sends d/w and reduces d/w.
    Share-Only phase:   (w-1) steps, each sends d/w.
    """
    if isinstance(w, (int, float)):
        if w <= 1:
            return 0.0
        return d * (w - 1.0) / w * (2.0 / bandwidth + 1.0 / reduce_speed)
    w = np.asarray(w, dtype=np.float32)
    t = d * (w - 1.0) / np.maximum(w, 1.0) * (2.0 / bandwidth + 1.0 / reduce_speed)
    return np.where(w <= 1.0, 0.0, t)


def rar_compressed_bytes_per_worker(d: float, w: Array, *,
                                    fused: bool = False, block: int = 4096,
                                    scale_bytes: int = 4,
                                    payload_elem_bytes: int = 1,
                                    trailer: bool = True) -> Array:
    """Per-worker wire bytes of one compressed ring all-reduce.

    XLA layout (``fused=False``): 2(w-1) hops of a ceil(d/w)-byte int8
    payload plus a separate f32 scale message. Fused single-ppermute layout:
    2(w-1) hops of one packed message — the payload block-padded to whole
    ``block`` sub-blocks at ``payload_elem_bytes`` per element (1 for
    int8/fp8, 2 for bf16) plus, when ``trailer`` (the scaled formats), one
    f32 scale per sub-block in the trailer; the bf16 wire carries no scales.
    Must agree with ``repro_torch.dist.compression.compressed_wire_bytes``
    / ``fused_wire_bytes`` and with what ``LocalRing`` counts — the
    scheduler's cost model and the executable layer share the formula.
    """
    trailer_bytes = float(scale_bytes) if trailer else 0.0
    if isinstance(w, (int, float)):
        if w <= 1:
            return 0.0
        c = -(-int(d) // int(w))
        if fused:
            b = max(1, min(int(block), c))
            c_pad = -(-c // b) * b
            return 2.0 * (w - 1.0) * (float(payload_elem_bytes) * c_pad
                                      + trailer_bytes * (c_pad // b))
        return 2.0 * (w - 1.0) * (float(c) + float(scale_bytes))
    w = np.asarray(w, dtype=np.float32)
    c = np.ceil(d / np.maximum(w, 1.0))
    if fused:
        b = np.maximum(1.0, np.minimum(float(block), c))
        c_pad = np.ceil(c / b) * b
        per_hop = (float(payload_elem_bytes) * c_pad
                   + trailer_bytes * (c_pad / b))
    else:
        per_hop = c + float(scale_bytes)
    return np.where(w <= 1.0, 0.0, 2.0 * (w - 1.0) * per_hop)


def compressed_ring_messages(w: Array, *, fused: bool = False) -> Array:
    """ppermute messages per compressed all-reduce: the XLA layout pays the
    per-message latency twice per hop (payload + scale), the fused layout
    once — 4(w-1) vs 2(w-1). Mirrors
    ``repro_torch.dist.compression.compressed_ring_ppermutes``."""
    per_hop = 1 if fused else 2
    if isinstance(w, (int, float)):
        return 0 if w <= 1 else 2 * per_hop * (int(w) - 1)
    w = np.asarray(w, dtype=np.float32)
    return np.where(w <= 1.0, 0.0, 2.0 * per_hop * (w - 1.0))


def rar_ring_messages(w: Array, *, compression: Optional[str] = None) -> Array:
    """Wire messages per all-reduce for any layout: the f32 ring and the
    fused int8 ring both send one message per hop (2(w-1)); the XLA int8
    layout sends two (payload + scale, 4(w-1)). This is what a nonzero
    per-message ``message_overhead`` multiplies in :func:`rar_iteration_time`
    — priced uniformly so compressed layouts are not penalized against the
    f32 ring, and the fused layout's halved gamma is visible against
    ``"int8"``."""
    return compressed_ring_messages(w, fused=compression != "int8")


WIRE_COMPRESSIONS = (None, "int8", "int8-fused", "bf16-fused", "fp8-fused")

# fused wire layouts: compression -> (payload bytes/element, f32 trailer?).
# int8 and fp8 both ship 1-byte payloads plus one bitcast f32 scale per
# sub-block; bf16 ships a bare 2-byte payload (no scales to carry).
_FUSED_WIRE_LAYOUTS = {
    "int8-fused": (1, True),
    "fp8-fused": (1, True),
    "bf16-fused": (2, False),
}


@dataclasses.dataclass(frozen=True)
class WireFormula:
    """The Eq. (1) wire accounting of one ring layout, looked up by config.

    ``messages(w)`` is the ppermute count one full all-reduce issues per
    worker (what a per-message gamma multiplies); ``bytes_per_worker(d, w)``
    the total wire bytes it sends. ``executed=True`` (the default) prices
    the chunks the ring actually puts on the wire — for the f32 ring that
    means the zero-padded ``ceil(d/w)`` chunk, so the result matches the
    bytes a ring sends *exactly*; ``executed=False`` is the paper's continuous
    ``2 d (w-1)/w`` form used inside Eq. (1). The compressed layouts price
    padding in both cases (their formulas are defined on the executed
    layout). ``repro_torch.dist.registry`` holds ``LocalRing``'s counts of
    messages and bytes against this lookup.
    """

    compression: Optional[str]  # one of WIRE_COMPRESSIONS
    elem_bytes: int = 4
    block: int = 4096
    scale_bytes: int = 4

    def messages(self, w: int) -> int:
        if w <= 1:
            return 0
        return int(rar_ring_messages(w, compression=self.compression))

    def bytes_per_worker(self, d: int, w: int, *,
                         executed: bool = True) -> float:
        if w <= 1:
            return 0.0
        if self.compression is None:
            d_wire = (-(-int(d) // w)) * w if executed else d
            return float(rar_ring_bytes_per_worker(
                d_wire, w, elem_bytes=self.elem_bytes))
        if self.compression == "int8":
            return float(rar_compressed_bytes_per_worker(
                d, w, fused=False,
                block=self.block, scale_bytes=self.scale_bytes))
        payload_bytes, trailer = _FUSED_WIRE_LAYOUTS[self.compression]
        return float(rar_compressed_bytes_per_worker(
            d, w, fused=True, block=self.block,
            scale_bytes=self.scale_bytes,
            payload_elem_bytes=payload_bytes, trailer=trailer))


def wire_formula(compression: Optional[str], *, elem_bytes: int = 4,
                 block: int = 4096, scale_bytes: int = 4) -> WireFormula:
    """Wire-cost formulas for a profile's ``compression`` config.

    Raises on unknown layouts so a new wire format cannot silently fall
    back to f32 pricing — it must be added here *and* to the verifier's
    registry before the scheduler will price it.
    """
    if compression not in WIRE_COMPRESSIONS:
        raise ValueError(
            f"unknown compression {compression!r}; known wire layouts: "
            f"{WIRE_COMPRESSIONS}")
    return WireFormula(compression=compression, elem_bytes=elem_bytes,
                       block=block, scale_bytes=scale_bytes)


def compressed_rar_allreduce_time(
    w: Array, d: float, bandwidth: float, reduce_speed: float, *,
    elem_bytes: int = 4, fused: bool = False, block: int = 4096,
    scale_bytes: int = 4, message_overhead: float = 0.0,
    payload_elem_bytes: int = 1, trailer: bool = True,
) -> Array:
    """Eq. (1)'s collective term re-priced for a compressed ring.

    Wire time = compressed bytes over the link's byte rate
    (``bandwidth * elem_bytes`` — profiles carry b in f32 elements/sec);
    reduction still touches d(w-1)/w elements; ``message_overhead`` is the
    per-ppermute latency slice of gamma, paid once per message — the fused
    single-ppermute hop halves it relative to the two-message XLA layout.
    ``payload_elem_bytes``/``trailer`` select the fused payload layout
    (int8/fp8 vs the trailer-free bf16 wire).
    """
    wire_bytes = rar_compressed_bytes_per_worker(
        d, w, fused=fused, block=block, scale_bytes=scale_bytes,
        payload_elem_bytes=payload_elem_bytes, trailer=trailer)
    byte_rate = bandwidth * float(elem_bytes)
    messages = compressed_ring_messages(w, fused=fused)
    if isinstance(w, (int, float)):
        if w <= 1:
            return 0.0
        return (wire_bytes / byte_rate
                + d * (w - 1.0) / w / reduce_speed
                + messages * message_overhead)
    w = np.asarray(w, dtype=np.float32)
    t = (wire_bytes / byte_rate
         + d * (w - 1.0) / np.maximum(w, 1.0) / reduce_speed
         + messages * message_overhead)
    return np.where(w <= 1.0, 0.0, t)


def rar_iteration_time(
    w: Array,
    *,
    d: float,
    bandwidth: float,
    reduce_speed: float,
    t_fwd_per_sample: float,
    t_bwd: float,
    batch_size: float,
    overhead: float = 0.0,
    compression: Optional[str] = None,
    message_overhead: float = 0.0,
    overlap_hidden_fraction: float = 0.0,
) -> Array:
    """Eq. (1): per-iteration RAR training time.

    ``w`` may be a scalar or an array of candidate worker counts; w <= 1
    degenerates to compute-only time (no ring traffic), matching the paper's
    single-worker case. ``compression`` switches the collective term to the
    compressed ring's byte count (``"int8"`` — the two-ppermute XLA layout;
    ``"int8-fused"``/``"fp8-fused"``/``"bf16-fused"`` — the single-ppermute
    fused layouts). A nonzero ``message_overhead`` prices the per-ppermute
    latency slice of gamma uniformly across layouts
    (:func:`rar_ring_messages`): the f32 and fused rings pay it 2(w-1)
    times, the XLA int8 layout 4(w-1).

    ``overlap_hidden_fraction`` (h in [0, 1]) models per-bucket rings
    launched while the backward pass is still producing gradients (the
    ``"compressed-fused-overlap"`` train-step mode): a fraction h of the
    collective term runs concurrently with compute, so only the *exposed*
    ``(1 - h) * comm`` is priced. h = 0 is today's fully-serial Eq. (1),
    bit-identical; h = 1 is fully compute-hidden communication.
    """
    if not 0.0 <= overlap_hidden_fraction <= 1.0:
        raise ValueError("overlap_hidden_fraction must be in [0, 1], got "
                         f"{overlap_hidden_fraction!r}")
    if compression is None:
        comm = rar_allreduce_time(w, d, bandwidth, reduce_speed)
    elif compression == "int8":
        comm = compressed_rar_allreduce_time(
            w, d, bandwidth, reduce_speed, fused=False)
    elif compression in _FUSED_WIRE_LAYOUTS:
        payload_bytes, trailer = _FUSED_WIRE_LAYOUTS[compression]
        comm = compressed_rar_allreduce_time(
            w, d, bandwidth, reduce_speed, fused=True,
            payload_elem_bytes=payload_bytes, trailer=trailer)
    else:
        raise ValueError(f"unknown compression {compression!r}; "
                         f"expected one of {WIRE_COMPRESSIONS}")
    if message_overhead:
        comm = comm + rar_ring_messages(
            w, compression=compression) * message_overhead
    if overlap_hidden_fraction:
        comm = comm * (1.0 - overlap_hidden_fraction)
    compute = t_fwd_per_sample * batch_size + t_bwd
    return comm + compute + overhead


def rar_iteration_time_asymptote(
    *,
    d: float,
    bandwidth: float,
    reduce_speed: float,
    t_fwd_per_sample: float,
    t_bwd: float,
    batch_size: float,
    overhead: float = 0.0,
) -> float:
    """The w->inf upper bound: d(2/b + 1/G) + t_f M + t_b + gamma."""
    return (
        d * (2.0 / bandwidth + 1.0 / reduce_speed)
        + t_fwd_per_sample * batch_size
        + t_bwd
        + overhead
    )


def effective_iteration_time(profile: "RarJobProfile", effective_bw: float,
                             w: Array, *,
                             overlap_hidden_fraction: Optional[float] = None,
                             ) -> Array:
    """Eq. (1) re-priced with a *contended* per-hop bandwidth.

    ``effective_bw`` is the fair-share bottleneck bandwidth the ring actually
    sees this slot (elements/sec, same units as ``profile.bandwidth``) — e.g.
    ``ResourceState.effective_bandwidth`` scaled into element units. All other
    Eq. (1) terms — including the profile's compressed wire layout — are
    unchanged. ``overlap_hidden_fraction`` overrides the profile's overlap
    term (``None`` keeps it): G-VNE contention discounts thereby price only
    the *exposed* fraction of the ring — comm a bucketed overlapped step
    hides behind the backward pass neither costs iteration time nor
    (proportionally) competes for the contended link during the exposed
    window. Passing ``0`` prices the fully-serial ring, bit-identical to the
    pre-overlap behavior.
    """
    if effective_bw <= 0.0:
        return float("inf")
    h = (profile.overlap_hidden_fraction
         if overlap_hidden_fraction is None else overlap_hidden_fraction)
    return rar_iteration_time(
        w,
        d=profile.d,
        bandwidth=effective_bw,
        reduce_speed=profile.reduce_speed,
        t_fwd_per_sample=profile.t_fwd_per_sample,
        t_bwd=profile.t_bwd,
        batch_size=profile.batch_size,
        overhead=profile.overhead,
        compression=profile.compression,
        message_overhead=profile.message_overhead,
        overlap_hidden_fraction=h,
    )


def contention_progress_factor(profile: "RarJobProfile", w: int,
                               effective_bw: float) -> float:
    """Per-slot progress scale under contention: tau(b_i) / tau(b_eff) in (0, 1].

    A synchronous ring whose links are fair-shared completes iterations at the
    contended rate 1/tau(b_eff); relative to the isolated-ring pricing the
    slot therefore delivers tau(b_i)/tau(b_eff) of the nominal progress.
    Degenerate rings (w <= 1, no ring traffic) are unaffected.
    """
    if w <= 1 or effective_bw >= profile.bandwidth:
        return 1.0
    if effective_bw <= 0.0:
        return 0.0
    nominal = float(profile.iteration_time(w))
    contended = float(effective_iteration_time(profile, effective_bw, w))
    return nominal / contended if contended > 0 else 0.0


def ps_worker_bytes(d: float, w: int, elem_bytes: int = 4) -> float:
    """PS-worker architecture per-iteration data exchange: 2wd (paper §III-2).

    Kept as the scalability comparison baseline (RAR's motivating contrast).
    """
    return 2.0 * w * d * elem_bytes


def effective_zeta(profile: RarJobProfile, w: int, slot_seconds: float) -> float:
    """Per-worker-time efficiency used by the DDLJS objective.

    The paper's excessive-training-avoidance instantiation: zeta_i is the
    number of iterations per unit worker-time. We normalize per-slot so the
    utility argument ``zeta_i * sum_t sum_s y_is[t]`` counts iterations
    accumulated across the schedule.
    """
    if w <= 0:
        return 0.0
    return float(profile.iterations_per_slot(w, slot_seconds)) / float(w)


def profile_from_arch(
    *,
    n_params: float,
    tokens_per_batch: float,
    chip_flops: float = 197e12,
    chip_hbm_bw: float = 819e9,
    link_bandwidth_bytes: float = 50e9,
    grad_elem_bytes: int = 4,
    overhead: float = 5e-3,
    compression: Optional[str] = None,
    message_overhead: float = 0.0,
    overlap_hidden_fraction: float = 0.0,
) -> RarJobProfile:
    """Derive an Eq.-(1) profile from a real architecture config.

    The same derivation as the reference's:
      - d          = n_params (gradient elements)
      - b          = ICI/NIC link bandwidth in elements/sec
      - G          = reduction throughput: HBM-bound 2-read-1-write streams
      - t_f, t_b   = 2ND and 4ND FLOPs over chip peak (fwd:bwd = 1:2)

    ``compression`` (one of :data:`WIRE_COMPRESSIONS`) selects the wire
    layout the job's ring actually uses, so Eq. (1) prices the compressed
    bytes; ``message_overhead`` (seconds/ppermute, a few microseconds for an
    ICI launch+ACK) is priced uniformly across layouts via
    :func:`rar_ring_messages`, which is where the fused layouts' halved
    per-hop gamma becomes visible to the scheduler;
    ``overlap_hidden_fraction`` is the bucketed-overlap discount (only the
    exposed ``(1-h)`` slice of the collective term is priced).
    """
    flops_fwd = 2.0 * n_params * tokens_per_batch
    t_f_total = flops_fwd / chip_flops
    t_f_per_sample = t_f_total / max(tokens_per_batch, 1.0)
    t_b = 2.0 * flops_fwd / chip_flops
    b_elems = link_bandwidth_bytes / grad_elem_bytes
    g_elems = chip_hbm_bw / (3.0 * grad_elem_bytes)  # 2 reads + 1 write per add
    return RarJobProfile(
        d=float(n_params),
        bandwidth=b_elems,
        reduce_speed=g_elems,
        t_fwd_per_sample=t_f_per_sample,
        t_bwd=t_b,
        batch_size=tokens_per_batch,
        overhead=overhead,
        compression=compression,
        message_overhead=message_overhead,
        overlap_hidden_fraction=overlap_hidden_fraction,
    )


def optimal_worker_count(profile: RarJobProfile, w_max: int, slot_seconds: float = 1.0) -> int:
    """Worker count maximizing total iterations/sec across the ring.

    Eq. (1) throughput w/tau(w) is unimodal in w for fixed M; we just argmax
    over the (small) feasible range — this is the per-job planning primitive
    the scheduler exposes to users.
    """
    best_w, best_rate = 1, -math.inf
    for w in range(1, max(1, w_max) + 1):
        rate = w / float(profile.iteration_time(w))
        if rate > best_rate:
            best_w, best_rate = w, rate
    return best_w
