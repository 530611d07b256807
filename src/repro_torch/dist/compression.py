"""Gradient compression for the ring: quantized and bf16 wires, and error
feedback (the counterpart of ``repro.dist.compression``).

Two int8 executions, selected by ``fused=`` as in the reference:

**The unfused path** (``fused=False``, the reference's XLA path): one
whole-tensor amax scale per message (:func:`quantize`), and each hop sends
two messages, the int8 payload and its f32 scale: ``4(w-1)`` messages per
all-reduce. It is plain torch, as the reference's is plain ``jnp``.

**The fused path** (``fused=True``): each hop's wire message is ONE int8
buffer::

    [ 1-byte payload: n_blocks * block ][ trailer: n_blocks f32 scales,
                                          bitcast to 4 int8 bytes each ]

so a hop pays the per-message latency once, 2(w-1) messages per
all-reduce. The schedule is the reference's ``_fused_ring_all_reduce``:

  * Share-Reduce: rank i quantizes its own chunk i and sends it; each hop
    dequantizes the received message, adds the local chunk and
    requantizes for the next hop in one kernel (``dequant_add_quantize``);
    the last hop's ``dequant_accumulate`` leaves rank i the f32 sum of
    chunk (i + 1) mod w;
  * Share-Only: rank i quantizes its reduced chunk once and every hop
    forwards the received message verbatim; at the end each rank
    dequantizes all w messages in one ``dequant_gather``, so every rank
    ends with bit-identical values.

Each message is written once, by the kernel that makes it, into the buffer
that crosses the wire, and read where it landed: the quantizing kernels
write the payload and the scales into the message (the scales as an f32
view of the trailer where it starts on 4 bytes, else beside it, copied in);
a rank's Share-Only messages land in the rows of one gather buffer, which
``dequant_gather`` reads in place and writes in chunk order.

The fused payload is int8 or fp8 e4m3 (bitcast to int8 bytes on the wire,
the same message size); :func:`fused_wire_all_reduce` also runs the bf16
wire, whose message is the bare 2-byte payload with no trailer.
:func:`ef_compressed_all_reduce` adds error feedback: the tensor is
quantized once on the send side and the ring's first Share-Reduce hop
forwards that payload verbatim. The kernels are
``repro_torch.kernels.quant_ring``'s.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.dist.collectives import (
    LocalRing,
    _all_gather_chunks,
    _as_chunks,
    _check_ranks,
)
from repro_torch.kernels.quant_ring import (
    FP8_DTYPE,
    SCALE_BYTES,
    bf16_accumulate,
    bf16_add_cast,
    cast_pack_bf16,
    dequant_accumulate,
    dequant_add_quantize,
    dequant_gather,
    hop_message_layout,
    quantize_pack,
)
from repro_torch.spans import span

QMAX = 127.0  # symmetric int8 range

# default sub-block size of the fused path: the per-block f32 scale costs
# 4/block of the payload on the wire (0.1% at 4096)
DEFAULT_BLOCK = 4096


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with one whole-tensor scale: (flat int8
    values, 0-dim f32 scale), ``scale = max|x| / 127``."""
    flat = x.reshape(-1).float()
    amax = flat.abs().amax()
    # divide by a tensor, never a Python scalar (see quantize_pack_plain)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, QMAX),
                        torch.ones_like(amax))
    q = torch.round(flat / scale).clamp_(-QMAX, QMAX).to(torch.int8)
    return q, scale


def dequantize(qx: Tuple[torch.Tensor, torch.Tensor], size: int,
               shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`quantize`; size/shape restore the original layout."""
    q, scale = qx
    return (q.float() * scale)[:size].reshape(shape)


def quantization_error(x: torch.Tensor) -> torch.Tensor:
    """Residual x - Q(x) — the quantity error feedback carries forward."""
    return x.float() - dequantize(quantize(x), x.numel(), x.shape)


# ---------------------------------------------------------------------------
# fused single-message wire format: payload ++ bitcast scale trailer
# ---------------------------------------------------------------------------

def pack_hop_message(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Pack a ``(n_blocks, block)`` payload (int8, or fp8 as its bytes) and
    its ``(n_blocks,)`` f32 scales into one int8 wire buffer: payload
    first, then each scale as its 4 little-endian bytes."""
    return torch.cat([q.reshape(-1).view(torch.int8),
                      scales.contiguous().view(torch.int8)])


def unpack_hop_message(msg: torch.Tensor, n_blocks: int, block: int,
                       wire_dtype=torch.int8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_hop_message` for a given payload dtype;
    mirrors the reference's ``compression.unpack_hop_message``. The payload
    is a view of ``msg``; the trailer is copied, since it starts at
    ``n_blocks * block``, which need not be a multiple of 4 bytes."""
    n = n_blocks * block
    q = msg[:n].view(n_blocks, block).view(wire_dtype)
    scales = msg[n:].clone().view(torch.float32)
    return q, scales


def _message_parts(msgs: torch.Tensor, n_blocks: int, block: int,
                   wire_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(payload, scales) of wire messages, each along the last dim, where
    they lie: the payload ``(..., n_blocks, block)`` a view, the scales
    ``(..., n_blocks)`` a view of the trailer where it starts on 4 bytes,
    else a copy."""
    n = n_blocks * block
    q = msgs[..., :n].unflatten(-1, (n_blocks, block)).view(wire_dtype)
    trailer = msgs[..., n:]
    if n % SCALE_BYTES:
        trailer = trailer.clone(memory_format=torch.contiguous_format)
    return q, trailer.view(torch.float32)


def _write_message(msg: torch.Tensor, make: Callable, n_blocks: int,
                   block: int, wire_dtype) -> torch.Tensor:
    """``msg`` filled by ``make(out=(payload, scales))``, the kernel that
    makes the message: the payload written where it lies, the scales too
    where the trailer starts on 4 bytes, else beside it and copied in."""
    n = n_blocks * block
    q = msg[:n].view(n_blocks, block).view(wire_dtype)
    if n % SCALE_BYTES == 0:
        make(out=(q, msg[n:].view(torch.float32)))
    else:
        _, scales = make(out=(q, msg.new_empty(n_blocks, dtype=torch.float32)))
        msg[n:].copy_(scales.view(torch.int8))
    return msg


def _fused_chunk_layout(n: int, w: int, block: int) -> Tuple[int, int, int]:
    """(chunk elements, sub-blocks per chunk, total pad) for a flat size n.

    Chunks are padded so each splits into whole ``block``-sized sub-blocks;
    the effective block never exceeds the chunk itself. Derived from
    :func:`repro_torch.kernels.quant_ring.hop_message_layout` so the ring
    and the kernel layout cannot disagree on the wire format.
    """
    c = -(-n // max(w, 1))                 # ceil(n / w)
    layout = hop_message_layout(c, block=block)
    c_pad = layout.n_blocks * layout.block
    return c_pad, layout.n_blocks, w * c_pad - n


def _padded_blocks(x: torch.Tensor, pad: int, rows: int) -> torch.Tensor:
    """``x`` flat in f32, zero-padded by ``pad``, as ``rows`` rows."""
    flat = x.reshape(-1).float()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(rows, -1)


def _unpad(flat: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return flat.reshape(-1)[:like.numel()].reshape(like.shape).to(like.dtype)


# ---------------------------------------------------------------------------
# the compressed ring collectives
# ---------------------------------------------------------------------------

def compressed_ring_all_reduce(xs: Sequence[torch.Tensor], ring: LocalRing, *,
                               fused: bool = False,
                               block: int = DEFAULT_BLOCK) -> List[torch.Tensor]:
    """Ring all-reduce with int8-quantized hop payloads. ``xs[r]`` is rank
    r's tensor; returns every rank's (bit-identical) sum. A one-rank ring
    returns its input unquantized, as the reference does. ``fused=False``
    is the two-message path with whole-tensor scales, ``fused=True`` the
    fused ring with per-``block`` scales."""
    _check_ranks(xs, ring)
    if ring.size == 1:
        return list(xs)
    if fused:
        return _fused_ring_all_reduce(xs, ring, block=block)
    return _xla_ring_all_reduce(xs, ring)


def _xla_ring_all_reduce(xs: Sequence[torch.Tensor], ring: LocalRing,
                         first_hop: Optional[Sequence[Tuple[torch.Tensor,
                                                            torch.Tensor]]] = None,
                         ) -> List[torch.Tensor]:
    """The unfused path: two messages per hop (int8 payload, f32 scale).

    ``first_hop[r] = (q_chunks, scale)`` lets error feedback forward rank
    r's already-quantized payload on the first Share-Reduce hop
    (``q_chunks`` the (w, chunk) int8 mirror of the input's chunk layout,
    ``scale`` its whole-tensor scale) instead of re-quantizing.
    """
    w = ring.size
    chunks = [_as_chunks(x.float(), w)[0] for x in xs]

    # Share-Reduce: quantize each hop's partial sum before sending
    for s in range(w - 1):
        sends = []
        for i in range(w):
            if s == 0 and first_hop is not None:
                sends.append((first_hop[i][0][i], first_hop[i][1]))
            else:
                sends.append(quantize(chunks[i][(i - s) % w]))
        q_recv = ring.hop([q for q, _ in sends])
        s_recv = ring.hop([sc for _, sc in sends])
        for i in range(w):
            chunks[i][(i - s - 1) % w] += q_recv[i].float() * s_recv[i]

    # Share-Only: quantize the owned reduced chunk once, forward int8 and
    # scale verbatim (each chunk pays exactly one gather-phase quantization)
    qchunks, scales = [], []
    for i in range(w):
        own = (i + 1) % w
        q_own, s_own = quantize(chunks[i][own])
        qc = torch.zeros(chunks[i].shape, dtype=torch.int8, device=q_own.device)
        qc[own] = q_own
        sc = torch.zeros((w, 1), dtype=torch.float32, device=q_own.device)
        sc[own] = s_own
        qchunks.append(qc)
        scales.append(sc)
    _all_gather_chunks(qchunks, ring)
    _all_gather_chunks(scales, ring)
    return [_unpad(qc.float() * sc, x) for qc, sc, x in zip(qchunks, scales, xs)]


def _fused_ring_all_reduce(xs: Sequence[torch.Tensor], ring: LocalRing, *,
                           block: int, wire_dtype=torch.int8,
                           first_hop: Optional[Sequence[torch.Tensor]] = None,
                           ) -> List[torch.Tensor]:
    """The fused ring: one packed message per hop, each written by the
    kernel that makes it into the buffer that crosses the wire.

    ``wire_dtype`` is the payload (int8 or float8_e4m3fn, both one byte per
    element and the same message layout). ``first_hop[r]`` is an optional
    pre-packed message for rank r's first Share-Reduce send (error
    feedback's already-quantized chunk). Under a profiler the taking of the
    chunks and the gather buffers is the span ``fused.layout``, with the
    bytes of the call's messages that their kernels wrote where they cross
    the wire and the bytes that went through a copy (error feedback's
    packed first hops, and the scales where a trailer is off 4 bytes), each
    summed over the ranks.
    """
    w = ring.size
    n = xs[0].numel()
    c_pad, nb, pad = _fused_chunk_layout(n, w, block)
    b = c_pad // nb
    msg_bytes = nb * (b + SCALE_BYTES)
    made = w * w if first_hop is None else w * (w - 1)
    trailer_copied = nb * SCALE_BYTES if (nb * b) % SCALE_BYTES else 0
    with span("fused.layout", made * (msg_bytes - trailer_copied),
              made * trailer_copied + (w * w - made) * msg_bytes):
        chunks = [_padded_blocks(x, pad, w * nb).view(w, nb, b) for x in xs]
        # rank i's Share-Only messages: row 0 its own, row s+1 hop s's
        gathers = [torch.empty((w, msg_bytes), dtype=torch.int8, device=x.device)
                   for x in xs]

    def message(i: int, make: Callable) -> torch.Tensor:
        msg = torch.empty(msg_bytes, dtype=torch.int8, device=xs[i].device)
        return _write_message(msg, make, nb, b, wire_dtype)

    # Share-Reduce: chunk (i-s-1) is read exactly once, at its own hop; the
    # last hop's accumulate produces rank i's reduced chunk (i+1) % w
    if first_hop is not None:
        sends = list(first_hop)
    else:
        sends = [message(i, partial(quantize_pack, chunks[i][i], wire_dtype))
                 for i in range(w)]
    reduced_own: List[torch.Tensor] = [None] * w
    for s in range(w - 1):
        recvs = ring.hop(sends)
        sends = []
        for i in range(w):
            local = chunks[i][(i - s - 1) % w]
            q, scales = _message_parts(recvs[i], nb, b, wire_dtype)
            if s < w - 2:
                sends.append(message(i, partial(dequant_add_quantize, q, scales,
                                                local)))
            else:
                reduced_own[i] = dequant_accumulate(q, scales, local)

    # Share-Only: quantize the owned chunk once into row 0 and forward each
    # received row verbatim into the next rank's next row
    for g, own in zip(gathers, reduced_own):
        _write_message(g[0], partial(quantize_pack, own, wire_dtype), nb, b,
                       wire_dtype)
    for s in range(w - 1):
        ring.hop([g[s] for g in gathers], into=[g[s + 1] for g in gathers])

    # row r of rank i's gather holds chunk (i + 1 - r) % w
    return [_unpad(dequant_gather(*_message_parts(g, nb, b, wire_dtype),
                                  (i + 1) % w), x)
            for i, (g, x) in enumerate(zip(gathers, xs))]


def _place_gathered(gathered: torch.Tensor, i: int, w: int) -> torch.Tensor:
    """Rank i's gathered bf16 Share-Only messages, upcast, in arrival order
    (its own chunk (i+1) % w, then chunk (i-s) % w at hop s), put in chunk
    order."""
    out = torch.empty_like(gathered)
    out[(i + 1) % w] = gathered[0]
    for s in range(w - 1):
        out[(i - s) % w] = gathered[s + 1]
    return out


def _bf16_fused_ring_all_reduce(xs: Sequence[torch.Tensor], ring: LocalRing,
                                *, block: int) -> List[torch.Tensor]:
    """The bf16 wire ring: one trailer-free bf16 message per hop, with the
    fused ring's hop schedule. Share-Reduce accumulates in f32 inside
    ``bf16_add_cast``; Share-Only forwards received buffers verbatim and
    upcasts all gathered chunks in one ``bf16_accumulate(acc=None)``."""
    w = ring.size
    n = xs[0].numel()
    c_pad, nb, pad = _fused_chunk_layout(n, w, block)
    b = c_pad // nb
    chunks = [_padded_blocks(x, pad, w * nb).view(w, nb, b) for x in xs]

    sends = [cast_pack_bf16(chunks[i][i]).reshape(-1) for i in range(w)]
    reduced_own: List[torch.Tensor] = [None] * w
    for s in range(w - 1):
        recvs = ring.hop(sends)
        sends = []
        for i in range(w):
            local = chunks[i][(i - s - 1) % w]
            recv = recvs[i].view(nb, b)
            if s < w - 2:
                sends.append(bf16_add_cast(recv, local).reshape(-1))
            else:
                reduced_own[i] = bf16_accumulate(recv, local)

    msgs = [[cast_pack_bf16(reduced_own[i]).reshape(-1)] for i in range(w)]
    sends = [m[0] for m in msgs]
    for s in range(w - 1):
        sends = ring.hop(sends)
        for i in range(w):
            msgs[i].append(sends[i])

    outs = []
    for i, x in enumerate(xs):
        stacked = torch.stack(msgs[i]).view(w * nb, b)
        deq = bf16_accumulate(stacked, None).view(w, nb, b)
        outs.append(_unpad(_place_gathered(deq, i, w), x))
    return outs


# wire-format names of fused_wire_all_reduce; the quantized ones' payloads
FUSED_WIRES = ("int8", "fp8", "bf16")
_FUSED_WIRE_DTYPES = {"int8": torch.int8, "fp8": FP8_DTYPE}


def fused_wire_all_reduce(xs: Sequence[torch.Tensor], ring: LocalRing, *,
                          wire: str = "int8", block: int = DEFAULT_BLOCK
                          ) -> List[torch.Tensor]:
    """The fused ring with a selectable wire format: ``"int8"`` (the same
    as ``compressed_ring_all_reduce(fused=True)``), ``"fp8"`` (e4m3
    payload with the same per-block f32 trailer, byte for byte the size of
    int8's) or ``"bf16"`` (the bare 2-byte payload). All issue 2(w-1)
    messages; :func:`fused_wire_bytes` prices them."""
    if wire not in FUSED_WIRES:
        raise ValueError(f"unknown fused wire format {wire!r}; "
                         f"expected one of {FUSED_WIRES}")
    _check_ranks(xs, ring)
    if ring.size == 1:
        return list(xs)
    if wire == "bf16":
        return _bf16_fused_ring_all_reduce(xs, ring, block=block)
    return _fused_ring_all_reduce(xs, ring, block=block,
                                  wire_dtype=_FUSED_WIRE_DTYPES[wire])


# ---------------------------------------------------------------------------
# error feedback
# ---------------------------------------------------------------------------

def ef_compressed_all_reduce(gs: Sequence[torch.Tensor],
                             residuals: Optional[Sequence[torch.Tensor]],
                             ring: LocalRing, *, fused: bool = False,
                             block: int = DEFAULT_BLOCK
                             ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Error-feedback compressed all-reduce over the int8 wire.

    Rank r's ``corrected = g + residual`` is quantized exactly once; the
    rank keeps ``residual' = corrected - Q(corrected)`` for the next step,
    and the ring's first Share-Reduce hop forwards that payload verbatim
    (no re-quantization of the dequantized values). Returns (every rank's
    sum-reduced compressed gradient, every rank's new f32 residual).
    """
    _check_ranks(gs, ring)
    w = ring.size
    corrected = [g.float() if residuals is None or residuals[r] is None
                 else g.float() + residuals[r].float()
                 for r, g in enumerate(gs)]
    n = corrected[0].numel()

    _, nb, pad = _fused_chunk_layout(n, w, block)

    def compress(c: torch.Tensor):
        """(payload, scales, dequantized c) through the fused kernels, in
        the ring's w * nb sub-block rows."""
        q, scales = quantize_pack(_padded_blocks(c, pad, w * nb))
        deq = dequant_accumulate(q, scales, None)
        return q, scales, deq.reshape(-1)[:n].reshape(c.shape)

    if w == 1:
        # no hops — still quantize once so the residual semantics (and the
        # fused mode's blockwise rounding) match the w >= 2 ring exactly
        c = corrected[0]
        comp = compress(c)[2] if fused else dequantize(quantize(c), n, c.shape)
        return [comp.to(gs[0].dtype)], [c - comp]

    compressed, firsts = [], []
    for i, c in enumerate(corrected):
        if fused:
            q, scales, comp = compress(c)
            firsts.append(pack_hop_message(q[i * nb:(i + 1) * nb],
                                           scales[i * nb:(i + 1) * nb]))
        else:
            q_flat, scale = quantize(c)
            comp = dequantize((q_flat, scale), n, c.shape)
            firsts.append((_as_chunks(q_flat, w)[0], scale))
        compressed.append(comp)
    if fused:
        reduced = _fused_ring_all_reduce(compressed, ring, block=block,
                                         first_hop=firsts)
    else:
        reduced = _xla_ring_all_reduce(compressed, ring, first_hop=firsts)
    return ([r.to(g.dtype) for r, g in zip(reduced, gs)],
            [c - comp for c, comp in zip(corrected, compressed)])


# ---------------------------------------------------------------------------
# wire-cost accounting (the executable side of the scheduler's Eq. (1))
# ---------------------------------------------------------------------------

def compressed_ring_ppermutes(w: int, *, fused: bool = False) -> int:
    """Messages one compressed all-reduce sends per worker: 4(w-1) on the
    unfused path (payload and f32 scale apart), 2(w-1) fused."""
    if w <= 1:
        return 0
    return (2 if fused else 4) * (w - 1)


def compressed_wire_bytes(d: float, w: int, *, scale_bytes: int = SCALE_BYTES,
                          fused: bool = False,
                          block: int = DEFAULT_BLOCK) -> float:
    """Per-worker wire bytes of one int8 ring all-reduce.

    Unfused path: 2(w-1) hops, each sending a ceil(d/w)-byte int8 payload
    plus a separate ``scale_bytes`` f32 scale message. Fused path: 2(w-1)
    hops of ONE packed message — the block-padded payload plus one f32 scale
    per ``block`` sub-block in the trailer.
    """
    if w <= 1:
        return 0.0
    if fused:
        c_pad, nb, _ = _fused_chunk_layout(int(d), w, block)
        return 2.0 * (w - 1.0) * (c_pad + float(scale_bytes) * nb)
    c = -(-int(d) // w)  # ceil(d / w): the executed (padded) chunk size
    return 2.0 * (w - 1.0) * (float(c) + float(scale_bytes))


def fused_wire_bytes(d: float, w: int, *, wire: str = "int8",
                     scale_bytes: int = SCALE_BYTES,
                     block: int = DEFAULT_BLOCK) -> float:
    """Per-worker wire bytes of one :func:`fused_wire_all_reduce`: 2(w-1)
    hops of one message each; int8/fp8 messages are the block-padded
    1-byte payload plus one f32 scale per sub-block, bf16 messages the bare
    2-byte payload."""
    if wire not in FUSED_WIRES:
        raise ValueError(f"unknown fused wire format {wire!r}; "
                         f"expected one of {FUSED_WIRES}")
    if w <= 1:
        return 0.0
    c_pad, nb, _ = _fused_chunk_layout(int(d), w, block)
    if wire == "bf16":
        per_hop = 2.0 * c_pad
    else:
        per_hop = c_pad + float(scale_bytes) * nb
    return 2.0 * (w - 1.0) * per_hop
