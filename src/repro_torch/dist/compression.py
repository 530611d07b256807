"""The fused int8 ring (the counterpart of the ``fused=True`` path of
``repro.dist.compression``).

Each hop's wire message is ONE int8 buffer::

    [ int8 payload: n_blocks * block ][ trailer: n_blocks f32 scales,
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
    dequantizes all w messages in one ``dequant_accumulate(acc=None)``,
    so every rank ends with bit-identical values.

The kernels are ``repro_torch.kernels.quant_ring``'s. The XLA reference
path (``fused=False``: global-amax scale, two messages per hop) and error
feedback are not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.dist.collectives import LocalRing
from repro_torch.kernels.quant_ring import (
    SCALE_BYTES,
    dequant_accumulate,
    dequant_add_quantize,
    hop_message_layout,
    quantize_pack,
)

# default sub-block size of the fused path: the per-block f32 scale costs
# 4/block of the payload on the wire (0.1% at 4096)
DEFAULT_BLOCK = 4096


def pack_hop_message(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Pack a ``(n_blocks, block)`` payload and its ``(n_blocks,)`` f32
    scales into one int8 wire buffer: payload first, then each scale as its
    4 little-endian bytes."""
    return torch.cat([q.reshape(-1).view(torch.int8),
                      scales.contiguous().view(torch.int8)])


def unpack_hop_message(msg: torch.Tensor, n_blocks: int, block: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_hop_message`. The payload is a view of
    ``msg``; the trailer is copied, since it starts at ``n_blocks * block``,
    which need not be a multiple of 4 bytes."""
    n = n_blocks * block
    q = msg[:n].view(n_blocks, block)
    scales = msg[n:].clone().view(torch.float32)
    return q, scales


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


def compressed_ring_all_reduce(xs: Sequence[torch.Tensor], ring: LocalRing, *,
                               fused: bool = False,
                               block: int = DEFAULT_BLOCK) -> List[torch.Tensor]:
    """Ring all-reduce with int8-quantized hop payloads. ``xs[r]`` is rank
    r's tensor; returns every rank's (bit-identical) sum. A one-rank ring
    returns its input unquantized, as the reference does. ``fused=True``
    is the fused ring; the default, as in the reference, is the XLA path,
    which raises until it is ported."""
    if len(xs) != ring.size:
        raise ValueError(f"need one tensor per rank ({ring.size}), got {len(xs)}")
    if ring.size == 1:
        return list(xs)
    if not fused:
        raise NotImplementedError(
            "the XLA-path int8 ring (fused=False) is not ported yet")
    return _fused_ring_all_reduce(xs, ring, block=block)


def _fused_ring_all_reduce(xs: Sequence[torch.Tensor], ring: LocalRing, *,
                           block: int) -> List[torch.Tensor]:
    w = ring.size
    shape, dtype, n = xs[0].shape, xs[0].dtype, xs[0].numel()
    c_pad, nb, pad = _fused_chunk_layout(n, w, block)
    b = c_pad // nb
    chunks = []
    for x in xs:
        flat = x.reshape(-1).to(torch.float32)
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        chunks.append(flat.view(w, nb, b))

    def quant_pack(blocks2d: torch.Tensor) -> torch.Tensor:
        return pack_hop_message(*quantize_pack(blocks2d))

    # Share-Reduce: chunk (i-s-1) is read exactly once, at its own hop; the
    # last hop's accumulate produces rank i's reduced chunk (i+1) % w
    sends = [quant_pack(chunks[i][i]) for i in range(w)]
    reduced_own: List[torch.Tensor] = [None] * w
    for s in range(w - 1):
        recvs = ring.hop(sends)
        sends = []
        for i in range(w):
            local = chunks[i][(i - s - 1) % w]
            q, scales = unpack_hop_message(recvs[i], nb, b)
            if s < w - 2:
                sends.append(pack_hop_message(*dequant_add_quantize(q, scales, local)))
            else:
                reduced_own[i] = dequant_accumulate(q, scales, local)

    # Share-Only: quantize the owned chunk once and forward received
    # messages verbatim; the owner reads back its own quantized payload
    msgs = [[quant_pack(reduced_own[i])] for i in range(w)]
    chunk_ids = [[(i + 1) % w] for i in range(w)]
    sends = [m[0] for m in msgs]
    for s in range(w - 1):
        recvs = ring.hop(sends)
        for i in range(w):
            msgs[i].append(recvs[i])
            chunk_ids[i].append((i - s) % w)
        sends = recvs

    outs = []
    for i in range(w):
        q_all = torch.stack([m[: nb * b] for m in msgs[i]]).view(w * nb, b)
        scales_all = torch.stack([m[nb * b:] for m in msgs[i]]).view(
            torch.float32).view(-1)
        deq = dequant_accumulate(q_all, scales_all, None).view(w, nb, b)
        out = torch.empty((w, nb, b), dtype=torch.float32, device=deq.device)
        for k, c in enumerate(chunk_ids[i]):
            out[c] = deq[k]
        outs.append(out.reshape(-1)[:n].reshape(shape).to(dtype))
    return outs


# ---------------------------------------------------------------------------
# wire-cost accounting (the executable side of the scheduler's Eq. (1))
# ---------------------------------------------------------------------------

def compressed_ring_ppermutes(w: int, *, fused: bool = False) -> int:
    """Messages one compressed all-reduce sends per worker: 4(w-1) on the
    XLA path (payload and f32 scale apart), 2(w-1) fused."""
    if w <= 1:
        return 0
    return (2 if fused else 4) * (w - 1)


def compressed_wire_bytes(d: float, w: int, *, scale_bytes: int = SCALE_BYTES,
                          fused: bool = False,
                          block: int = DEFAULT_BLOCK) -> float:
    """Per-worker wire bytes of one int8 ring all-reduce.

    XLA path: 2(w-1) hops, each sending a ceil(d/w)-byte int8 payload plus
    a separate ``scale_bytes`` f32 scale message. Fused path: 2(w-1) hops
    of ONE packed message — the block-padded payload plus one f32 scale
    per ``block`` sub-block in the trailer.
    """
    if w <= 1:
        return 0.0
    if fused:
        c_pad, nb, _ = _fused_chunk_layout(int(d), w, block)
        return 2.0 * (w - 1.0) * (c_pad + float(scale_bytes) * nb)
    c = -(-int(d) // w)  # ceil(d / w): the executed (padded) chunk size
    return 2.0 * (w - 1.0) * (float(c) + float(scale_bytes))
