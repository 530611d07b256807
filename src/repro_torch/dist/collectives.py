"""Ring all-reduce over a rank transport (the counterpart of
``repro.dist.collectives``).

The reference runs every rank of a ring inside one ``shard_map`` and moves
data with ``lax.ppermute``. Here a collective takes the list of the w ranks'
tensors and a transport whose :meth:`LocalRing.hop` is one ppermute along
the forward ring ``_ring_perm(w)``. The hop order is the reference's
exactly:

  * Share-Reduce (w-1 hops): at hop s rank i sends its partial sum of chunk
    (i - s) mod w to rank i+1 and adds the chunk arriving from rank i-1.
    Rank i then owns the reduced chunk (i + 1) mod w;
  * Share-Only (w-1 hops): the reduced chunks circulate until every rank
    holds them all.

The f32 sums are therefore bit-identical to the reference's. Per-rank wire
traffic is 2 d (w-1)/w elements (:func:`ring_wire_elements`), which
:class:`LocalRing` counts from the messages it actually carries.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def _ring_perm(w: int):
    """ppermute pairs for the forward unidirectional ring (src, dst)."""
    return [(i, (i + 1) % w) for i in range(w)]


def _as_chunks(x: torch.Tensor, w: int) -> Tuple[torch.Tensor, int]:
    """A fresh flat copy of x, zero-padded to split into w equal ring
    chunks, as a (w, chunk) tensor; and the pad."""
    n = x.numel()
    pad = (-n) % w
    flat = torch.zeros(n + pad, dtype=x.dtype, device=x.device)
    flat[:n] = x.reshape(-1)
    return flat.view(w, -1), pad


class LocalRing:
    """The ranks of one ring, all driven by this process.

    Rank r lives on ``devices[r]``; on one card every rank is the same
    device. :meth:`hop` is one ppermute along the forward ring: rank r
    receives a copy of what rank r-1 sent, in a buffer of its own on its
    own device. ``messages[r]`` and ``bytes[r]`` count what rank r sent.
    """

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.messages = [0] * self.size
        self.bytes = [0] * self.size

    def hop(self, sends: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        w = self.size
        if len(sends) != w:
            raise ValueError(f"hop needs one message per rank ({w}), "
                             f"got {len(sends)}")
        recvs: List[torch.Tensor] = [None] * w
        for src, dst in _ring_perm(w):
            msg = sends[src]
            recvs[dst] = msg.to(self.devices[dst], copy=True)
            self.messages[src] += 1
            self.bytes[src] += msg.numel() * msg.element_size()
        return recvs


def _reduce_scatter_chunks(chunks: List[torch.Tensor], ring: LocalRing) -> None:
    """In-place Share-Reduce over each rank's (w, chunk) tensor; chunk
    (i+1) % w ends fully reduced on rank i."""
    w = ring.size
    for s in range(w - 1):
        recvs = ring.hop([chunks[i][(i - s) % w] for i in range(w)])
        for i in range(w):
            chunks[i][(i - s - 1) % w] += recvs[i]


def _all_gather_chunks(chunks: List[torch.Tensor], ring: LocalRing) -> None:
    """In-place Share-Only: circulate reduced chunks until all w are present."""
    w = ring.size
    for s in range(w - 1):
        recvs = ring.hop([chunks[i][(i + 1 - s) % w] for i in range(w)])
        for i in range(w):
            chunks[i][(i - s) % w] = recvs[i]


def ring_all_reduce(xs: Sequence[torch.Tensor], ring: LocalRing
                    ) -> List[torch.Tensor]:
    """Paper-faithful ring all-reduce: 2(w-1) hops, sum semantics. ``xs[r]``
    is rank r's tensor; returns every rank's sum, each on its own device."""
    w = ring.size
    if len(xs) != w:
        raise ValueError(f"need one tensor per rank ({w}), got {len(xs)}")
    shape, n = xs[0].shape, xs[0].numel()
    chunks = [_as_chunks(x, w)[0] for x in xs]
    if w > 1:
        _reduce_scatter_chunks(chunks, ring)
        _all_gather_chunks(chunks, ring)
    return [c.reshape(-1)[:n].reshape(shape) for c in chunks]


def ring_wire_elements(d: float, w: int) -> float:
    """Per-worker wire traffic of one ring all-reduce, in elements: the
    paper's 2d(w-1)/w, (w-1) Share-Reduce plus (w-1) Share-Only sends of
    d/w elements each."""
    if w <= 1:
        return 0.0
    return 2.0 * float(d) * (w - 1.0) / float(w)
