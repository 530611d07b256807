"""Ring all-reduce over a rank transport (the counterpart of
``repro.dist.collectives``).

The reference runs every rank of a ring inside one ``shard_map`` and moves
data with ``lax.ppermute``. Here a collective takes the list of the w ranks'
tensors and a transport whose :meth:`LocalRing.hop` is one ppermute along
the forward ring ``_ring_perm(w)`` (or the reversed one). The hop order is
the reference's exactly:

  * Share-Reduce (w-1 hops): at hop s rank i sends its partial sum of chunk
    (i - s) mod w to rank i+1 and adds the chunk arriving from rank i-1.
    Rank i then owns the reduced chunk (i + 1) mod w;
  * Share-Only (w-1 hops): the reduced chunks circulate until every rank
    holds them all.

A reversed ring (rank i sends to i-1) runs the same schedule under the
relabelling j = -i mod w. The f32 sums are therefore bit-identical to the
reference's. Per-rank wire traffic is 2 d (w-1)/w elements
(:func:`ring_wire_elements`), which :class:`LocalRing` counts from the
messages it actually carries. :func:`psum_all_reduce` is no ring: it is
the counterpart of ``lax.psum``, and :class:`LocalRing` counts it apart.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def _ring_perm(w: int, reverse: bool = False):
    """ppermute pairs for a unidirectional ring (src, dst); mirrors the
    reference's ``collectives._ring_perm``."""
    if reverse:
        return [(i, (i - 1) % w) for i in range(w)]
    return [(i, (i + 1) % w) for i in range(w)]


def _as_chunks(x: torch.Tensor, w: int) -> Tuple[torch.Tensor, int]:
    """A fresh flat copy of x, zero-padded to split into w equal ring
    chunks, as a (w, chunk) tensor; and the pad."""
    n = x.numel()
    pad = (-n) % w
    flat = torch.zeros(n + pad, dtype=x.dtype, device=x.device)
    flat[:n] = x.reshape(-1)
    return flat.view(w, -1), pad


def _effective_indices(w: int, reverse: bool) -> List[int]:
    """Each rank's position in forward-ring coordinates: a reversed ring is
    the forward ring under the relabelling j = -i mod w, so one schedule
    serves both directions."""
    return [(w - i) % w if reverse else i for i in range(w)]


class LocalRing:
    """The ranks of one ring, all driven by this process.

    Rank r lives on ``devices[r]``; on one card every rank is the same
    device. :meth:`permute` is one ppermute with any permutation, and
    :meth:`hop` one along the forward (or reversed) ring: a rank receives
    a copy of what its sender sent, in a buffer of its own on its own
    device. ``messages[r]`` and ``bytes[r]``
    count what rank r sent on the ring, ``directions`` the ring
    permutations the hops used, and ``psums[r]`` the psum collectives rank
    r joined, which are no ring hops.
    """

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.messages = [0] * self.size
        self.bytes = [0] * self.size
        self.psums = [0] * self.size
        self.directions: set = set()

    def permute(self, sends: Sequence[torch.Tensor],
                perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
        """One ppermute with any permutation (the counterpart of
        ``lax.ppermute``): for each ``(src, dst)`` pair, rank ``dst``
        receives a copy of ``sends[src]`` on its own device. Checks only
        that there is one message and one pair per rank."""
        w = self.size
        if len(sends) != w:
            raise ValueError(f"permute needs one message per rank ({w}), "
                             f"got {len(sends)}")
        if len(perm) != w:
            raise ValueError(f"permute needs one (src, dst) pair per rank "
                             f"({w}), got {len(perm)}")
        recvs: List[torch.Tensor] = [None] * w
        for src, dst in perm:
            msg = sends[src]
            recvs[dst] = msg.to(self.devices[dst], copy=True)
            self.messages[src] += 1
            self.bytes[src] += msg.numel() * msg.element_size()
        return recvs

    def hop(self, sends: Sequence[torch.Tensor], *, reverse: bool = False
            ) -> List[torch.Tensor]:
        """One ppermute along the forward (or reversed) ring."""
        recvs = self.permute(sends, _ring_perm(self.size, reverse))
        self.directions.add("reverse" if reverse else "forward")
        return recvs

    def psum(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every rank's sum of ``xs``, taken in rank order on rank 0's device
        and copied to each rank's (the counterpart of ``lax.psum``)."""
        w = self.size
        if len(xs) != w:
            raise ValueError(f"psum needs one tensor per rank ({w}), "
                             f"got {len(xs)}")
        home = self.devices[0]
        total = xs[0].to(home, copy=True)
        for x in xs[1:]:
            total += x.to(home)
        for r in range(w):
            self.psums[r] += 1
        return [total.to(d, copy=True) for d in self.devices]


def _reduce_scatter_chunks(chunks: List[torch.Tensor], ring: LocalRing, *,
                           reverse: bool = False) -> None:
    """In-place Share-Reduce over each rank's (w, chunk) tensor; chunk
    (j+1) % w ends fully reduced on the rank of effective index j."""
    w = ring.size
    idx = _effective_indices(w, reverse)
    for s in range(w - 1):
        recvs = ring.hop([chunks[i][(idx[i] - s) % w] for i in range(w)],
                         reverse=reverse)
        for i in range(w):
            chunks[i][(idx[i] - s - 1) % w] += recvs[i]


def _all_gather_chunks(chunks: List[torch.Tensor], ring: LocalRing, *,
                       reverse: bool = False) -> None:
    """In-place Share-Only: circulate reduced chunks until all w are present."""
    w = ring.size
    idx = _effective_indices(w, reverse)
    for s in range(w - 1):
        recvs = ring.hop([chunks[i][(idx[i] + 1 - s) % w] for i in range(w)],
                         reverse=reverse)
        for i in range(w):
            chunks[i][(idx[i] - s) % w] = recvs[i]


def _check_ranks(xs: Sequence[torch.Tensor], ring: LocalRing) -> None:
    if len(xs) != ring.size:
        raise ValueError(f"need one tensor per rank ({ring.size}), got {len(xs)}")


def _ring_all_reduce_flat(xs: Sequence[torch.Tensor], ring: LocalRing,
                          reverse: bool) -> List[torch.Tensor]:
    w = ring.size
    n = xs[0].numel()
    chunks = [_as_chunks(x, w)[0] for x in xs]
    if w > 1:
        _reduce_scatter_chunks(chunks, ring, reverse=reverse)
        _all_gather_chunks(chunks, ring, reverse=reverse)
    return [c.reshape(-1)[:n] for c in chunks]


def ring_all_reduce(xs: Sequence[torch.Tensor], ring: LocalRing, *,
                    reverse: bool = False) -> List[torch.Tensor]:
    """Paper-faithful ring all-reduce: 2(w-1) hops, sum semantics. ``xs[r]``
    is rank r's tensor; returns every rank's sum, each on its own device.
    ``reverse=True`` runs the ring the other way round."""
    _check_ranks(xs, ring)
    shape = xs[0].shape
    return [f.reshape(shape) for f in _ring_all_reduce_flat(xs, ring, reverse)]


def ring_reduce_scatter(xs: Sequence[torch.Tensor], ring: LocalRing
                        ) -> List[torch.Tensor]:
    """Share-Reduce phase only: rank i gets its reduced chunk (i+1) mod w,
    flat, of ceil(d / w) elements. Forward ring only."""
    _check_ranks(xs, ring)
    w = ring.size
    chunks = [_as_chunks(x, w)[0] for x in xs]
    if w == 1:
        return [chunks[0].reshape(-1)]
    _reduce_scatter_chunks(chunks, ring)
    return [chunks[i][(i + 1) % w] for i in range(w)]


def bidirectional_ring_all_reduce(xs: Sequence[torch.Tensor], ring: LocalRing
                                  ) -> List[torch.Tensor]:
    """Counter-rotating half-rings: the first half of the flat gradient
    takes the forward ring, the second half the reversed one."""
    _check_ranks(xs, ring)
    if ring.size == 1:
        return list(xs)
    shape = xs[0].shape
    flats = [x.reshape(-1) for x in xs]
    half = (flats[0].numel() + 1) // 2
    fwd = _ring_all_reduce_flat([f[:half] for f in flats], ring, reverse=False)
    bwd = _ring_all_reduce_flat([f[half:] for f in flats], ring, reverse=True)
    return [torch.cat([a, b]).reshape(shape) for a, b in zip(fwd, bwd)]


def psum_all_reduce(xs: Sequence[torch.Tensor], ring: LocalRing
                    ) -> List[torch.Tensor]:
    """The all-reduce baseline with no explicit ring (``lax.psum`` in the
    reference): one :meth:`LocalRing.psum`."""
    _check_ranks(xs, ring)
    return ring.psum(xs)


def ring_wire_elements(d: float, w: int) -> float:
    """Per-worker wire traffic of one ring all-reduce, in elements: the
    paper's 2d(w-1)/w, (w-1) Share-Reduce plus (w-1) Share-Only sends of
    d/w elements each."""
    if w <= 1:
        return 0.0
    return 2.0 * float(d) * (w - 1.0) / float(w)
