"""Gradient bucketing (the counterpart of ``repro.dist.overlap``).

``bucketed_psum`` coalesces many small gradient tensors into a few large
all-reduces — the ring's per-hop latency gamma is paid per collective, so
fewer, larger payloads sit closer to the bandwidth-bound regime Eq. (1)
assumes. ``bucketed_ring_reduce`` is the overlap step mode's reduction:
the same order-preserving bucketing, but each bucket goes through a
registered ``repro_torch.dist.registry`` ring variant (the fused int8 ring
by default), and buckets are planned in *reverse-autodiff order*: the
bucket holding the tree's last leaves, whose gradients the backward pass
produces first, is reduced first. The bucket plan (:func:`plan_buckets`,
:func:`plan_bucket_sizes`) is the reference's, and the leaves are taken in
the reference's ``jax.tree.flatten`` order (:func:`tree_leaves`), so the
buckets, and with them every quantization block, are the reference's.

Here the buckets are reduced after the backward pass, in that order: with
every rank in one process there is nothing to overlap them with. Issuing
each bucket's ring from autograd hooks while the backward pass runs is
work for the transport across cards, and is not done here.
``microbatch_grads`` is not ported: it serves the GSPMD ``make_train_step``,
which the port does not have yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple, Union

import torch

from repro_torch.dist.collectives import LocalRing


def tree_leaves(tree: Dict[str, Any], prefix: str = ""
                ) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of a nested dict in ``jax.tree.flatten``'s order:
    keys sorted at every level (the port's ``_flatten`` keeps insertion
    order, as the reference's own ``_flatten`` does)."""
    out = []
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.extend(tree_leaves(tree[k], path))
        else:
            out.append((path, tree[k]))
    return out


# ---------------------------------------------------------------------------
# bucket planning
# ---------------------------------------------------------------------------

def plan_buckets(sizes: Sequence[int], n_buckets: int, *,
                 reverse: bool = False) -> List[List[int]]:
    """Greedy order-preserving partition of leaf ``sizes`` into contiguous
    buckets of roughly equal element count.

    Returns lists of *original* indices. ``reverse=True`` walks the leaves
    last-to-first (reverse-autodiff order) so the bucket containing the last
    leaves is planned — and its ring launched — first. The bucket count is
    clamped to ``[1, len(sizes)]``.
    """
    if not sizes:
        return []
    idx = list(range(len(sizes)))
    if reverse:
        idx.reverse()
    n_buckets = max(1, min(int(n_buckets), len(sizes)))
    total = sum(sizes)
    target = max(1, -(-total // n_buckets))  # ceil

    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_size = 0
    for i in idx:
        cur.append(i)
        cur_size += sizes[i]
        if cur_size >= target and len(buckets) < n_buckets - 1:
            buckets.append(cur)
            cur, cur_size = [], 0
    if cur:
        buckets.append(cur)
    return buckets


def plan_bucket_sizes(sizes: Sequence[int], n_buckets: int, *,
                      reverse: bool = True) -> List[int]:
    """Element count of each planned bucket (the reduced payload sizes of
    :func:`bucketed_ring_reduce`, in launch order)."""
    return [sum(sizes[i] for i in bucket)
            for bucket in plan_buckets(sizes, n_buckets, reverse=reverse)]


def even_bucket_sizes(d: int, n: int) -> List[int]:
    """Even contiguous split of ``d`` flat elements into ``n`` segments
    (first ``d % n`` segments one element larger) — the segment rule of
    :func:`segmented_ring_reduce`."""
    n = max(1, min(int(n), int(d))) if d > 0 else 1
    base, rem = divmod(int(d), n)
    return [base + (1 if i < rem else 0) for i in range(n)]


RankFn = Callable[[List[torch.Tensor]], List[torch.Tensor]]


def segmented_ring_reduce(xs: Sequence[torch.Tensor], ring_fn: RankFn,
                          n_segments: int) -> List[torch.Tensor]:
    """Reduce each rank's tensor as ``n_segments`` contiguous even flat
    segments, each through its own ``ring_fn`` call (one hop chain per
    segment). ``ring_fn`` maps per-rank tensors to per-rank sums."""
    shape = xs[0].shape
    flats = [x.reshape(-1) for x in xs]
    parts: List[List[torch.Tensor]] = [[] for _ in xs]
    off = 0
    for seg in even_bucket_sizes(flats[0].numel(), n_segments):
        red = ring_fn([f[off: off + seg] for f in flats])
        for r, t in enumerate(red):
            parts[r].append(t)
        off += seg
    return [torch.cat(p).reshape(shape) for p in parts]


# ---------------------------------------------------------------------------
# bucketed reductions
# ---------------------------------------------------------------------------

def _bucketed_reduce(grads: Sequence[Dict[str, Any]], n_buckets: int,
                     reduce_flat: RankFn, *, reverse: bool
                     ) -> List[Dict[str, torch.Tensor]]:
    """Shared driver: plan buckets, concat per dtype, reduce, split back.
    ``grads[r]`` is rank r's gradient tree; returns each rank's reduced
    leaves as a flat ``{path: tensor}`` dict in ``tree_leaves`` order."""
    per_rank = [tree_leaves(g) for g in grads]
    paths = [p for p, _ in per_rank[0]]
    leaves = [[v for _, v in rank] for rank in per_rank]
    if not paths:
        return [{} for _ in grads]
    sizes = [leaf.numel() for leaf in leaves[0]]
    out: List[List[torch.Tensor]] = [[None] * len(paths) for _ in grads]
    for bucket in plan_buckets(sizes, n_buckets, reverse=reverse):
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i in bucket:
            by_dtype.setdefault(leaves[0][i].dtype, []).append(i)
        for idxs in by_dtype.values():
            flats = [torch.cat([rank[i].reshape(-1) for i in idxs])
                     for rank in leaves]
            red = reduce_flat(flats)
            for r, flat in enumerate(red):
                off = 0
                for i in idxs:
                    n = sizes[i]
                    out[r][i] = flat[off: off + n].reshape(leaves[r][i].shape)
                    off += n
    return [dict(zip(paths, rank)) for rank in out]


def bucketed_psum(grads: Sequence[Dict[str, Any]], ring: LocalRing, *,
                  n_buckets: int = 4) -> List[Dict[str, torch.Tensor]]:
    """psum every rank's gradient tree as ~``n_buckets`` flat payloads:
    leaves packed into contiguous buckets of roughly equal element count
    (order-preserving), concatenated per dtype, summed with one
    :meth:`LocalRing.psum` each, then split and reshaped back."""
    return _bucketed_reduce(grads, n_buckets, ring.psum, reverse=False)


def bucketed_ring_reduce(grads: Sequence[Dict[str, Any]], ring: LocalRing, *,
                         variant: Union[str, Any] = "int8-fused",
                         n_buckets: int = 4) -> List[Dict[str, torch.Tensor]]:
    """Sum-reduce every rank's gradient tree as per-bucket ring
    all-reduces, each bucket's concatenated payload through one call of
    the named ``repro_torch.dist.registry.RING_VARIANTS`` entry, buckets in
    reverse-autodiff order (``plan_buckets(reverse=True)``). Returns the
    **sum** across the ranks, like the raw variants."""
    from repro_torch.dist.registry import RingVariant, variant_by_name

    if isinstance(variant, str):
        variant = variant_by_name(variant)
    elif not isinstance(variant, RingVariant):
        raise TypeError("variant must be a registered variant name or a "
                        f"RingVariant, got {type(variant).__name__}")
    return _bucketed_reduce(grads, n_buckets, variant.build(ring), reverse=True)
