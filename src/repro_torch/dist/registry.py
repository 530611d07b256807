"""Registry of every ring-all-reduce variant and train-step mode (the
counterpart of ``repro.dist.registry``), with the reference's names, order
and wire annotations.

  * :data:`RING_VARIANTS` — the raw collectives. ``build(ring)`` takes a
    :class:`~repro_torch.dist.collectives.LocalRing` and returns a function
    from the ranks' tensors to the ranks' sums. Each is annotated with the
    ``rar_model`` wire layout it must price as (``compression``), the
    number of ring directions its hops use, and whether it is a half-split
    bidirectional ring, a reduce-scatter (single phase) or a segmented
    bucket pipeline (``n_buckets`` independent hop chains).
  * :data:`STEP_MODES` — every ``make_ring_train_step`` mode, annotated the
    same way. Most modes reduce *per gradient leaf*; the overlap mode
    reduces *per bucket* (``spec.n_buckets``) of
    ``repro_torch.dist.overlap.plan_bucket_sizes``.

:meth:`RingVariant.expected_messages` and :meth:`RingVariant.expected_bytes`
price a variant through the port's ``wire_formula``; the tests hold
``LocalRing``'s own counts against them.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.rar_model import wire_formula
from repro_torch.dist import collectives
from repro_torch.dist.collectives import LocalRing
from repro_torch.dist.compression import (
    compressed_ring_all_reduce,
    ef_compressed_all_reduce,
    fused_wire_all_reduce,
)
from repro_torch.dist.overlap import RankFn, even_bucket_sizes, segmented_ring_reduce

__all__ = ["RingVariant", "StepModeSpec", "RING_VARIANTS", "STEP_MODES",
           "variant_by_name"]

BuildFn = Callable[[LocalRing], RankFn]


@dataclasses.dataclass(frozen=True)
class RingVariant:
    """One registered ring collective and its priced wire layout.

    ``directions`` is the number of distinct ring permutations its hops
    use: 1 for a unidirectional ring, 2 (mutually inverse) for the
    bidirectional split, 0 for psum-based variants with no explicit ring.
    ``halves`` marks the bidirectional collective (the flat tensor splits
    into two half-rings, each priced independently); ``reduce_scatter``
    marks the single-phase collective (Share-Reduce only: half the hops and
    bytes of a full all-reduce); ``n_buckets`` marks a segmented bucket
    pipeline — the flat input splits into that many contiguous even
    segments (``overlap.even_bucket_sizes``), each reduced by its own hop
    chain and priced independently. ``source`` is the repo-relative file
    the variant's implementation lives in.
    """

    name: str
    build: BuildFn
    compression: Optional[str] = None
    directions: int = 1
    collective: str = "ppermute"
    halves: bool = False
    reduce_scatter: bool = False
    n_buckets: Optional[int] = None
    source: str = "src/repro_torch/dist/collectives.py"

    def expected_messages(self, w: int, d: Optional[int] = None) -> int:
        """Ring messages one call sends per rank at world size w.

        ``d`` only matters for bucketed variants (the segment count is
        clamped to the flat size).
        """
        if self.collective != "ppermute" or w <= 1:
            return 0
        per_ring = wire_formula(self.compression).messages(w)
        if self.halves:
            return 2 * per_ring
        if self.reduce_scatter:
            return per_ring // 2
        if self.n_buckets:
            segs = (len(even_bucket_sizes(d, self.n_buckets))
                    if d is not None else self.n_buckets)
            return segs * per_ring
        return per_ring

    def expected_bytes(self, d: int, w: int) -> float:
        """Wire bytes one call sends per rank for a flat ``d``-element input
        (executed layout: padded chunks included)."""
        if self.collective != "ppermute" or w <= 1:
            return 0.0
        f = wire_formula(self.compression)
        if self.halves:
            hi = (d + 1) // 2
            return (f.bytes_per_worker(hi, w)
                    + f.bytes_per_worker(d - hi, w))
        if self.n_buckets:
            return sum(f.bytes_per_worker(seg, w)
                       for seg in even_bucket_sizes(d, self.n_buckets))
        total = f.bytes_per_worker(d, w)
        return total / 2.0 if self.reduce_scatter else total


def _ef_build(ring: LocalRing, *, fused: bool) -> RankFn:
    def run(gs: List[torch.Tensor]) -> List[torch.Tensor]:
        reduced, _ = ef_compressed_all_reduce(
            gs, [torch.zeros_like(g) for g in gs], ring, fused=fused)
        return reduced
    return run


def _bucketed_f32_build(ring: LocalRing, *, n_buckets: int) -> RankFn:
    def run(gs: List[torch.Tensor]) -> List[torch.Tensor]:
        return segmented_ring_reduce(
            gs, partial(collectives.ring_all_reduce, ring=ring), n_buckets)
    return run


def _bind(fn: Callable, **kw) -> BuildFn:
    """``build`` of a collective ``fn(xs, ring, **kw)``."""
    return lambda ring: partial(fn, ring=ring, **kw)


# segment count of the registered variant-level bucket pipeline (the step
# mode's bucket count lives on StepModeSpec.n_buckets instead)
BUCKETED_VARIANT_SEGMENTS = 3

_COMPRESSION_SOURCE = "src/repro_torch/dist/compression.py"

RING_VARIANTS: Tuple[RingVariant, ...] = (
    RingVariant(name="f32", build=_bind(collectives.ring_all_reduce)),
    RingVariant(name="f32-reverse",
                build=_bind(collectives.ring_all_reduce, reverse=True)),
    RingVariant(name="bidir",
                build=_bind(collectives.bidirectional_ring_all_reduce),
                directions=2, halves=True),
    RingVariant(name="reduce-scatter",
                build=_bind(collectives.ring_reduce_scatter),
                reduce_scatter=True),
    RingVariant(name="psum", build=_bind(collectives.psum_all_reduce),
                directions=0, collective="psum"),
    RingVariant(name="f32-bucketed",
                build=partial(_bucketed_f32_build,
                              n_buckets=BUCKETED_VARIANT_SEGMENTS),
                n_buckets=BUCKETED_VARIANT_SEGMENTS,
                source="src/repro_torch/dist/overlap.py"),
    RingVariant(name="int8", build=_bind(compressed_ring_all_reduce),
                compression="int8", source=_COMPRESSION_SOURCE),
    RingVariant(name="int8-fused",
                build=_bind(compressed_ring_all_reduce, fused=True),
                compression="int8-fused", source=_COMPRESSION_SOURCE),
    RingVariant(name="bf16-fused",
                build=_bind(fused_wire_all_reduce, wire="bf16"),
                compression="bf16-fused", source=_COMPRESSION_SOURCE),
    RingVariant(name="fp8-fused",
                build=_bind(fused_wire_all_reduce, wire="fp8"),
                compression="fp8-fused", source=_COMPRESSION_SOURCE),
    RingVariant(name="ef-int8", build=partial(_ef_build, fused=False),
                compression="int8", source=_COMPRESSION_SOURCE),
    RingVariant(name="ef-int8-fused", build=partial(_ef_build, fused=True),
                compression="int8-fused", source=_COMPRESSION_SOURCE),
)


def variant_by_name(name: str) -> RingVariant:
    for v in RING_VARIANTS:
        if v.name == name:
            return v
    raise KeyError(f"no registered ring variant {name!r}; registered: "
                   f"{[v.name for v in RING_VARIANTS]}")


@dataclasses.dataclass(frozen=True)
class StepModeSpec:
    """Wire annotation of one ``make_ring_train_step`` mode.

    The step applies the mode's per-leaf reduction to every gradient leaf.
    For ``collective == "psum"`` that is one psum per leaf and no ring hop.
    A mode with ``n_buckets`` set reduces *per bucket* instead of per leaf
    (``overlap.bucketed_ring_reduce`` with the reverse-autodiff bucket
    plan): its expectation composes the leaf variant over
    ``plan_bucket_sizes(leaf_sizes, n_buckets, reverse=True)``.
    """

    mode: str
    compression: Optional[str] = None
    directions: int = 1
    collective: str = "ppermute"
    halves: bool = False
    n_buckets: Optional[int] = None

    def leaf_variant(self) -> RingVariant:
        """The registered raw collective this mode applies per leaf (per
        bucket for overlap modes)."""
        return variant_by_name({
            "ring": "f32", "bidir": "bidir", "psum": "psum",
            "compressed": "int8", "compressed-fused": "int8-fused",
            "compressed-fused-overlap": "int8-fused",
            "bf16-fused": "bf16-fused", "fp8-fused": "fp8-fused",
        }[self.mode])

    @property
    def wire_dtype(self) -> str:
        """Wire payload element dtype name (part of the ring-program cache
        key)."""
        return {
            None: "float32",
            "int8": "int8",
            "int8-fused": "int8",
            "fp8-fused": "float8_e4m3fn",
            "bf16-fused": "bfloat16",
        }[self.compression]


# default bucket count of the overlap step mode; the executed bucketing
# clamps to the model's leaf count (overlap.plan_buckets)
DEFAULT_OVERLAP_BUCKETS = 4


STEP_MODES: Dict[str, StepModeSpec] = {
    "ring": StepModeSpec(mode="ring"),
    "bidir": StepModeSpec(mode="bidir", directions=2, halves=True),
    "psum": StepModeSpec(mode="psum", directions=0, collective="psum"),
    "compressed": StepModeSpec(mode="compressed", compression="int8"),
    "compressed-fused": StepModeSpec(mode="compressed-fused",
                                     compression="int8-fused"),
    "compressed-fused-overlap": StepModeSpec(
        mode="compressed-fused-overlap", compression="int8-fused",
        n_buckets=DEFAULT_OVERLAP_BUCKETS),
    "bf16-fused": StepModeSpec(mode="bf16-fused", compression="bf16-fused"),
    "fp8-fused": StepModeSpec(mode="fp8-fused", compression="fp8-fused"),
}
