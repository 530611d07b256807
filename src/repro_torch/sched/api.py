"""The Scheduler protocol, its context, and the slot-level result types.

A scheduler is any object with

    on_event(event, ctx)          -- react to a ClusterEvent (may be a no-op)
    schedule_slot(ctx) -> SlotDecision
                                  -- Algorithm 1 line 4: decide one slot's
                                     allocations and COMMIT every returned
                                     embedding into ctx.res

:class:`SchedulerContext` bundles everything the old implicit 3-arg contract
passed positionally — the slot index t, the slot's :class:`ResourceState`,
the accumulated :class:`ScheduleState` (the z_{i,t-1} of §V-B) — plus the
cluster view a real online scheduler needs: the contention configuration and
pricing, the failed-server set, and the straggler map.

Legacy duck-typed schedulers exposing ``schedule_slot(t, res, state)`` keep
working through :class:`LegacySchedulerAdapter` (see :func:`as_scheduler`).

This module deliberately has no runtime dependency on ``repro_torch.core`` or
``repro_torch.cluster`` (annotations only), so both layers can import it freely.
"""

from __future__ import annotations

import dataclasses
import inspect
import warnings
from typing import (
    TYPE_CHECKING,
    Dict,
    List,
    Mapping,
    Optional,
    Protocol,
    runtime_checkable,
)

import numpy as np

from repro_torch.sched.events import ClusterEvent, EmbeddingCommitted

if TYPE_CHECKING:  # annotation-only: keeps this module import-cycle-free
    from repro_torch.cluster.topology import Embedding, ResourceState
    from repro_torch.core.problem import DDLJSInstance, Job, ScheduleState


@dataclasses.dataclass(frozen=True)
class ContentionConfig:
    """Shared-bandwidth contention model (see repro_torch.cluster.topology).

    ``oversubscription=1.0`` (default) keeps the paper's hard-reservation
    admission, under which no edge can become contended, so behaviour is
    identical to the isolated-ring pricing. Values > 1 admit up to
    ``oversubscription * capacity`` of reservations per edge; committed rings
    then see fair-share effective bandwidth. ``enabled=False`` keeps the
    relaxed admission but skips the re-pricing (useful as an ablation).
    """

    oversubscription: float = 1.0
    enabled: bool = True


@dataclasses.dataclass(frozen=True)
class SlotDecision:
    """One slot's allocation (Algorithm 1 line 4): the committed ring
    embeddings plus solver diagnostics."""

    t: int
    embeddings: List[Embedding]
    lp_value: float
    value: float
    n_active: int
    n_embedded: int


def contention_factor(res: ResourceState, emb: Embedding, job) -> float:
    """Fair-share slowdown of one committed ring: tau(b_i)/tau(b_eff) in [0, 1].

    With an Eq. (1) profile the compute terms damp the slowdown
    (``contention_progress_factor``); profile-less trace jobs fall back to the
    comm-bound ratio b_eff/b_i. Shared by the driver, the metrics, and the
    training example so the pricing cannot drift between them.
    """
    if not emb.paths or emb.bandwidth <= 0.0:
        return 1.0
    b_eff = res.effective_bandwidth(emb)
    if b_eff >= emb.bandwidth:
        return 1.0
    ratio = max(0.0, b_eff / emb.bandwidth)
    if job.profile is not None and emb.n_workers > 1:
        from repro_torch.core.rar_model import contention_progress_factor

        return contention_progress_factor(
            job.profile, emb.n_workers, job.profile.bandwidth * ratio
        )
    return ratio


@dataclasses.dataclass(frozen=True)
class SchedulerContext:
    """Everything a scheduler may consult at slot ``t``.

    ``res`` is the slot's resource state (failed servers already zeroed);
    ``state`` carries the z accumulators; ``failed`` / ``straggling`` expose
    the cluster health view; ``contention`` parameterizes the pricing.
    """

    t: int
    res: ResourceState
    state: ScheduleState
    contention: ContentionConfig = dataclasses.field(
        default_factory=ContentionConfig
    )
    failed: frozenset = frozenset()            # server ids down this slot
    straggling: Mapping[int, float] = dataclasses.field(default_factory=dict)

    @property
    def inst(self) -> DDLJSInstance:
        return self.state.inst

    def active_jobs(self) -> List[Job]:
        """I[t]: arrived, budget not yet exhausted (§V-B)."""
        return self.state.active_jobs(self.t)

    def job(self, job_id: int) -> Job:
        return self.state.inst.job(job_id)

    def contention_factor(self, emb: Embedding) -> float:
        """Predicted fair-share slowdown of ``emb`` against ``res``
        (1.0 when the contention re-pricing is disabled)."""
        if not self.contention.enabled \
                or self.contention.oversubscription <= 1.0:
            # hard reservation admits at most `capacity` per edge, so no edge
            # can be oversubscribed and the factor is provably 1.0 — skip the
            # per-ring edge scan on the common uncontended path
            return 1.0
        return contention_factor(self.res, emb, self.job(emb.job_id))


@runtime_checkable
class Scheduler(Protocol):
    """Structural type every scheduler satisfies (natively or via adapter)."""

    name: str

    def on_event(self, event: ClusterEvent, ctx: SchedulerContext) -> None:
        ...

    def schedule_slot(self, ctx: SchedulerContext) -> SlotDecision:
        ...


class SchedulerBase:
    """Convenience base: no-op ``on_event``, dual-signature ``schedule_slot``.

    Subclasses implement :meth:`decide`. ``schedule_slot`` accepts either the
    canonical single :class:`SchedulerContext` argument or the deprecated
    legacy triple ``(t, res, state)`` (with a DeprecationWarning), so code
    written against the old implicit contract keeps working.
    """

    name = "scheduler"

    def on_event(self, event: ClusterEvent, ctx: SchedulerContext) -> None:
        return None

    def schedule_slot(self, ctx, res=None, state=None) -> SlotDecision:
        if res is not None or state is not None:
            warnings.warn(
                "schedule_slot(t, res, state) is deprecated; pass a "
                "repro_torch.sched.SchedulerContext instead",
                DeprecationWarning,
                stacklevel=2,
            )
            ctx = SchedulerContext(t=int(ctx), res=res, state=state)
        return self.decide(ctx)

    def decide(self, ctx: SchedulerContext) -> SlotDecision:
        raise NotImplementedError


def _takes_context(fn) -> bool:
    """True when ``fn`` is a new-style ``schedule_slot(ctx)``."""
    try:
        all_params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        return True
    if any(p.kind is inspect.Parameter.VAR_POSITIONAL for p in all_params):
        return False  # *args duck-types the legacy (t, res, state) triple
    params = [
        p for p in all_params
        if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                      inspect.Parameter.POSITIONAL_OR_KEYWORD)
        and p.name != "self"
    ]
    return len(params) <= 1


class LegacySchedulerAdapter(SchedulerBase):
    """Wrap a duck-typed scheduler so the driver only speaks the protocol.

    Handles both legacy ``schedule_slot(t, res, state)`` objects and
    ctx-native objects that merely lack ``on_event``.
    """

    def __init__(self, inner):
        self.inner = inner
        self.name = getattr(inner, "name", type(inner).__name__)
        self._ctx_native = _takes_context(inner.schedule_slot)

    def on_event(self, event: ClusterEvent, ctx: SchedulerContext) -> None:
        fn = getattr(self.inner, "on_event", None)
        if fn is not None:
            fn(event, ctx)

    def decide(self, ctx: SchedulerContext) -> SlotDecision:
        if self._ctx_native:
            return self.inner.schedule_slot(ctx)
        return self.inner.schedule_slot(ctx.t, ctx.res, ctx.state)


def as_scheduler(obj) -> Scheduler:
    """Coerce ``obj`` to the Scheduler protocol (identity for natives)."""
    if isinstance(obj, SchedulerBase):
        return obj
    if not hasattr(obj, "schedule_slot"):
        raise TypeError(f"{obj!r} is not a scheduler (no schedule_slot)")
    return LegacySchedulerAdapter(obj)


@dataclasses.dataclass(frozen=True)
class SlotRecord:
    """Per-slot accounting row (feeds metrics.summarize)."""

    t: int
    n_active: int
    n_embedded: int
    workers_placed: int
    effective_worker_time: float
    utility_total: float
    gpu_utilization: float
    failed_servers: int
    max_edge_contention: float = 0.0   # max reserved/capacity over edges
    mean_contention_factor: float = 1.0  # mean tau(b_i)/tau(b_eff) over rings
    lost_embeddings: int = 0           # rings voided by mid-slot failures


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Outcome of one driver run: per-slot records, final state, event log."""

    scheduler: str
    records: List[SlotRecord]
    state: ScheduleState
    completion_slot: Dict[int, Optional[int]]
    events: List[ClusterEvent] = dataclasses.field(default_factory=list)

    @property
    def total_utility(self) -> float:
        return self.state.total_utility()

    def embedded_ratio(self) -> float:
        num = sum(r.n_embedded for r in self.records)
        den = sum(r.n_active for r in self.records)
        return num / den if den else 0.0

    def avg_jct(self) -> float:
        jcts = [
            c - self.state.inst.job(j).arrival + 1
            for j, c in self.completion_slot.items()
            if c is not None
        ]
        return float(np.mean(jcts)) if jcts else float("nan")

    # -- event-log-derived metrics -----------------------------------------
    def first_embed_slots(self) -> Dict[int, Optional[int]]:
        """Per job, the first slot a ring was committed for it (from the
        EmbeddingCommitted events), or None if it was never scheduled."""
        first: Dict[int, int] = {}
        for ev in self.events:
            if isinstance(ev, EmbeddingCommitted):
                first.setdefault(ev.job_id, ev.t)
        return {jid: first.get(jid) for jid in self.completion_slot}

    def queueing_delays(self) -> Dict[int, Optional[int]]:
        """Per job, slots spent waiting: first-embedding slot minus a_i
        (None if never scheduled)."""
        first = self.first_embed_slots()
        return {
            jid: (f - self.state.inst.job(jid).arrival) if f is not None
            else None
            for jid, f in first.items()
        }

    def avg_queueing_delay(self) -> float:
        delays = [d for d in self.queueing_delays().values() if d is not None]
        return float(np.mean(delays)) if delays else float("nan")

    def makespan(self) -> float:
        """Slots until the last job completes (nan while any job is
        unfinished at the end of the horizon)."""
        done = [c for c in self.completion_slot.values() if c is not None]
        if not done or len(done) != len(self.completion_slot):
            return float("nan")
        return float(max(done) + 1)
