"""OnlineDriver — the single slot loop for every scheduler and scenario.

Owns what the two retired loops (``run_offline_horizon`` in core.gadget and
``ClusterSimulator.run`` in cluster.simulator — both now thin shims over
this class) used to hardwire:

  * the slot loop over t = 0..T-1 with a fresh per-slot ResourceState
    (embeddings last one slot — the paper's preemptive-job assumption);
  * event dispatch: pre-slot events (repairs, straggler onset, arrivals) are
    applied and delivered to ``scheduler.on_event`` *before* the decision;
    mid-slot events (the failure wave, scripted membership changes) strike
    *after* placement;
  * accounting: one ``ScheduleState.commit_slot(embeddings, factors)`` call
    per slot (the z_{i,t} update, Algorithm 1 line 6), the per-slot
    :class:`SlotRecord`, and the typed event log.

*Execution* — what a committed slot actually delivers — is delegated to an
:class:`~repro_torch.sched.backend.ExecutionBackend`:

    outcome = backend.execute_slot(decision, SlotExecution(ctx, wave, left))

The backend receives the scheduler's decision plus the mid-slot view (the
failure wave, departed workers) and returns one progress factor per
embedding; the driver commits those factors verbatim. The default
:class:`~repro_torch.sched.backend.AnalyticBackend` reproduces the paper's
closed-form pricing — mid-slot failures void a ring's slot progress,
stragglers run a synchronous ring at its slowest member, contention
re-prices rings at their fair-share effective bandwidth
(tau(b_i)/tau(b_eff), Eq. (1)), and a mid-slot WorkerLeave credits only the
surviving fraction of the ring. :class:`~repro_torch.sched.backend.LiveBackend`
instead runs each scheduled job's :class:`~repro_torch.training.elastic.
ElasticTrainer` for the slot and reports *measured* progress.

With faults and contention off the driver is bit-identical to the plain
horizon loop; with the default :class:`FaultEventStream` it is bit-identical
to the retired simulator for any seed (same RNG draw order).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np

from repro_torch.analysis.sanitize import SlotSanitizer, sanitize_enabled
from repro_torch.cluster.topology import Embedding, ResourceState
from repro_torch.core.problem import DDLJSInstance, ScheduleState
from repro_torch.sched.api import (
    ContentionConfig,
    Scheduler,
    SchedulerContext,
    SimResult,
    SlotRecord,
    as_scheduler,
)
from repro_torch.sched.backend import (
    AnalyticBackend,
    ExecutionBackend,
    SlotExecution,
)
from repro_torch.sched.events import (
    ClusterEvent,
    EmbeddingCommitted,
    EventStream,
    FaultConfig,
    FaultEventStream,
    JobArrival,
    JobCompletion,
    RequestArrival,
    RequestCompletion,
    RequestFirstToken,
    ServerFailure,
    ServerRecovery,
    SlotTick,
    StragglerEnd,
    StragglerOnset,
    WorkerJoin,
    WorkerLeave,
)


class OnlineDriver:
    """Drive any :class:`~repro_torch.sched.api.Scheduler` over a DDLJS instance.

    ``events`` defaults to a :class:`FaultEventStream` built from ``faults``;
    pass a :class:`ScriptedEventStream` / :class:`CompositeEventStream` for
    bespoke scenarios. The stream is ``reset()`` at the start of every run,
    so one driver replays identically across runs (same seed, same result).

    ``backend`` selects the slot executor (default
    :class:`~repro_torch.sched.backend.AnalyticBackend`); pass a
    :class:`~repro_torch.sched.backend.LiveBackend` to bind decisions to real
    elastic training. Note the replay guarantee above is stated for the
    analytic backend: a live run measures wall time and (with its default
    ``calibrate=True``) refits the instance's job profiles in place — see
    :class:`~repro_torch.sched.backend.LiveBackend` for the replay caveats.

    ``sanitize`` attaches the :class:`~repro_torch.analysis.sanitize.SlotSanitizer`
    — per-slot re-derivation of the capacity/budget/utility invariants, the
    domain analogue of running under ASan. ``None`` (default) defers to the
    ``REPRO_SANITIZE`` environment variable. The sanitizer only reads state,
    so a sanitized run is bit-identical to the default path (pinned in
    tests/test_analysis.py).
    """

    def __init__(
        self,
        inst: DDLJSInstance,
        *,
        faults: Optional[FaultConfig] = None,
        contention: Optional[ContentionConfig] = None,
        events: Optional[EventStream] = None,
        backend: Optional[ExecutionBackend] = None,
        sanitize: Optional[bool] = None,
    ):
        if faults is not None and events is not None:
            raise ValueError(
                "pass either faults= or events=, not both — to combine "
                "stochastic faults with a scripted scenario, compose them: "
                "events=CompositeEventStream([FaultEventStream(ids, faults), "
                "scripted])"
            )
        self.inst = inst
        self.faults = faults or FaultConfig()
        self.contention = contention or ContentionConfig()
        self.events = events if events is not None else FaultEventStream(
            [s.id for s in inst.graph.servers], self.faults
        )
        self.backend = backend if backend is not None else AnalyticBackend()
        self.sanitize = sanitize_enabled(sanitize)

    def run(self, scheduler: Union[Scheduler, str, None] = None) -> SimResult:
        if scheduler is None:
            scheduler = "gadget"
        if isinstance(scheduler, str):
            from repro_torch.sched.registry import create

            scheduler = create(scheduler)
        sched = as_scheduler(scheduler)

        inst = self.inst
        stream = self.events
        stream.reset()
        sanitizer = SlotSanitizer() if self.sanitize else None
        state = ScheduleState(inst)
        failed: set = set()
        straggling: Dict[int, float] = {}
        records: List[SlotRecord] = []
        completion: Dict[int, Optional[int]] = {j.id: None for j in inst.jobs}
        log: List[ClusterEvent] = []

        # -- per-run indexes: replace the O(jobs)-per-slot scans ------------
        # arrival index: jobs grouped by a_i, preserving inst.jobs order
        arrivals_at: Dict[int, List[int]] = {}
        for j in inst.jobs:
            arrivals_at.setdefault(j.arrival, []).append(j.id)
        # completion index: a job's remaining budget only changes through
        # commit_slot, so after the initial sweep (which catches zero-budget
        # jobs) only jobs committed this slot can newly complete
        job_order = {j.id: k for k, j in enumerate(inst.jobs)}
        jobs_by_id = {j.id: j for j in inst.jobs}
        pending = set(job_order)

        for t in range(inst.horizon):
            # -- pre-slot events: arrivals + repairs + straggler transitions
            pre: List[ClusterEvent] = [SlotTick(t)]
            pre += [JobArrival(t, jid) for jid in arrivals_at.get(t, ())]
            pre += stream.pre_slot(t)
            for ev in pre:
                if isinstance(ev, ServerRecovery):
                    failed.discard(ev.server_id)
                elif isinstance(ev, ServerFailure):
                    failed.add(ev.server_id)  # pre-slot failure: down before
                    straggling.pop(ev.server_id, None)  # scheduling
                elif isinstance(ev, StragglerOnset):
                    straggling[ev.server_id] = ev.factor
                elif isinstance(ev, StragglerEnd):
                    straggling.pop(ev.server_id, None)
                elif isinstance(ev, RequestArrival):
                    # no driver state: the scheduler prices the backlog via
                    # on_event below, and the serving backend consumes the
                    # arrival from SlotExecution.pre_events
                    pass

            res = ResourceState(
                inst.graph, oversubscription=self.contention.oversubscription
            )
            down_now = frozenset(failed)
            for sid in sorted(down_now):  # zero capacity of failed servers
                for r in res.free_node[sid]:
                    res.free_node[sid][r] = 0.0

            ctx = SchedulerContext(
                t=t,
                res=res,
                state=state,
                contention=self.contention,
                failed=down_now,
                straggling=dict(straggling),
            )
            for ev in pre:
                log.append(ev)
                sched.on_event(ev, ctx)

            # -- the decision (Algorithm 1 line 4); scheduler commits into res
            decision = sched.schedule_slot(ctx)

            # -- mid-slot events: the failure wave + scripted ring changes
            mid = stream.mid_slot(t)
            wave: set = set()
            left: Dict[int, int] = {}
            for ev in mid:
                if isinstance(ev, ServerFailure):
                    wave.add(ev.server_id)
                    failed.add(ev.server_id)
                    # a downed server stops straggling (the pre-slot branch
                    # already did this); without the pop a recovered server
                    # kept being priced at straggler speed
                    straggling.pop(ev.server_id, None)
                elif isinstance(ev, ServerRecovery):
                    failed.discard(ev.server_id)
                elif isinstance(ev, StragglerOnset):  # affects later slots
                    straggling[ev.server_id] = ev.factor
                elif isinstance(ev, StragglerEnd):
                    straggling.pop(ev.server_id, None)
                elif isinstance(ev, WorkerLeave):
                    left[ev.job_id] = left.get(ev.job_id, 0) + ev.n
                elif isinstance(ev, WorkerJoin):
                    # explicitly ignored mid-slot: joins reshape rings at
                    # the next slot boundary (events.py contract) — the
                    # decision for this slot has already been placed
                    pass
                log.append(ev)
                sched.on_event(ev, ctx)

            # -- execution (analytic pricing or real training) + accounting
            committed: List[Embedding] = list(decision.embeddings)
            for e in committed:
                assert e.job_id in res.committed, \
                    "scheduler must commit embeddings"
            outcome = self.backend.execute_slot(
                decision,
                SlotExecution(ctx=ctx, wave=frozenset(wave), left=left,
                              pre_events=tuple(pre)),
            )
            if len(outcome.factors) != len(committed):
                raise ValueError(
                    f"{getattr(self.backend, 'name', self.backend)!r} "
                    f"backend returned {len(outcome.factors)} factors for "
                    f"{len(committed)} embeddings"
                )
            placed = 0
            effective = 0.0
            for e, factor in zip(committed, outcome.factors):
                placed += e.n_workers
                effective += factor * e.n_workers
                log.append(EmbeddingCommitted(t, e.job_id, e.n_workers))
            # z + history accounting via the single shared path
            state.commit_slot(committed, outcome.factors)

            # execution-generated events (the serving backend's request
            # lifecycle) join the log before the sanitizer runs, so its
            # serving-accounting check re-derives SLO attainment from
            # exactly the log a replay of this run would see
            for ev in outcome.events:
                if isinstance(ev, (RequestFirstToken, RequestCompletion)):
                    # explicitly log-only: TTFT/TPOT/attainment are derived
                    # from the event log, never from driver state
                    pass
                log.append(ev)
                sched.on_event(ev, ctx)

            if sanitizer is not None:  # read-only invariant re-derivation
                sanitizer.check_slot(ctx=ctx, committed=committed,
                                     outcome=outcome, events=log)

            # completion check over the candidate set only: the initial sweep
            # (t=0) covers jobs whose budget starts exhausted; afterwards only
            # jobs whose z changed this slot can cross the threshold. Checked
            # in inst.jobs order, so the event log is identical to a full
            # per-slot sweep.
            if t == 0:
                candidates = list(pending)
            else:
                candidates = {e.job_id for e in committed} & pending
            for jid in sorted(candidates, key=job_order.__getitem__):
                if state.remaining(jobs_by_id[jid]) <= 1e-9:
                    pending.discard(jid)
                    completion[jid] = t
                    ev = JobCompletion(t, jid)
                    log.append(ev)
                    sched.on_event(ev, ctx)

            records.append(
                SlotRecord(
                    t=t,
                    n_active=decision.n_active,
                    n_embedded=len(committed),
                    workers_placed=placed,
                    effective_worker_time=effective,
                    utility_total=state.total_utility(),
                    # utilization over healthy capacity only: servers that
                    # were down when the slot was scheduled don't count as
                    # "in use"
                    gpu_utilization=res.utilization(exclude=down_now).get(
                        "gpus", 0.0
                    ),
                    failed_servers=len(failed),
                    max_edge_contention=res.max_edge_contention(),
                    mean_contention_factor=(
                        float(np.mean(outcome.contention_factors))
                        if outcome.contention_factors
                        else 1.0
                    ),
                    lost_embeddings=outcome.lost,
                )
            )
        return SimResult(
            scheduler=sched.name,
            records=records,
            state=state,
            completion_slot=completion,
            events=log,
        )
