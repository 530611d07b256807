"""Execution backends — bind slot decisions to whatever executes them (a
copy of ``repro.sched.backend``; :class:`LiveBackend` drives the port's
trainers).

The :class:`~repro_torch.sched.driver.OnlineDriver` owns *when* things happen (the
slot loop, event dispatch, commit accounting); an :class:`ExecutionBackend`
owns *what a committed slot delivers*: given the scheduler's
:class:`~repro_torch.sched.api.SlotDecision` and a :class:`SlotExecution` view of
what struck mid-slot, it returns a :class:`SlotOutcome` — one progress factor
per committed embedding, fed straight into ``ScheduleState.commit_slot``.

Two backends ship:

  * :class:`AnalyticBackend` — the paper's closed-form pricing (the code the
    driver used to inline, extracted verbatim so the default path stays
    bit-identical): mid-slot failures void a ring's slot, a synchronous ring
    runs at its slowest straggling member, a mid-slot ``WorkerLeave`` credits
    the surviving fraction, and contention re-prices at fair-share effective
    bandwidth (Eq. (1)).
  * :class:`LiveBackend` — the same decisions executed on *real* elastic
    training in PyTorch: each scheduled job's :class:`~repro_torch.training.
    elastic.ElasticTrainer` runs the slot on its ring's devices, a mid-slot ``WorkerLeave
    triggers :meth:`~repro_torch.training.elastic.RingWorkerGroup.re_ring` (the
    ring reforms over the survivors, no checkpoint restore), a mid-slot
    server failure restores the last checkpoint (the paper's preemption
    model), and the credited factor is the *measured* worker-time fraction.
    Measured per-step timings are fed through :mod:`repro_torch.cluster.calibrate`
    to refit each job's ``RarJobProfile.bandwidth`` online, so the
    scheduler's Eq. (1) pricing tracks the hardware it is actually driving
    (cf. Yu et al., arXiv:2207.07817 — measured, not assumed, contention).

A backend that wants different semantics (e.g. a trace replayer, an RPC shim
to a real cluster) implements ``execute_slot`` and hands the driver factors;
everything upstream — schedulers, events, metrics — is unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import (
    TYPE_CHECKING,
    Dict,
    List,
    Mapping,
    Optional,
    Protocol,
    Tuple,
    runtime_checkable,
)

from repro_torch.sched.api import SchedulerContext, SlotDecision
from repro_torch.cluster.calibrate import RingTimingSample, calibrate_profile

if TYPE_CHECKING:  # annotation-only (keeps torch out of the import path)
    from repro_torch.cluster.topology import Embedding
    from repro_torch.training.elastic import ElasticTrainer


@dataclasses.dataclass
class SlotExecution:
    """Everything a backend may consult when executing one slot.

    ``ctx`` is the slot's :class:`SchedulerContext` (resource state with the
    decision already committed, straggler map, contention pricing); ``wave``
    holds the servers that failed *after* placement (their rings lose the
    slot); ``left`` maps job id -> workers departing mid-slot;
    ``pre_events`` carries the slot's pre-decision event batch (arrivals,
    ticks — whatever the streams emitted) so workload-driven backends (e.g.
    serving, which consumes ``RequestArrival``) see the same events the
    driver dispatched, in the same order.
    """

    ctx: SchedulerContext
    wave: frozenset = frozenset()
    left: Mapping[int, int] = dataclasses.field(default_factory=dict)
    pre_events: Tuple = ()

    @property
    def t(self) -> int:
        return self.ctx.t


@dataclasses.dataclass
class SlotOutcome:
    """What one slot delivered, aligned with ``decision.embeddings``.

    ``factors[k]`` scales embedding k's worker-time credit in
    ``commit_slot`` (0.0 = slot voided); ``contention_factors`` lists the
    fair-share slowdowns of the rings that ran (feeds the slot record);
    ``lost`` counts rings voided by the mid-slot failure wave; ``measured``
    carries backend-specific per-job measurements (the live backend reports
    loss/steps/ring sizes — analytic execution leaves it empty); ``events``
    are execution-generated :class:`~repro_torch.sched.events.ClusterEvent`\\ s
    (e.g. the serving backend's request lifecycle) that the driver appends
    to the event log and dispatches to the scheduler after commit.
    """

    factors: List[float]
    contention_factors: List[float] = dataclasses.field(default_factory=list)
    lost: int = 0
    measured: Dict[int, Dict[str, object]] = dataclasses.field(
        default_factory=dict
    )
    events: List = dataclasses.field(default_factory=list)


@runtime_checkable
class ExecutionBackend(Protocol):
    """Structural type of slot executors (see module docstring)."""

    name: str

    def execute_slot(self, decision: SlotDecision,
                     execution: SlotExecution) -> SlotOutcome:
        ...


def audit_compiled_step_cache(group) -> List[str]:
    """Runtime half of the recompile-hazard analysis (axis iv of
    ``repro_torch.analysis.collectives``): verify a live ``RingWorkerGroup``'s
    compiled-step cache is keyed soundly. Returns problem strings (empty =
    clean); read-only.

    Invariants:

      * ``compile_count`` equals the number of cached programs — every miss
        compiled exactly one executable, so back-to-back same-sized slots
        cannot be silently re-tracing;
      * each cached program's ring spans exactly ``key.workers`` rank
        slots — a ring/key mismatch would run a w-keyed step on the wrong
        ring;
      * the closed-over static attrs (``STATIC_CLOSURE_ATTRS``) still match
        the construction-time fingerprint — a post-init mutation means the
        ``(workers, mode)`` key no longer identifies the executable's
        semantics and cached steps are stale.
    """
    problems: List[str] = []
    n_programs = len(group._programs)
    if group.compile_count != n_programs:
        problems.append(
            f"compile_count={group.compile_count} != {n_programs} cached "
            "program(s) — the (workers, mode) cache is re-tracing (or "
            "miscounting) compiled steps")
    for key, prog in group._programs.items():
        w = key[0]
        ring_size = len(prog.ring.devices)
        if ring_size != w:
            problems.append(
                f"program cached under workers={w} spans {ring_size} "
                "rank slot(s) — cache key and ring disagree")
        if key != group.cache_key(w):
            problems.append(
                f"cached key {key!r} != cache_key({w})={group.cache_key(w)!r}"
                " — the group's mode changed after this program compiled")
    fp = group.closure_fingerprint()
    if fp != group._closure_fingerprint:
        problems.append(
            "closed-over static attrs "
            f"{group.STATIC_CLOSURE_ATTRS} changed after construction "
            f"(fingerprint {group._closure_fingerprint!r} -> {fp!r}) — "
            "cached compiled steps are stale under the (workers, mode) key")
    return problems


def _slot_conditions(
    emb: Embedding, execution: SlotExecution
) -> Tuple[bool, float, float]:
    """(voided-by-wave, straggler slowdown, contention factor) of one ring.

    The single source of the per-ring cluster conditions, shared by both
    backends so the pricing semantics cannot drift between them.
    """
    ctx = execution.ctx
    if any(s in execution.wave for s in emb.servers):
        return True, 1.0, 1.0  # slot progress lost; job restarts from ckpt
    # straggler: synchronous ring runs at slowest member
    slow = 1.0
    for s in emb.servers:
        if s in ctx.straggling:
            slow = min(slow, ctx.straggling[s])
    return False, slow, ctx.contention_factor(emb)


def _analytic_embedding_factor(
    emb: Embedding, execution: SlotExecution
) -> Tuple[float, Optional[float]]:
    """The closed-form slot factor of one ring: (factor, contention factor).

    Contention factor is None when the ring was voided by the failure wave
    (the driver's historical accounting skips it in the slot record's mean).
    """
    voided, factor, cf = _slot_conditions(emb, execution)
    if voided:
        return 0.0, None
    if emb.job_id in execution.left and emb.n_workers > 0:
        # mid-slot leave: only the surviving fraction of the ring's
        # worker-time is credited (re-ring next slot)
        factor *= max(
            0.0, (emb.n_workers - execution.left[emb.job_id]) / emb.n_workers
        )
    return factor * cf, cf


class AnalyticBackend:
    """Closed-form slot execution — the paper's simulation pricing.

    Extracted verbatim from the pre-backend driver loop; for any seed the
    driver with this backend is bit-identical to the pre-refactor driver
    (golden-equivalence tests pin this).
    """

    name = "analytic"

    def execute_slot(self, decision: SlotDecision,
                     execution: SlotExecution) -> SlotOutcome:
        factors: List[float] = []
        contention: List[float] = []
        lost = 0
        for emb in decision.embeddings:
            factor, cf = _analytic_embedding_factor(emb, execution)
            if cf is None:
                lost += 1
            else:
                contention.append(cf)
            factors.append(factor)
        return SlotOutcome(factors=factors, contention_factors=contention,
                           lost=lost)


class LiveBackend:
    """Execute slot decisions on real elastic ring-all-reduce training.

    ``trainers`` maps job id -> :class:`ElasticTrainer`; a scheduled job
    without a trainer falls back to analytic pricing (mixed fleets work).
    Per committed ring, the backend

      1. scales the slot's nominal ``steps_per_slot`` by the analytic
         straggler/contention slowdown (emulated cluster conditions throttle
         the work actually submitted),
      2. runs the trainer for those steps at the scheduled ring size — a
         mid-slot ``WorkerLeave`` splits the slot at ``leave_fraction`` and
         finishes on the survivors via ``re_ring`` (no checkpoint restore),
         while a mid-slot server failure voids the slot and restores the
         last checkpoint,
      3. credits the *measured* worker-time fraction
         ``worker_steps / (steps_per_slot * n_workers)`` back into
         ``commit_slot`` — progress is what the hardware delivered, not what
         Eq. (1) predicted,
      4. folds the measured per-step timings (net of the profile's modeled
         compute time) into a per-job sample set and refits
         ``job.profile.bandwidth`` via
         :func:`repro_torch.cluster.calibrate.calibrate_profile` once the samples
         span more than one comm load (refits that the fit rejects — e.g.
         timing noise swamping the w-dependence — are skipped silently).

    ``reports`` accumulates one row per executed ring (slot, job, ring
    sizes, loss, credited factor) for dashboards/examples; ``calibrated``
    maps job id -> latest fitted bandwidth.

    .. note:: With ``calibrate=True`` (the default) the refit *mutates the
       instance's* ``Job.profile`` — that is the point of the feedback loop
       (subsequent scheduling decisions price against measured bandwidth),
       but it means a second run over the same ``DDLJSInstance`` starts
       from the refit values, and wall-clock timings are not replayable in
       general. For same-seed replay comparisons or multi-scheduler
       benchmarks on one instance, pass ``calibrate=False`` or call
       :meth:`restore_profiles` between runs (the pre-refit profiles are
       snapshotted in ``initial_profiles``).
    """

    name = "live"

    def __init__(self, trainers: Mapping[int, "ElasticTrainer"], *,
                 steps_per_slot: int = 4, leave_fraction: float = 0.5,
                 calibrate: bool = True, audit_cache: Optional[bool] = None):
        from repro_torch.analysis.sanitize import sanitize_enabled

        self.trainers = dict(trainers)
        self.steps_per_slot = int(steps_per_slot)
        self.leave_fraction = float(leave_fraction)
        self.calibrate = calibrate
        # sanitizer hook: after each executed ring, audit the trainer's
        # compiled-step cache (audit_compiled_step_cache). Defaults to the
        # REPRO_SANITIZE switch, like the driver's slot sanitizer; read-only
        # so an audited run stays bit-identical.
        self.audit_cache = sanitize_enabled(audit_cache)
        self.samples: Dict[int, List[RingTimingSample]] = {}
        self.calibrated: Dict[int, float] = {}
        self.initial_profiles: Dict[int, object] = {}  # pre-refit snapshots
        self._jobs: Dict[int, object] = {}             # refit Job objects
        self.reports: List[Dict[str, object]] = []
        self._n_params: Dict[int, int] = {}

    def restore_profiles(self) -> None:
        """Undo online calibration: restore every refit ``Job.profile`` to
        its pre-refit snapshot and drop the accumulated timing samples and
        reports (for replay/comparison runs on one instance — without the
        sample reset, the next run's first slot would instantly refit from
        the previous run's wall-clock measurements)."""
        for job_id, prof in self.initial_profiles.items():
            self._jobs[job_id].profile = prof
        self.calibrated.clear()
        self.samples.clear()
        self.reports.clear()

    # -- helpers ------------------------------------------------------------
    def _param_count(self, job_id: int, trainer) -> int:
        n = self._n_params.get(job_id)
        if n is None:
            from repro_torch.models.module import _flatten

            replica = next(iter(trainer.params.values()))
            n = int(sum(t.numel() for _, t in _flatten(replica)))
            self._n_params[job_id] = n
        return n

    def _modeled_compute(self, profile, trainer, world: int) -> float:
        """Eq. (1) compute seconds of one step at ring size ``world``."""
        per_worker = getattr(trainer, "global_batch", 0) / world
        return profile.t_fwd_per_sample * per_worker + profile.t_bwd

    def _effective_elements(self, d: int, w: int, compression) -> float:
        """Gradient size in f32-ring-equivalent elements for the comm fit.

        ``fit_comm_model`` fits the f32 ring's slope (wire bytes linear in
        d(w-1)/w). A compressed-ring job puts ~4x fewer bytes on the wire
        for the same d (~2x for the bf16 wire), so its measured timings
        must be fit at the byte count it actually sends — otherwise the
        refit inflates bandwidth and Eq. (1) then divides the
        already-compressed byte count by it, double-counting the saving.
        ``wire_formula`` dispatches every registered layout (int8,
        int8-fused, bf16-fused, fp8-fused), so a new wire format prices
        here without touching the backend.
        """
        if not compression:
            return float(d)
        from repro_torch.core.rar_model import (
            rar_ring_bytes_per_worker,
            wire_formula,
        )

        return float(d) * (
            wire_formula(compression).bytes_per_worker(d, w)
            / rar_ring_bytes_per_worker(d, w, elem_bytes=4))

    def _record_timings(self, job_id: int, trainer,
                        timings: Mapping[int, float], execution) -> None:
        if not self.calibrate or not timings:
            return
        job = execution.ctx.job(job_id)
        if job.profile is None:
            return  # nothing to refit
        d = self._param_count(job_id, trainer)
        compression = getattr(job.profile, "compression", None)
        bucket = self.samples.setdefault(job_id, [])
        for w, seconds in timings.items():
            if w >= 2 and seconds > 0:
                n_eff = self._effective_elements(d, int(w), compression)
                bucket.append(RingTimingSample(world=int(w),
                                               n_elements=n_eff,
                                               seconds=float(seconds)))
        if len({round(s.comm_load) for s in bucket if s.world >= 2}) < 2:
            return  # fit needs >= 2 distinct comm loads
        # a train step is compute + collective, and at fixed global batch
        # the per-worker compute C/w is itself affine in the comm load
        # d(w-1)/w — fed raw, it biases the fitted slope. When the profile's
        # Eq. (1) compute terms are consistent with the measurements,
        # subtract them so only the residual is attributed to the wire; when
        # they are not (e.g. a reduced stand-in model on CPU vs a full-scale
        # profile), the compute model does not describe this substrate —
        # attribute the whole step to the wire, the same conservative
        # convention fit_comm_model uses for G -> inf.
        compute_ok = all(
            s.seconds > self._modeled_compute(job.profile, trainer, s.world)
            for s in bucket
        )
        fit_samples = bucket if not compute_ok else [
            dataclasses.replace(
                s, seconds=s.seconds
                - self._modeled_compute(job.profile, trainer, s.world))
            for s in bucket
        ]
        try:
            refit = calibrate_profile(job.profile, fit_samples)
        except ValueError:
            return  # noisy/degenerate timings: keep the prior estimate
        self.initial_profiles.setdefault(job_id, job.profile)
        self._jobs[job_id] = job
        job.profile = refit
        self.calibrated[job_id] = refit.bandwidth

    # -- the backend contract ----------------------------------------------
    def execute_slot(self, decision: SlotDecision,
                     execution: SlotExecution) -> SlotOutcome:
        from repro_torch.training.elastic import SlotPlan

        factors: List[float] = []
        contention: List[float] = []
        measured: Dict[int, Dict[str, object]] = {}
        lost = 0
        for emb in decision.embeddings:
            trainer = self.trainers.get(emb.job_id)
            if trainer is None:
                factor, cf = _analytic_embedding_factor(emb, execution)
                if cf is None:
                    lost += 1
                else:
                    contention.append(cf)
                factors.append(factor)
                continue
            voided, slow, cf = _slot_conditions(emb, execution)
            if voided:
                # mid-slot server failure: the slot is lost and the job
                # resumes from its last checkpoint (the paper's preemption
                # model) — the one case that *does* restore
                trainer.restore()
                factors.append(0.0)
                lost += 1
                measured[emb.job_id] = {"restored": True, "steps": 0}
                continue
            contention.append(cf)
            n_leave = execution.left.get(emb.job_id, 0)
            if n_leave >= emb.n_workers > 0:
                # the *whole* ring departed mid-slot: no survivors to
                # re-ring over and the in-memory replicas left with them —
                # resume from the last checkpoint with zero credit, exactly
                # the analytic surviving-fraction-0 semantics
                trainer.restore()
                factors.append(0.0)
                measured[emb.job_id] = {"restored": True, "steps": 0}
                continue
            steps = max(1, round(self.steps_per_slot * slow * cf))
            leave = None
            if n_leave > 0:
                # a 1-step slot leaves before its only step (after=0): the
                # whole slot runs on the survivors, so the departure still
                # costs credited worker-time
                leave = (min(int(steps * self.leave_fraction), steps - 1),
                         n_leave)
            out = trainer.run_slot(
                SlotPlan(workers=emb.n_workers, steps=steps, leave=leave))
            if self.audit_cache:
                group = getattr(trainer, "group", None)
                if group is not None:
                    problems = audit_compiled_step_cache(group)
                    if problems:
                        from repro_torch.analysis.sanitize import SanitizerError

                        raise SanitizerError(
                            f"compiled-step cache audit failed for job "
                            f"{emb.job_id}: " + "; ".join(problems))
            nominal = self.steps_per_slot * max(emb.n_workers, 1)
            factor = min(1.0, out.get("worker_steps", 0) / nominal)
            factors.append(factor)
            self._record_timings(emb.job_id, trainer,
                                 out.get("timings", {}), execution)
            row = {"t": execution.t, "job_id": emb.job_id,
                   "scheduled_workers": emb.n_workers, "factor": factor,
                   **{k: out[k] for k in
                      ("steps", "loss", "workers", "worker_steps",
                       "re_rings") if k in out}}
            measured[emb.job_id] = row
            self.reports.append(row)
        return SlotOutcome(factors=factors, contention_factors=contention,
                           lost=lost, measured=measured)
