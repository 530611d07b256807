"""DDLJS problem structures — paper §IV.

A :class:`Job` carries the per-worker demands l_i^r, the budgets F_i^r, the
per-slot worker cap N_i, the reserved ring bandwidth b_i, the per-worker
efficiency zeta_i (iterations per worker-slot via Eq. (1)), and the utility
mu_i. :class:`DDLJSInstance` bundles jobs + substrate + horizon.

Scheduling state (the z_{i,t} accumulators of §V-B) lives in
:class:`ScheduleState`, shared by GADGET and all baselines so metrics are
directly comparable.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional

if TYPE_CHECKING:  # annotation-only: a runtime import would close the
    # core.problem -> cluster -> cluster.trace -> core.problem cycle
    from repro_torch.cluster.topology import Embedding, SubstrateGraph

from repro_torch.core.rar_model import RarJobProfile
from repro_torch.core.utility import Utility


@dataclasses.dataclass
class Job:
    id: int
    arrival: int                      # a_i (slot index; unknown to scheduler)
    max_workers: int                  # N_i — per-slot concurrent worker cap
    demands: Dict[str, float]         # l_i^r per worker
    budgets: Dict[str, float]         # F_i^r total type-r budget
    bandwidth: float                  # b_i reserved ring bandwidth
    zeta: float                       # per-worker efficiency (e.g. iters/worker-slot)
    utility: Utility
    profile: Optional[RarJobProfile] = None  # Eq. (1) profile when derived from an arch
    arch: Optional[str] = None        # assigned architecture id, if any

    def worker_time_budget(self) -> float:
        """min_r F_i^r / l_i^r — the bottleneck worker-time budget (Eq. (11))."""
        lim = float("inf")
        for r, l in self.demands.items():
            if l > 0 and r in self.budgets:
                lim = min(lim, self.budgets[r] / l)
        return lim


@dataclasses.dataclass
class DDLJSInstance:
    graph: SubstrateGraph
    jobs: List[Job]
    horizon: int                      # T
    slot_seconds: float = 1.0

    def job(self, jid: int) -> Job:
        return self._by_id()[jid]

    def _by_id(self) -> Dict[int, Job]:
        """Id -> Job map, rebuilt whenever ``jobs`` has been mutated.

        Trace adapters append jobs to an existing instance; a once-built map
        would make those invisible to :meth:`job`. A length check catches the
        append pattern (the only supported mutation — replacing a job in
        place while keeping the count is not).
        """
        jmap = getattr(self, "_jmap", None)
        if jmap is None or len(jmap) != len(self.jobs):
            jmap = self._jmap = {j.id: j for j in self.jobs}
        return jmap


class ScheduleState:
    """Accumulated worker-time z_{i,t} and the active-set logic of §V-B.

    ``z`` is owned by :meth:`commit_slot` — the per-job utility cache behind
    :meth:`total_utility` is refreshed there (and on every
    :meth:`job_utility` call), so mutating ``z`` directly bypasses the
    accounting and leaves the cached utilities stale.
    """

    # test hook (tests/test_analysis.py): True makes commit_slot skip the
    # utility-cache refresh, simulating exactly the silent accounting drift
    # repro_torch.analysis.sanitize exists to catch. Never set outside tests.
    _test_skip_utility_refresh = False

    def __init__(self, inst: DDLJSInstance):
        self.inst = inst
        self.z: Dict[int, float] = {j.id: 0.0 for j in inst.jobs}
        self.history: Dict[int, List[Embedding]] = {j.id: [] for j in inst.jobs}
        # per-job caches keyed by job id: the worker-time budget is a pure
        # function of the (immutable) demands/budgets, and the utility only
        # changes when z does — both used to be recomputed O(jobs) per slot
        self._wtb: Dict[int, float] = {
            j.id: j.worker_time_budget() for j in inst.jobs
        }
        self._util: Dict[int, float] = {
            j.id: j.utility(j.zeta * 0.0) for j in inst.jobs
        }

    def _ensure(self, job: Job) -> None:
        """Admit a job appended to ``inst.jobs`` after this state was built
        (the trace-adapter pattern) into the accounting dicts."""
        if job.id not in self.z:
            self.z[job.id] = 0.0
            self.history[job.id] = []
            self._wtb[job.id] = job.worker_time_budget()
            self._util[job.id] = job.utility(job.zeta * 0.0)

    def remaining(self, job: Job) -> float:
        """Remaining worker-time: (min_r F_i^r / l_i^r) - z_{i,t-1} (Eq. (11))."""
        wtb = self._wtb.get(job.id)
        if wtb is None:
            self._ensure(job)
            wtb = self._wtb[job.id]
        return max(0.0, wtb - self.z[job.id])

    def active_jobs(self, t: int) -> List[Job]:
        """I[t] = {i : t >= a_i and z_{i,t-1} < min_r F_i^r / l_i^r}."""
        return [
            j for j in self.inst.jobs
            if t >= j.arrival and self.remaining(j) > 1e-9
        ]

    def commit_slot(
        self,
        embeddings: List[Embedding],
        factors: Optional[List[float]] = None,
    ) -> None:
        """Accumulate one slot's allocations into z and the history.

        ``factors`` scales each embedding's worker-time credit (straggler or
        contention slowdown: z += factor * n_workers); omitted means full
        credit. This is the single accounting path shared by
        ``run_offline_horizon`` and the cluster simulator.
        """
        if factors is None:
            factors = [1.0] * len(embeddings)
        if len(factors) != len(embeddings):
            raise ValueError("commit_slot: one factor per embedding required")
        for e, f in zip(embeddings, factors):
            if e.job_id not in self.z:
                self._ensure(self.inst.job(e.job_id))
            self.z[e.job_id] += f * e.n_workers
            self.history[e.job_id].append(e)
        # refresh the utility cache for the touched jobs only — total_utility
        # then sums cached values instead of re-evaluating every job's
        # utility function each slot (sorted so the refresh order, and hence
        # any float-dependent downstream consumer, is replayable)
        if not self._test_skip_utility_refresh:
            for jid in sorted({e.job_id for e in embeddings}):
                job = self.inst.job(jid)
                self._util[jid] = job.utility(job.zeta * self.z[jid])

    def job_utility(self, job: Job) -> float:
        self._ensure(job)
        u = job.utility(job.zeta * self.z[job.id])
        self._util[job.id] = u
        return u

    def total_utility(self) -> float:
        """Sum of per-job utilities at the current z.

        Reads the per-job cache (refreshed in :meth:`commit_slot`) in
        ``inst.jobs`` order with a plain Python sum, so the value is
        bit-identical to re-evaluating ``job_utility`` for every job — only
        the O(jobs) utility-function evaluations per call are gone.
        """
        util = self._util
        total = 0.0
        for j in self.inst.jobs:
            u = util.get(j.id)
            if u is None:  # appended after this state was built
                u = self.job_utility(j)
            total += u
        return total

    def marginal_utility(self, job: Job, extra_workers: int) -> float:
        """pi_{i,kappa}: mu(zeta(z + kappa)) - mu(zeta z) — §V-C."""
        base = job.zeta * self.z[job.id]
        return job.utility.marginal(base, job.zeta * extra_workers)
