"""Baseline schedulers — paper §VI-2: FIFO, DRF, LAS (Tiresias).

None of these are topology-aware; per the paper, "we place workers based on
the simple heuristic that greedily allocates workers to servers where a cycle
can be attained" — implemented here as :func:`greedy_cycle_place`, shared by
all baselines so the comparison isolates the *scheduling policy*. All
baselines implement the :class:`repro_torch.sched.api.Scheduler` protocol and
register into :mod:`repro_torch.sched.registry`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.cluster.topology import Embedding, ResourceState
from repro_torch.core.gvne import _ring_order, build_embedding
from repro_torch.core.problem import Job, ScheduleState
from repro_torch.sched.api import SchedulerBase, SchedulerContext, SlotDecision
from repro_torch.sched.registry import register


def greedy_cycle_place(
    res: ResourceState, job: Job, workers: int
) -> Optional[Embedding]:
    """Greedy worker placement forming a valid ring (paper §VI-2 heuristic).

    Try to colocate on the single freest server; otherwise greedily take
    capacity from the freest servers (rack-local order) until ``workers`` are
    placed and a bandwidth-feasible cycle exists. Falls back to fewer workers
    only by the caller's choice. Candidates are ordered by
    ``(-capacity, server_id)`` so placements are reproducible regardless of
    dict iteration details.
    """
    if workers <= 0:
        return None
    caps = {
        s.id: res.max_workers_on_server(s.id, job.demands, cap=job.max_workers)
        for s in res.graph.servers
    }
    # colocate if possible (deterministic tie-break: lowest server id wins)
    best = min(caps, key=lambda s: (-caps[s], s))
    if caps[best] >= workers:
        return build_embedding(res, job, [best], [workers])
    # spread greedily over freest servers
    order = sorted((s for s, c in caps.items() if c > 0),
                   key=lambda s: (-caps[s], s))
    chosen: List[int] = []
    counts: List[int] = []
    remaining = workers
    for s in order:
        take = min(caps[s], remaining)
        chosen.append(s)
        counts.append(take)
        remaining -= take
        if remaining == 0:
            break
    if remaining > 0:
        return None
    ring = _ring_order(chosen, res.graph)
    cmap = dict(zip(chosen, counts))
    return build_embedding(res, job, ring, [cmap[s] for s in ring])


class BaselineScheduler(SchedulerBase):
    """Paper §VI-2 baseline template.

    The paper's baselines use *static* resource allocation: each job's worker
    count is fixed within [1, 10] at submission and never adapts ("the number
    of workers remains fixed throughout the training process"). If the fixed
    ring cannot be placed in a slot, the job simply waits — no graceful
    degradation. Pass ``elastic=True`` for our strengthened (beyond-paper)
    variants that adapt the worker count to residual capacity.
    """

    name = "baseline"

    def __init__(self, fixed_worker_range: tuple = (1, 10), seed: int = 0,
                 elastic: bool = False):
        self.fixed_worker_range = fixed_worker_range
        self.elastic = elastic
        self.rng = np.random.default_rng(seed)
        self._fixed: Dict[int, int] = {}

    def _order(self, t: int, jobs: List[Job], state: ScheduleState) -> List[Job]:
        raise NotImplementedError

    def _workers_for(self, job: Job, state: ScheduleState) -> int:
        if job.id not in self._fixed:
            lo, hi = self.fixed_worker_range
            # static count, clipped to N_i so constraint (2) stays respected
            self._fixed[job.id] = int(min(self.rng.integers(lo, hi + 1),
                                          job.max_workers))
        return int(min(self._fixed[job.id],
                       np.floor(state.remaining(job) + 1e-9)))

    def decide(self, ctx: SchedulerContext) -> SlotDecision:
        t, res, state = ctx.t, ctx.res, ctx.state
        active = state.active_jobs(t)
        embeddings: List[Embedding] = []
        value = 0.0
        for job in self._order(t, list(active), state):
            w = self._workers_for(job, state)
            emb = greedy_cycle_place(res, job, w) if w >= 1 else None
            if emb is None and self.elastic:
                while w >= 1 and emb is None:  # beyond-paper graceful degrade
                    emb = greedy_cycle_place(res, job, w)
                    w -= 1
            if emb is not None:
                res.commit(emb, job.demands)
                value += state.marginal_utility(job, emb.n_workers)
                embeddings.append(emb)
        return SlotDecision(t, embeddings, 0.0, value, len(active), len(embeddings))


class FifoScheduler(BaselineScheduler):
    """FIFO (Hadoop/Spark): arrival order, static worker count."""

    name = "fifo"

    def _order(self, t, jobs, state):
        return sorted(jobs, key=lambda j: (j.arrival, j.id))


class DrfScheduler(BaselineScheduler):
    """Dominant Resource Fairness (YARN/Mesos): ascending dominant share."""

    name = "drf"

    def _order(self, t, jobs, state):
        totals = state.inst.graph.total_caps()

        def dominant_share(j: Job) -> float:
            used = state.z[j.id]  # accumulated worker-time as usage proxy
            return max(
                (used * l) / totals[r] for r, l in j.demands.items() if totals.get(r)
            )

        return sorted(jobs, key=lambda j: (dominant_share(j), j.id))


class LasScheduler(BaselineScheduler):
    """Least Attained Service (Tiresias): ascending accumulated GPU-time,
    round-robin within ties; static worker count."""

    name = "las"

    def _order(self, t, jobs, state):
        return sorted(jobs, key=lambda j: (state.z[j.id], (j.id + t) % max(len(jobs), 1)))


BASELINES = {
    "fifo": FifoScheduler,
    "drf": DrfScheduler,
    "las": LasScheduler,
}

for _name, _cls in BASELINES.items():
    register(_name, lambda seed=0, _cls=_cls, **kw: _cls(seed=seed, **kw))
    # beyond-paper strengthened variants: adapt worker count to residual
    # capacity instead of waiting for the full static ring
    register(f"{_name}+elastic",
             lambda seed=0, _cls=_cls, **kw: _cls(seed=seed, elastic=True, **kw))
