"""GADGET — Algorithm 1: online temporally greedy scheduling — paper §V-B.

The DDLJS objective is monotone submodular over the partition matroid whose
parts are the per-slot allocation spaces V[t] (Lemma 5); greedily committing
an alpha-approximate per-slot allocation yields an alpha/(alpha+1) competitive
schedule (Theorem 6, p-system with p=1). With the G-VNE per-slot solver
(alpha = 1/(3*Gamma)), GADGET is 1/(3*Gamma+1)-competitive (Theorem 10).

The scheduler is *online*: at slot t it sees only jobs with a_i <= t and its
own accumulated state z_{i,t-1}; it never looks ahead. It implements the
:class:`repro_torch.sched.api.Scheduler` protocol — the slot loop itself lives in
:class:`repro_torch.sched.driver.OnlineDriver` (``run_offline_horizon`` below is a
deprecation shim over it).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional, Sequence

from repro_torch.core.gvne import GvneConfig, GvneResult, solve_slot, solve_slot_exact
from repro_torch.core.problem import DDLJSInstance, Job, ScheduleState
from repro_torch.cluster.topology import ResourceState
from repro_torch.sched.api import SchedulerBase, SchedulerContext, SlotDecision
from repro_torch.sched.registry import register

__all__ = ["GadgetScheduler", "SlotDecision", "SlotSolver",
           "run_offline_horizon"]

SlotSolver = Callable[[ResourceState, Sequence[Job], ScheduleState], GvneResult]


class GadgetScheduler(SchedulerBase):
    """Online temporally greedy scheduler (Algorithm 1).

    Plug a per-slot solver: G-VNE (default, Algorithm 2) or the exact MILP
    (for Fig.-7-style approximation-ratio studies).
    """

    name = "gadget"

    def __init__(self, cfg: Optional[GvneConfig] = None, exact: bool = False):
        self.cfg = cfg or GvneConfig()
        self.exact = exact

    def decide(self, ctx: SchedulerContext) -> SlotDecision:
        """Contract: every returned embedding is committed into ``ctx.res``."""
        t, res, state = ctx.t, ctx.res, ctx.state
        active = state.active_jobs(t)  # line 3: I[t]
        if not active:
            return SlotDecision(t, [], 0.0, 0.0, 0, 0)
        cfg = dataclasses.replace(self.cfg, seed=self.cfg.seed + t)
        if self.exact:
            result = solve_slot_exact(res, active, state)
        else:
            result = solve_slot(res, active, state, cfg)  # line 4: Algorithm 2
        by_id = {j.id: j for j in active}
        for e in result.embeddings:
            res.commit(e, by_id[e.job_id].demands)
        return SlotDecision(
            t=t,
            embeddings=result.embeddings,
            lp_value=result.lp_value,
            value=result.value,
            n_active=len(active),
            n_embedded=len(result.embeddings),
        )


register("gadget",
         lambda seed=0, exact=False, **kw:
         GadgetScheduler(GvneConfig(seed=seed, **kw), exact=exact))
register("gadget-exact",
         lambda seed=0, **kw:
         GadgetScheduler(GvneConfig(seed=seed, **kw), exact=True))


def run_offline_horizon(
    inst: DDLJSInstance,
    scheduler: Optional[GadgetScheduler] = None,
) -> ScheduleState:
    """Deprecated shim: run Algorithm 1 over the whole horizon with per-slot
    resource resets and no faults/contention. Delegates to
    :class:`repro_torch.sched.driver.OnlineDriver`, which produces bit-identical
    z-vectors in this configuration; use the driver directly for anything
    richer (faults, stragglers, contention, scripted events)."""
    warnings.warn(
        "run_offline_horizon is deprecated; use "
        "repro_torch.sched.OnlineDriver(inst).run(scheduler)",
        DeprecationWarning,
        stacklevel=2,
    )
    from repro_torch.sched.driver import OnlineDriver

    return OnlineDriver(inst).run(scheduler or GadgetScheduler()).state
