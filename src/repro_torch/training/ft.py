"""Fault tolerance at the training-runner level (the counterpart of
``repro.training.ft``).

A large deployment loses nodes routinely; the runner must (a) checkpoint on
a cadence, (b) detect failures and stragglers via heartbeats, (c) resume
from the last checkpoint with whatever workers remain (elastic restart),
losing at most one checkpoint interval of work. The cluster-side
counterpart (server failure and straggler injection, re-embedding) lives in
``sched.driver``.

Two behaviours are the reference's and are kept as they are:
``checkpoint_every`` is stored and never read (the trainer checkpoints at
the end of every slot that has a ``checkpoint_dir``), and a failure is
handled at the start of a slot, whose rerun on the survivors drops the
plan's ``leave``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.training.elastic import ElasticTrainer, SlotPlan


@dataclasses.dataclass
class Heartbeat:
    worker: int
    step: int
    t: float
    step_time: float


class HeartbeatMonitor:
    """Flags dead (no heartbeat past timeout) and straggling (step time
    beyond multiplier x median) workers."""

    def __init__(self, timeout: float = 10.0, straggler_factor: float = 2.5):
        self.timeout = timeout
        self.straggler_factor = straggler_factor
        self.last: Dict[int, Heartbeat] = {}

    def beat(self, hb: Heartbeat) -> None:
        self.last[hb.worker] = hb

    def dead(self, now: float) -> List[int]:
        return [w for w, hb in self.last.items() if now - hb.t > self.timeout]

    def stragglers(self) -> List[int]:
        times = [hb.step_time for hb in self.last.values()]
        if len(times) < 2:
            return []
        med = float(np.median(times))
        return [w for w, hb in self.last.items()
                if hb.step_time > self.straggler_factor * med]


class FaultTolerantRunner:
    """Wraps ElasticTrainer with checkpoint cadence + failure recovery.

    ``fail_injector(slot) -> Optional[int]`` simulates a node loss mid-slot
    (returns surviving worker count). On failure: restore the last
    checkpoint, shrink DP to the survivors, rerun the slot remainder.
    """

    def __init__(self, trainer: ElasticTrainer, *, checkpoint_every: int = 1,
                 fail_injector: Optional[Callable[[int], Optional[int]]] = None):
        if not trainer.checkpoint_dir:
            raise ValueError("FT runner requires a checkpoint dir")
        self.trainer = trainer
        self.checkpoint_every = checkpoint_every
        self.fail_injector = fail_injector
        self.recoveries = 0

    def run(self, plans: List[SlotPlan]) -> Dict[str, float]:
        for slot_idx, plan in enumerate(plans):
            survivors = None
            if self.fail_injector is not None:
                survivors = self.fail_injector(slot_idx)
            if survivors is not None and survivors < plan.workers:
                # failure mid-slot: progress since last checkpoint is lost
                restored = self.trainer.restore()
                self.recoveries += 1
                plan = SlotPlan(workers=max(survivors, 1), steps=plan.steps)
                if not (restored or self.trainer.step == 0):
                    raise RuntimeError(
                        f"slot {slot_idx}: no checkpoint to restore at step "
                        f"{self.trainer.step}")
            self.trainer.run_slot(plan)
        return {
            "final_step": self.trainer.step,
            "recoveries": self.recoveries,
            "final_loss": self.trainer.losses[-1] if self.trainer.losses
            else float("nan"),
        }
