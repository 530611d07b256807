"""Deprecated shim — the slot loop lives in :mod:`repro_torch.sched.driver`
(the counterpart of ``repro.cluster.simulator``).

``ClusterSimulator`` used to own a second copy of the horizon loop (faults,
stragglers, contention, accounting). All of that is now
:class:`repro_torch.sched.driver.OnlineDriver` consuming a seeded
:class:`repro_torch.sched.events.FaultEventStream`; this module keeps the old
entry point and re-exports the moved types so existing imports keep working:

  * :class:`FaultConfig`      -> repro_torch.sched.events
  * :class:`ContentionConfig` -> repro_torch.sched.api
  * :class:`SlotRecord` / :class:`SimResult` -> repro_torch.sched.api
  * :func:`contention_factor` -> repro_torch.sched.api

``ClusterSimulator(inst, faults, contention).run(scheduler)`` is bit-identical
to the retired loop for any seed (the fault stream reproduces its RNG draw
order exactly) — but new code should construct an ``OnlineDriver`` directly.

One deliberate semantic change for repeated calls: each ``run()`` resets the
event stream, so every run on one simulator instance replays the *same*
fault/straggler sequence (the replay-determinism contract). The retired loop
instead advanced one shared RNG across calls; to compare runs under
independent fault draws, build one simulator/driver per seed.
"""

from __future__ import annotations

import warnings
from typing import Optional

from repro_torch.sched.api import (  # noqa: F401  (re-exports)
    ContentionConfig,
    SimResult,
    SlotRecord,
    contention_factor,
)
from repro_torch.sched.events import FaultConfig  # noqa: F401  (re-export)
from repro_torch.core.problem import DDLJSInstance


class ClusterSimulator:
    """Deprecated: thin wrapper over :class:`repro_torch.sched.driver.OnlineDriver`."""

    def __init__(
        self,
        inst: DDLJSInstance,
        faults: Optional[FaultConfig] = None,
        contention: Optional[ContentionConfig] = None,
    ):
        self.inst = inst
        self.faults = faults or FaultConfig()
        self.contention = contention or ContentionConfig()

    def run(self, scheduler) -> SimResult:
        warnings.warn(
            "ClusterSimulator is deprecated; use "
            "repro_torch.sched.OnlineDriver(inst, faults=..., contention=...)"
            ".run(scheduler)",
            DeprecationWarning,
            stacklevel=2,
        )
        from repro_torch.sched.driver import OnlineDriver

        driver = OnlineDriver(
            self.inst, faults=self.faults, contention=self.contention
        )
        return driver.run(scheduler)
