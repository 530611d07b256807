"""The event-driven online scheduling API (the ported part of
``repro.sched``): typed cluster events and seeded event streams
(:mod:`.events`), the scheduler protocol and slot context (:mod:`.api`), the
execution backends (:mod:`.backend`: ``AnalyticBackend``, and
``LiveBackend`` over the port's elastic trainers), the one slot loop
(:mod:`.driver`), inference as a job class (:mod:`.serving`: serve jobs
with latency-SLO utilities, and ``ServingBackend`` over the port's
continuous-batching engines) and schedulers resolved by name
(:mod:`.registry`).
"""

from repro_torch.sched.events import (  # noqa: F401
    ClusterEvent,
    CompositeEventStream,
    DiurnalRequestStream,
    EmbeddingCommitted,
    EventStream,
    FaultConfig,
    FaultEventStream,
    JobArrival,
    JobCompletion,
    RequestArrival,
    RequestCompletion,
    RequestFirstToken,
    RequestStreamConfig,
    ScriptedEventStream,
    ServerFailure,
    ServerRecovery,
    SlotTick,
    StragglerEnd,
    StragglerOnset,
    WorkerJoin,
    WorkerLeave,
)
from repro_torch.sched.api import (  # noqa: F401
    ContentionConfig,
    LegacySchedulerAdapter,
    Scheduler,
    SchedulerBase,
    SchedulerContext,
    SimResult,
    SlotDecision,
    SlotRecord,
    as_scheduler,
    contention_factor,
)
from repro_torch.sched.backend import (  # noqa: F401
    AnalyticBackend,
    ExecutionBackend,
    LiveBackend,
    SlotExecution,
    SlotOutcome,
)
from repro_torch.sched.serving import (  # noqa: F401
    ServeJob,
    ServeSLO,
    ServingBackend,
    make_serve_job,
    slo_attainment_from_events,
)
from repro_torch.sched.driver import OnlineDriver  # noqa: F401
from repro_torch.sched import registry  # noqa: F401
from repro_torch.sched.registry import available, create, register  # noqa: F401
