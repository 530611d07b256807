"""Cluster substrate: fat-tree topology, traces, the time-slotted simulator
shim and Eq. (1) calibration (the counterpart of ``repro.cluster``)."""

from repro_torch.cluster.topology import (  # noqa: F401
    Embedding,
    Link,
    ResourceState,
    Server,
    SubstrateGraph,
    make_fat_tree,
)
from repro_torch.cluster.trace import JobTraceConfig, generate_jobs  # noqa: F401
from repro_torch.cluster.traces import (  # noqa: F401
    TraceJobRecord,
    jobs_from_trace,
    load_trace,
    save_trace,
    synthesize_pai_like,
)
from repro_torch.cluster.simulator import (  # noqa: F401
    ClusterSimulator,
    ContentionConfig,
    FaultConfig,
    SimResult,
)
from repro_torch.cluster.calibrate import (  # noqa: F401
    RingTimingSample,
    calibrate_profile,
    fit_comm_model,
    load_timings,
)
