"""Cluster substrate: fat-tree topology, synthetic job traces and Eq. (1)
calibration (the ported part of ``repro.cluster``)."""

from repro_torch.cluster.topology import (  # noqa: F401
    Embedding,
    Link,
    ResourceState,
    Server,
    SubstrateGraph,
    make_fat_tree,
)
from repro_torch.cluster.trace import JobTraceConfig, generate_jobs  # noqa: F401
from repro_torch.cluster.calibrate import (  # noqa: F401
    RingTimingSample,
    calibrate_profile,
    fit_comm_model,
    load_timings,
)
