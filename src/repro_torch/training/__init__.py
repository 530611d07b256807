"""Training substrate: optimizer, ring train step, checkpointing, elasticity,
fault tolerance."""

from repro_torch.training.ft import (  # noqa: F401
    FaultTolerantRunner,
    Heartbeat,
    HeartbeatMonitor,
)
