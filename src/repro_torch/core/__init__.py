"""GADGET core: the paper's contribution (analytical model + algorithms);
the counterpart of ``repro.core``."""

from repro_torch.core.rar_model import (  # noqa: F401
    RarJobProfile,
    optimal_worker_count,
    profile_from_arch,
    rar_allreduce_time,
    rar_iteration_time,
    rar_iteration_time_asymptote,
    rar_ring_bytes_per_worker,
)
from repro_torch.core.utility import (  # noqa: F401
    Utility,
    energy_utility,
    log_utility,
    sigmoid_utility,
    sqrt_utility,
)
from repro_torch.core.problem import DDLJSInstance, Job, ScheduleState  # noqa: F401
from repro_torch.core.gvne import (  # noqa: F401
    GvneConfig,
    GvneResult,
    solve_slot,
    solve_slot_exact,
)
from repro_torch.core.gadget import GadgetScheduler, run_offline_horizon  # noqa: F401
from repro_torch.core.baselines import (  # noqa: F401
    BASELINES,
    DrfScheduler,
    FifoScheduler,
    LasScheduler,
)
