"""Architecture configs (one module per arch) + input shapes.

Only the families the port can build register here; others join as their
model families are ported.
"""

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    ShapeConfig,
    SHAPES,
    get_arch,
    list_archs,
    register,
)

# importing the arch modules populates the registry
from repro_torch.configs import (  # noqa: F401
    granite_3_2b,
    h2o_danube_1p8b,
    qwen3_0p6b,
    rwkv6_7b,
    zamba2_1p2b,
)
