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
from repro_torch.configs import qwen3_0p6b  # noqa: F401
