"""Architecture configs (one module per arch) + input shapes: the
reference's ten."""

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
    arctic_480b,
    granite_3_2b,
    h2o_danube_1p8b,
    internvl2_26b,
    phi3_medium_14b,
    phi3p5_moe_42b,
    qwen3_0p6b,
    rwkv6_7b,
    whisper_large_v3,
    zamba2_1p2b,
)
