"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; hf] 38L d_model=2048 32H (kv=32, MHA) d_ff=8192
vocab=32000, ssm_state=64. The single shared attention+MLP block is applied
every 6 mamba layers (weight-shared; Zamba2's per-use LoRA adapters omitted
— noted deviation).
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    notes="shared attn block every 6 mamba2 layers; LoRA-per-use omitted",
    fsdp=True,
))
