"""qwen3-0.6b [dense]: qk_norm, GQA.

[hf:Qwen/Qwen3-8B; hf] 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936, head_dim=128 (Qwen3 uses decoupled head_dim), qk-norm.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
))
