"""phi3.5-moe-42b-a6.6b [moe]: 16 experts top-2.

[hf:microsoft/Phi-3.5-MoE-instruct; hf] 32L d_model=4096 32H (GQA kv=8)
d_ff=6400 vocab=32064, MoE 16e top-2 (one expert per model shard at TP=16).
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi3.5-moe-42b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab=32064,
    n_experts=16,
    top_k=2,
    moe_dff=6400,
    dense_residual=False,
    fsdp=True,
))
