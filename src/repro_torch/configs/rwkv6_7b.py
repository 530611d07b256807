"""rwkv6-7b [ssm/linear-attention]: Finch — data-dependent decay, attn-free.

[arXiv:2404.05892; hf] 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536, wkv head_dim=64 (64 heads).
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-7b",
    family="rwkv",
    n_layers=32,
    d_model=4096,
    n_heads=64,           # wkv heads = d_model / rwkv_head_dim
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab=65536,
    rwkv_head_dim=64,
    fsdp=True,
))
