"""internvl2-26b [vlm]: InternViT (stub) + InternLM2 backbone.

[arXiv:2404.16821; hf] 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553, head_dim=128. ``input_specs`` provides precomputed patch
embeddings (B, 256, d) — the vision tower is stubbed in this repo;
patch embeddings are prepended to the token sequence.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92553,
    n_patches=256,
    fsdp=True,
))
