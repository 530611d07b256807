"""h2o-danube-1.8b [dense]: llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; hf] 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000,
head_dim=80, SWA window 4096. The SWA window bounds the decode KV cache (ring
buffer), which is what qualifies this arch for long_500k.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab=32000,
    sliding_window=4096,
    fsdp=True,
))
