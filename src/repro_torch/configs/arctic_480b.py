"""arctic-480b [moe]: 128 experts top-2 + dense residual MLP.

[hf:Snowflake/snowflake-arctic-base; hf] 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000, MoE 128e top-2 with a parallel dense MLP (Snowflake's
dense-MoE hybrid). Uses Adafactor + FSDP, as the reference does: Adam's two
f32 moments of 480B parameters are what its sharded layout cannot hold.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,          # dense residual MLP hidden
    vocab=32000,
    n_experts=128,
    top_k=2,
    moe_dff=4864,
    dense_residual=True,
    optimizer="adafactor",
    fsdp=True,
    notes="EP over model axis (8 experts/shard at TP=16) + FSDP over data",
))
