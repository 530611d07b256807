"""whisper-large-v3 [audio]: encoder-decoder; conv/mel frontend is a STUB.

[arXiv:2212.04356; unverified] 32L d_model=1280 20H (MHA kv=20) d_ff=5120
vocab=51866, head_dim=64. 32 encoder + 32 decoder layers (whisper-large
convention). ``input_specs`` provides precomputed frame embeddings
(B, 1500, d) — the conv frontend is stubbed in this repo. Decoder
self-attention uses RoPE (deviation from learned positions) so the 32k
decode shapes are well-defined on this backbone.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,          # decoder layers
    n_enc_layers=32,      # encoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    n_frames=1500,
    notes="frontend stubbed; RoPE decoder (deviation from learned pos emb)",
    fsdp=True,
    # 20 heads don't shard 16-way: the reference's layout shards the seq
    # dim instead
    sequence_parallel=True,
))
