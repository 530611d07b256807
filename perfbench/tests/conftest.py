"""The zamba2 family's small size for the benchmark's CPU tests:
``small.SIZES`` holds one entry a family, and the tests that run every cell
at the small size (``test_perfbench_run.py``) read it. Six layers, hybrid
layers 1, 3 and 5 (the two shared blocks used A, B, A), two B/C groups, the
head dim and scale of the published block's form, every width cut."""

from perfbench.tests import small

ZAMBA2 = (
    {"num_hidden_layers": 6, "hidden_size": 64, "attention_hidden_size": 128,
     "num_attention_heads": 4, "num_key_value_heads": 4, "attention_head_dim": 32,
     "attention_scale": (32 / 2) ** -0.5, "intermediate_size": 96,
     "adapter_rank": 8, "hybrid_layer_ids": [1, 3, 5], "mamba_d_state": 16,
     "mamba_headdim": 16, "n_mamba_heads": 8, "vocab_size": 256},
    {"n_layers": 6, "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 32,
     "d_ff": 96, "vocab": 256, "ssm_state": 16, "ssm_head_dim": 16,
     "hybrid_layers": [1, 3, 5], "adapter_rank": 8, "ssm_chunk": 8, "remat": False})
small.SIZES.setdefault("zamba2", ZAMBA2)
