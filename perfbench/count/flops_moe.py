"""Forward model flops of one sequence of a routed-expert transformer
(:mod:`perfbench.count.model`)."""

from __future__ import annotations

from typing import Dict

from perfbench import count


def forward(s: Dict, seq: int) -> float:
    """Per layer the q, k, v and output products, the router and the top-k
    experts' SwiGLU products; the head; causal attention, 4 D a visible
    pair a head."""
    d, hd = s["hidden_size"], s["head_dim"]
    h, kv = s["num_attention_heads"], s["num_key_value_heads"]
    attn = 2 * d * hd * (2 * h + 2 * kv)
    experts = s["num_experts_per_tok"] * 2 * 3 * d * s["intermediate_size"]
    router = 2 * d * s["num_local_experts"]
    per_token = s["num_hidden_layers"] * (attn + experts + router)
    per_token += 2 * d * s["vocab_size"]
    pairs = count.visible_pairs(seq, seq, True, None)
    return per_token * seq + s["num_hidden_layers"] * 4.0 * hd * h * pairs
