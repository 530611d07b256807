"""Forward model flops of one RWKV-6 sequence (:mod:`perfbench.count.model`)."""

from __future__ import annotations

from typing import Dict

from perfbench import count


def forward(s: Dict, seq: int) -> float:
    """Per layer the time mix's r, k, v, g and output products and its
    decay LoRA, and the channel mix's key, value and receptance products;
    the head; the WKV as its chunked products."""
    d, f, lora = s["hidden_size"], s["intermediate_size"], s["decay_lora_rank"]
    per_token = s["num_hidden_layers"] * 2 * (6 * d * d + 2 * d * f + 2 * d * lora)
    per_token += 2 * d * s["vocab_size"]
    p = s["head_size"]
    heads = d // p
    wkv, _ = count.wkv6("fwd", [(1, seq, heads, p), (heads, p)],
                        ["float", "float"])
    return per_token * seq + s["num_hidden_layers"] * wkv
