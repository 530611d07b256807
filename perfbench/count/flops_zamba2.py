"""Forward model flops of one Zamba2 sequence (:mod:`perfbench.count.model`)."""

from __future__ import annotations

from typing import Dict

from perfbench import count
from perfbench.count import ssd


def forward(s: Dict, seq: int) -> float:
    """Per Mamba2 layer ``in_proj`` and ``out_proj``, and the SSD as its
    chunked products (:func:`perfbench.count.ssd.forward_ops`); per use of a
    shared block its q, k, v and o products over the concatenated width,
    the MLP's gate, up and down, the use's LoRA and ``linear``, and causal
    attention, 4 D a visible pair a head; the head. The conv, norms and
    gates are not products and count nothing."""
    d, a, f = s["hidden_size"], s["attention_hidden_size"], s["intermediate_size"]
    h, kv, hd = s["num_attention_heads"], s["num_key_value_heads"], s["attention_head_dim"]
    din = s["mamba_expand"] * d
    g, n, nh = s["mamba_ngroups"], s["mamba_d_state"], s["n_mamba_heads"]
    layers = s["num_hidden_layers"]
    uses = sum(1 for i in s["hybrid_layer_ids"] if i < layers)
    mamba = 2 * d * (2 * din + 2 * g * n + nh) + 2 * din * d
    shared = (2 * a * hd * (h + 2 * kv) + 2 * h * hd * d + 3 * 2 * d * f
              + 2 * d * s["adapter_rank"] + 2 * s["adapter_rank"] * 2 * f + 2 * d * d)
    per_token = layers * mamba + uses * shared + 2 * d * s["vocab_size"]
    pairs = count.visible_pairs(seq, seq, True, None)
    scans = layers * ssd.forward_ops(1, seq, nh, s["mamba_headdim"], n, g)
    return per_token * seq + uses * 4.0 * hd * h * pairs + scans
