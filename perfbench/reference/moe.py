"""Plain PyTorch reference of the routed-expert transformer family as the
benchmark runs it: its weights' layout, and the loss of a batch.

Per layer: an RMS norm; causal attention with rotary positions and grouped
key/value heads (each key/value head serving ``heads / kv_heads``
consecutive query heads); an RMS norm; the routed SwiGLU experts. The
router's logits ``x R`` go through a softmax; each token takes its top-k
experts, its gates renormalised to sum to 1. An expert keeps the first
``capacity = max(ceil(T k / E * factor), k)`` of the (token, choice) pairs
routed to it, in token order (then choice order), and the rest are
dropped. The loss is the mean cross-entropy plus 0.01 times the layers'
mean Switch balance loss ``E * sum_e mean_prob_e * share_e``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.reference.common import (
    Layout,
    fan_in_std,
    lm_loss,
    padded_vocab,
    rms_norm,
)

EPS = 1e-6
AUX_WEIGHT = 0.01


def layout(s: Dict) -> Layout:
    """Each product's weights drawn at ``1 / sqrt(fan-in)`` (the heads'
    projections over their whole input width), the router and the
    embedding at 0.02, the norms at 1."""
    nl, d, hd = s["num_hidden_layers"], s["hidden_size"], s["head_dim"]
    h, kv = s["num_attention_heads"], s["num_key_value_heads"]
    e, f, vp = s["num_local_experts"], s["intermediate_size"], padded_vocab(s)
    out = [("embed", (vp, d), "normal", 0.02)]
    for name, shape, init, std in [
            ("ln1", (nl, d), "ones", 0), ("ln2", (nl, d), "ones", 0),
            ("wq", (nl, d, h, hd), "normal", d ** -0.5),
            ("wk", (nl, d, kv, hd), "normal", d ** -0.5),
            ("wv", (nl, d, kv, hd), "normal", d ** -0.5),
            ("wo", (nl, h, hd, d), "normal", (h * hd) ** -0.5),
            ("router", (nl, d, e), "normal", 0.02),
            ("we_gate", (nl, e, d, f), "normal", None),
            ("we_up", (nl, e, d, f), "normal", None),
            ("we_down", (nl, e, f, d), "normal", None)]:
        out.append((f"blocks/{name}", shape, init,
                    fan_in_std(shape) if std is None else std))
    out += [("ln_f", (d,), "ones", 0), ("lm_head", (d, vp), "normal", fan_in_std((d, vp)))]
    return out


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x ``(B, S, H, D)`` rotated by position, the halves of D paired."""
    s, dim = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=x.device) / dim))
    angles = torch.arange(s, device=x.device).float()[:, None] * freqs
    cos, sin = torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(lp, x, s):
    q = torch.einsum("bsd,dhk->bshk", x, lp["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, lp["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, lp["wv"])
    q, k = _rope(q, s["rope_theta"]), _rope(k, s["rope_theta"])
    group = q.shape[2] // k.shape[2]
    k = torch.repeat_interleave(k, group, dim=2)
    v = torch.repeat_interleave(v, group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q * (1.0 / math.sqrt(q.shape[-1])), k)
    n = q.shape[1]
    causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    probs = F.softmax(torch.where(causal, scores, -1e30), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return torch.einsum("bshk,hkd->bsd", o, lp["wo"])


def _experts(lp, x, s):
    """The routed experts' output ``(B, S, D)`` and the balance loss."""
    b, n, d = x.shape
    t, e, top_k = b * n, s["num_local_experts"], s["num_experts_per_tok"]
    xf = x.reshape(t, d)
    probs = F.softmax(xf @ lp["router"], dim=-1)
    gates, choice = torch.topk(probs, top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    share = torch.bincount(choice.reshape(-1), minlength=e).float() / (t * top_k)
    aux = e * torch.sum(probs.mean(dim=0) * share)
    capacity = max(math.ceil(t * top_k / e * s["capacity_factor"]), top_k)
    y = torch.zeros_like(xf)
    flat_choice, flat_gate = choice.reshape(-1), gates.reshape(-1)
    for ex in range(e):
        pairs = torch.nonzero(flat_choice == ex).reshape(-1)[:capacity]
        tokens = pairs // top_k
        xe = xf[tokens]
        out = (F.silu(xe @ lp["we_gate"][ex]) * (xe @ lp["we_up"][ex])) @ lp["we_down"][ex]
        y = y.index_add(0, tokens, out * flat_gate[pairs][:, None])
    return y.reshape(b, n, d), aux


def loss(s: Dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
         labels: torch.Tensor) -> torch.Tensor:
    """The training loss of a batch, from the flat ``{path: f32}`` weights
    of :func:`layout`."""
    h = params["embed"][tokens.long()]
    aux_sum = 0.0
    for layer in range(s["num_hidden_layers"]):
        lp = {k.split("/")[1]: t[layer] for k, t in params.items()
              if k.startswith("blocks/")}
        h = h + _attention(lp, rms_norm(h, lp["ln1"], EPS), s)
        y, aux = _experts(lp, rms_norm(h, lp["ln2"], EPS), s)
        h = h + y
        aux_sum = aux_sum + aux
    h = rms_norm(h, params["ln_f"], EPS)
    ce = lm_loss(h, params["lm_head"], s["vocab_size"], labels)
    return ce + AUX_WEIGHT * aux_sum / s["num_hidden_layers"]
