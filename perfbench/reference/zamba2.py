"""Plain PyTorch reference of the Zamba2 hybrid as ``transformers``'
``modeling_zamba2.py`` defines it (Zamba2-7B): its weights' layout, and the
loss of a batch.

Per layer ``i`` (``hybrid_layer_ids`` mark the hybrid ones): a hybrid layer
first runs shared block ``u % num_mem_blocks`` at its use ``u``: an RMS norm
of ``concat(h, e)`` (``e`` the embedding's output); q, k and v over the
``2 hidden_size`` width, ``num_attention_heads`` of ``attention_head_dim``,
rotary positions (halves paired) at ``rope_theta``; causal attention with
the scores scaled by ``attention_scale``; ``o_proj``; an RMS norm; the GeGLU
MLP (erf GELU of the gate, times up), gate and up each adding their half of
use ``u``'s rank-``adapter_rank`` LoRA; ``down_proj``; use ``u``'s
``linear``. That output ``t`` joins the layer's Mamba2 input and not the
residual: ``h = h + mamba(norm(h + t))``; a Mamba layer is ``h = h +
mamba(norm(h))``.

Mamba2: ``in_proj`` to z, x, B, C (``mamba_ngroups`` groups of
``mamba_d_state``) and dt; the depthwise causal conv (width
``mamba_d_conv``, bias) and SiLU over x, B and C; ``dt = softplus(dt +
dt_bias)``, ``A = -exp(A_log)``; the SSD scan, head h reading group ``h //
(heads / groups)``, computed in chunks of :data:`CHUNK` (each chunk's
causal products, the states carried chunk to chunk); ``y + D x``; the
gated RMS norm ``rms(y silu(z))`` over each group's ``d_inner / groups``
channels; ``out_proj``. The head is the embedding's transpose; the loss is
the mean cross-entropy. Every RMS norm's epsilon is ``rms_norm_eps``.

Attention runs in query blocks of :data:`QUERY_BLOCK`, each recomputed in
backward (``torch.utils.checkpoint``), and so does every Mamba layer, so
that a rank's step at seq 4096 fits on the card beside four ranks'
gradients.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.common import Layout, fan_in_std, lm_loss, padded_vocab

CHUNK = 64          # the SSD's chunk: any chunk gives the same function
QUERY_BLOCK = 512   # query rows a block of attention


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float, groups: int = 1) -> torch.Tensor:
    x = x.reshape(*x.shape[:-1], groups, x.shape[-1] // groups)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return x.reshape(*x.shape[:-2], -1) * w


def _widths(s: Dict):
    din = s["mamba_expand"] * s["hidden_size"]
    gn = s["mamba_ngroups"] * s["mamba_d_state"]
    return din, gn, s["n_mamba_heads"]


def layout(s: Dict) -> Layout:
    """Each product's weights drawn at ``1 / sqrt(fan-in)``, the embedding
    at 0.02, the conv at 0.5, the norms, ``A_log`` and ``D`` at 1, the conv's
    bias and ``dt_bias`` at 0."""
    nl, d, a = s["num_hidden_layers"], s["hidden_size"], s["attention_hidden_size"]
    h, kv, hd = s["num_attention_heads"], s["num_key_value_heads"], s["attention_head_dim"]
    f, r, k = s["intermediate_size"], s["adapter_rank"], s["mamba_d_conv"]
    din, gn, nh = _widths(s)
    nb, nu = s["num_mem_blocks"], len(s["hybrid_layer_ids"])
    out = [("embed", (padded_vocab(s), d), "normal", 0.02)]
    for name, shape, init, std in [
            ("ln", (nl, d), "ones", 0),
            ("in_proj", (nl, d, 2 * din + 2 * gn + nh), "normal", None),
            ("conv_w", (nl, k, din + 2 * gn), "normal", 0.5),
            ("conv_b", (nl, din + 2 * gn), "zeros", 0),
            ("dt_bias", (nl, nh), "zeros", 0),
            ("A_log", (nl, nh), "ones", 0),
            ("D", (nl, nh), "ones", 0),
            ("gate_ln", (nl, din), "ones", 0),
            ("out_proj", (nl, din, d), "normal", None)]:
        out.append((f"mamba/{name}", shape, init, fan_in_std(shape) if std is None else std))
    for name, shape, init, std in [
            ("ln1", (nb, a), "ones", 0),
            ("wq", (nb, a, h, hd), "normal", a ** -0.5),
            ("wk", (nb, a, kv, hd), "normal", a ** -0.5),
            ("wv", (nb, a, kv, hd), "normal", a ** -0.5),
            ("wo", (nb, h, hd, d), "normal", (h * hd) ** -0.5),
            ("ln2", (nb, d), "ones", 0),
            ("w_gate", (nb, d, f), "normal", None),
            ("w_up", (nb, d, f), "normal", None),
            ("w_down", (nb, f, d), "normal", None)]:
        out.append((f"shared/{name}", shape, init, fan_in_std(shape) if std is None else std))
    for name, shape in [("linear", (nu, d, d)), ("lora_a", (nu, d, r)),
                        ("lora_b", (nu, r, 2 * f))]:
        out.append((f"uses/{name}", shape, "normal", fan_in_std(shape)))
    out.append(("ln_f", (d,), "ones", 0))
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


def _attend_block(q, k, v, start: int, scale: float):
    """Query rows ``[start, start + len(q))`` over the keys up to the last of
    them, causal; q ``(B, Q, H, D)``, k and v ``(B, K, H, D)``."""
    n, keys = q.shape[1], k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    seen = (torch.arange(start, start + n, device=q.device)[:, None]
            >= torch.arange(keys, device=q.device)[None, :])
    probs = F.softmax(torch.where(seen, scores, -math.inf), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _attention(q, k, v, scale: float):
    kv = k.shape[2]
    k = torch.repeat_interleave(k, q.shape[2] // kv, dim=2)
    v = torch.repeat_interleave(v, q.shape[2] // kv, dim=2)
    out = []
    for start in range(0, q.shape[1], QUERY_BLOCK):
        end = min(start + QUERY_BLOCK, q.shape[1])
        out.append(checkpoint(_attend_block, q[:, start:end], k[:, :end],
                              v[:, :end], start, scale, use_reentrant=False))
    return torch.cat(out, dim=1)


def _shared(s: Dict, bp, up, h, e):
    eps = s["rms_norm_eps"]
    x = _rms(torch.cat([h, e], dim=-1), bp["ln1"], eps)
    q, k, v = (torch.einsum("bsa,ahd->bshd", x, bp[w]) for w in ("wq", "wk", "wv"))
    q, k = _rope(q, s["rope_theta"]), _rope(k, s["rope_theta"])
    o = _attention(q, k, v, s["attention_scale"])
    x = _rms(torch.einsum("bshd,hdm->bsm", o, bp["wo"]), bp["ln2"], eps)
    lora = (x @ up["lora_a"]) @ up["lora_b"]
    f = s["intermediate_size"]
    gate = x @ bp["w_gate"] + lora[..., :f]
    upv = x @ bp["w_up"] + lora[..., f:]
    return ((F.gelu(gate) * upv) @ bp["w_down"]) @ up["linear"]


def _ssd(x, dt, A, B, C):
    """y of the SSD scan from a zero state: x ``(b, s, h, p)``, dt ``(b, s,
    h)``, A ``(h,)``, B and C ``(b, s, h, n)`` (each head's group's), in
    chunks of :data:`CHUNK`; every decay an exponent of at most 0."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % CHUNK
    x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
    dt = F.pad(dt, (0, 0, 0, pad))
    nc = x.shape[1] // CHUNK
    xdt = (x * dt[..., None]).reshape(b, nc, CHUNK, h, p)
    B, C = (t.reshape(b, nc, CHUNK, h, n) for t in (B, C))
    g = torch.cumsum((dt * A).reshape(b, nc, CHUNK, h), dim=2)
    lower = torch.ones(CHUNK, CHUNK, dtype=torch.bool, device=x.device).tril()
    gap = g[:, :, :, None, :] - g[:, :, None, :, :]              # (b, nc, t, j, h)
    decay = torch.exp(torch.where(lower[None, None, :, :, None], gap, -math.inf))
    scores = torch.einsum("bcthn,bcjhn->bctjh", C, B) * decay
    y = torch.einsum("bctjh,bcjhp->bcthp", scores, xdt)
    to_end = torch.exp(g[:, :, -1:, :] - g)                      # (b, nc, L, h)
    summary = torch.einsum("bcjhn,bcjh,bcjhp->bchnp", B, to_end, xdt)
    state = torch.zeros(b, h, n, p, dtype=x.dtype, device=x.device)
    starts = []
    for c in range(nc):
        starts.append(state)
        state = state * torch.exp(g[:, c, -1, :])[..., None, None] + summary[:, c]
    starts = torch.stack(starts, dim=1)                          # (b, nc, h, n, p)
    y = y + torch.einsum("bcthn,bcth,bchnp->bcthp", C, torch.exp(g), starts)
    return y.reshape(b, nc * CHUNK, h, p)[:, :s]


def _mamba(s: Dict, lp, x):
    din, gn, nh = _widths(s)
    p, ng, n = s["mamba_headdim"], s["mamba_ngroups"], s["mamba_d_state"]
    z, xbc, dt = torch.split(x @ lp["in_proj"], [din, din + 2 * gn, nh], dim=-1)
    k = lp["conv_w"].shape[0]
    ctx = F.pad(xbc, (0, 0, k - 1, 0))
    xbc = F.silu(sum(ctx[:, i:i + xbc.shape[1]] * lp["conv_w"][i] for i in range(k))
                 + lp["conv_b"])
    xs, B, C = torch.split(xbc, [din, gn, gn], dim=-1)
    b, sl = xs.shape[:2]
    B, C = (torch.repeat_interleave(t.reshape(b, sl, ng, n), nh // ng, dim=2)
            for t in (B, C))
    dt = F.softplus(dt + lp["dt_bias"])
    xh = xs.reshape(b, sl, nh, p)
    y = _ssd(xh, dt, -torch.exp(lp["A_log"]), B, C) + lp["D"][:, None] * xh
    y = _rms(y.reshape(b, sl, din) * F.silu(z), lp["gate_ln"], s["rms_norm_eps"], ng)
    return y @ lp["out_proj"]


def _mamba_layer(s: Dict, lp, h, t):
    x = h if t is None else h + t
    return h + _mamba(s, lp, _rms(x, lp["ln"], s["rms_norm_eps"]))


def loss(s: Dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
         labels: torch.Tensor) -> torch.Tensor:
    """The training loss of a batch, from the flat ``{path: f32}`` weights
    of :func:`layout`."""
    def part(prefix, i):
        return {k.split("/")[1]: v[i] for k, v in params.items()
                if k.startswith(prefix + "/")}

    e = params["embed"][tokens.long()]
    h = e
    uses = {layer: u for u, layer in enumerate(s["hybrid_layer_ids"])}
    for i in range(s["num_hidden_layers"]):
        t = None
        if i in uses:
            u = uses[i]
            t = _shared(s, part("shared", u % s["num_mem_blocks"]), part("uses", u), h, e)
        h = checkpoint(_mamba_layer, s, part("mamba", i), h, t, use_reentrant=False)
    h = _rms(h, params["ln_f"], s["rms_norm_eps"])
    return lm_loss(h, params["embed"].t(), s["vocab_size"], labels)
