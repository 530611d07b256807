"""Plain PyTorch reference of the RWKV-6 family as the benchmark runs it:
its weights' layout, and the loss of a batch.

Per layer a time mix (token shift with a static mix a channel; r, k, v, g
projections; the decay ``w = exp(-min(exp(base + tanh(x A) B), 2.5))`` a
channel and token; the WKV recurrence ``y_t = r_t (S_t + diag(u) k_t
v_t^T)``, ``S_{t+1} = diag(w_t) S_t + k_t v_t^T`` a head; an RMS norm of
y, gated by ``silu(g)``, and the output projection) and a channel mix
(``sigmoid(x_r R) * (relu(x_k K)^2 V)``), each behind an RMS norm and added
to the residual; then an RMS norm, the head and the cross-entropy.

The WKV runs as exact chunked products over chunks of :data:`CHUNK`
tokens: each pair's decay is ``exp(cum_{t-1} - cum_j)``, formed as
``exp(cum_{t-1}) * exp(-cum_j)``; with the per-step decay at most 2.5
these factors stay within ``e^(CHUNK * 2.5)`` of 1, well inside f32.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.reference.common import (
    Layout,
    fan_in_std,
    lm_loss,
    padded_vocab,
    rms_norm,
    shift,
)

CHUNK = 16
DECAY_CLAMP = 2.5
EPS = 1e-6


def layout(s: Dict) -> Layout:
    nl, d, f = s["num_hidden_layers"], s["hidden_size"], s["intermediate_size"]
    p, lora, v = s["head_size"], s["decay_lora_rank"], padded_vocab(s)
    h = d // p
    out = [("embed", (v, d), "normal", 0.02)]
    for name, shape, init, std in [
            ("ln", (nl, d), "ones", 0), ("mu_r", (nl, d), "zeros", 0),
            ("mu_k", (nl, d), "zeros", 0), ("mu_v", (nl, d), "zeros", 0),
            ("mu_g", (nl, d), "zeros", 0), ("mu_w", (nl, d), "zeros", 0),
            ("w_r", (nl, d, d), "normal", None), ("w_k", (nl, d, d), "normal", None),
            ("w_v", (nl, d, d), "normal", None), ("w_g", (nl, d, d), "normal", None),
            ("w_o", (nl, d, d), "normal", None), ("decay_base", (nl, d), "zeros", 0),
            ("decay_lora_a", (nl, d, lora), "normal", None),
            ("decay_lora_b", (nl, lora, d), "normal", 0.01),
            ("bonus_u", (nl, h, p), "zeros", 0), ("gn", (nl, d), "ones", 0)]:
        out.append((f"time_mix/{name}", shape, init,
                    fan_in_std(shape) if std is None else std))
    for name, shape, init in [("ln", (nl, d), "ones"), ("mu_k", (nl, d), "zeros"),
                              ("mu_r", (nl, d), "zeros"),
                              ("w_k", (nl, d, f), "normal"),
                              ("w_v", (nl, f, d), "normal"),
                              ("w_r", (nl, d, d), "normal")]:
        out.append((f"chan_mix/{name}", shape, init, fan_in_std(shape)))
    out += [("ln_f", (d,), "ones", 0), ("lm_head", (d, v), "normal", fan_in_std((d, v)))]
    return out


def wkv(r, k, v, logw, u):
    """The WKV of r, k, v, logw ``(B, S, H, P)`` and u ``(H, P)`` from a
    zero state, in f32."""
    b, s, h, p = r.shape
    lc = min(CHUNK, s)
    pad = (-s) % lc
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, logw))
    nc = r.shape[1] // lc
    r, k, v, logw = (a.reshape(b, nc, lc, h, p) for a in (r, k, v, logw))
    cum = torch.cumsum(logw, dim=2)
    before = cum - logw
    r_dec = r * torch.exp(before)
    scores = torch.einsum("bclhp,bcmhp->bchlm", r_dec, k * torch.exp(-cum))
    earlier = torch.tril(torch.ones(lc, lc, dtype=torch.bool, device=r.device), -1)
    scores = torch.where(earlier, scores, 0.0)
    y = torch.einsum("bchlm,bcmhp->bclhp", scores, v)
    y = y + torch.einsum("bclhp,hp,bclhp->bclh", r, u, k)[..., None] * v
    # each chunk's contribution to the state, and the state before each chunk
    k_end = k * torch.exp(cum[:, :, -1:] - cum)
    add = torch.einsum("bclhp,bclhq->bchpq", k_end, v)
    decay = torch.exp(cum[:, :, -1])
    state = torch.zeros((b, h, p, p), dtype=r.dtype, device=r.device)
    before_chunk = []
    for c in range(nc):
        before_chunk.append(state)
        state = state * decay[:, c, ..., None] + add[:, c]
    y = y + torch.einsum("bclhp,bchpq->bclhq", r_dec, torch.stack(before_chunk, 1))
    return y.reshape(b, nc * lc, h, p)[:, :s]


def _time_mix(lp, hidden, p):
    b, s, d = hidden.shape
    x = rms_norm(hidden, lp["ln"], EPS)
    prev = shift(x)

    def mix(mu):
        return x + (prev - x) * mu

    r, k, v = (mix(lp[f"mu_{n}"]) @ lp[f"w_{n}"] for n in "rkv")
    g = mix(lp["mu_g"]) @ lp["w_g"]
    raw = lp["decay_base"] + torch.tanh(mix(lp["mu_w"]) @ lp["decay_lora_a"]) @ lp["decay_lora_b"]
    logw = -torch.clamp(torch.exp(raw), max=DECAY_CLAMP)
    heads = (b, s, d // p, p)
    y = wkv(r.reshape(heads), k.reshape(heads), v.reshape(heads),
            logw.reshape(heads), lp["bonus_u"]).reshape(b, s, d)
    y = rms_norm(y, lp["gn"], EPS) * F.silu(g)
    return hidden + y @ lp["w_o"]


def _chan_mix(lp, hidden):
    x = rms_norm(hidden, lp["ln"], EPS)
    prev = shift(x)
    xk = x + (prev - x) * lp["mu_k"]
    xr = x + (prev - x) * lp["mu_r"]
    kk = torch.square(torch.relu(xk @ lp["w_k"]))
    return hidden + torch.sigmoid(xr @ lp["w_r"]) * (kk @ lp["w_v"])


def loss(s: Dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
         labels: torch.Tensor) -> torch.Tensor:
    """The mean cross-entropy of a batch, from the flat ``{path: f32}``
    weights of :func:`layout`."""
    h = params["embed"][tokens.long()]
    for layer in range(s["num_hidden_layers"]):
        tm = {k.split("/")[1]: t[layer] for k, t in params.items()
              if k.startswith("time_mix/")}
        cm = {k.split("/")[1]: t[layer] for k, t in params.items()
              if k.startswith("chan_mix/")}
        h = _chan_mix(cm, _time_mix(tm, h, s["head_size"]))
    h = rms_norm(h, params["ln_f"], EPS)
    return lm_loss(h, params["lm_head"], s["vocab_size"], labels)
