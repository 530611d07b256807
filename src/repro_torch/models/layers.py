"""Shared building blocks of the dense LM (the counterpart of
``repro.models.layers``), in the reference's ``(B, S, H, D)`` layout.

Attention is plain tensor code here, as it is XLA in the reference: the
dense form for short sequences and a chunked online-softmax form for long
ones. Score and value products take f32 operands, which is what the
reference's ``preferred_element_type=float32`` gives for bf16 inputs.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)          # (D/2,)
    angles = positions[..., None].float() * freqs          # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _expand_kv(k: torch.Tensor, n_q_heads: int) -> torch.Tensor:
    """GQA: repeat kv heads to match query heads. (B,S,Hkv,D)->(B,S,Hq,D)."""
    n_kv = k.shape[-2]
    if n_kv == n_q_heads:
        return k
    return torch.repeat_interleave(k, n_q_heads // n_kv, dim=-2)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    mask = torch.ones(qpos.shape[0], kpos.shape[0], dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    return mask


def attention_reference(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0):
    """Dense O(S^2) attention. q: (B,Sq,Hq,D), k/v: (B,Skv,Hkv,D)."""
    sq, hq, d = q.shape[1], q.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    k = _expand_kv(k, hq)
    v = _expand_kv(v, hq)
    qs = (q * scale).to(q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(k.shape[1], device=q.device)
    scores = torch.where(_mask(qpos, kpos, causal, window)[None, None],
                         scores, NEG_INF)
    p = F.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def attention_chunked(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, chunk: int = 1024,
                      q_offset: int = 0):
    """Flash-style streaming attention: a loop over KV chunks with an online
    softmax, never more than (B, Sq, Hq, chunk) scores at once. Matches
    :func:`attention_reference` to float tolerance (tested)."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    pad = (-skv) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    k = _expand_kv(k, hq)
    v = _expand_kv(v, hq)
    scale = 1.0 / math.sqrt(d)
    qs = (q * scale).to(q.dtype).float()
    qpos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, sq, hq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sq, hq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, hq, d), dtype=torch.float32, device=q.device)
    for start in range(0, skv + pad, chunk):
        k_j = k[:, start:start + chunk].float()
        v_j = v[:, start:start + chunk]
        kpos = torch.arange(start, start + chunk, device=q.device)
        s = torch.einsum("bqhd,bkhd->bqhk", qs, k_j)
        mask = _mask(qpos, kpos, causal, window) & (kpos < skv)[None, :]
        s = torch.where(mask[None, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqhk,bkhd->bqhd", p.to(q.dtype).float(), v_j.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype)


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, chunk: int = 1024):
    """Dispatch: dense for short sequences, chunked-streaming for long."""
    if k.shape[1] <= 2048:
        return attention_reference(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    return attention_chunked(q, k, v, causal=causal, window=window,
                             chunk=chunk, q_offset=q_offset)


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down
