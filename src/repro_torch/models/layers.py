"""Shared building blocks of the model zoo (the counterpart of
``repro.models.layers``), in the reference's ``(B, S, H, D)`` layout.

On the CPU attention is plain tensor code, as it is XLA in the reference:
the dense form for short sequences and a chunked online-softmax form for
long ones. Score and value products take f32 operands, which is what the
reference's ``preferred_element_type=float32`` gives for bf16 inputs. On a
CUDA tensor attention goes through the hand-written flash attention kernels
(``repro_torch.kernels.flash_attention``), forward and backward, and never
through the plain forms.

Decode (:func:`decode_attention`) is plain tensor code on every device, as
it is XLA, not Pallas, in the reference: one query token a lane against
the lane's KV cache. So are the norms, the MLPs and the routed MoE FFN
(:func:`moe_ffn`), which are XLA in the reference too.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.dist.sharding import (
    attention_placements,
    is_dtensor,
    like,
    on_shards,
    product_grads,
    shard_of,
)
from repro_torch.kernels.flash_attention import flash_attention

NEG_INF = -1e30


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. On a DTensor table it runs shard by shard: each
    device looks its tokens up in its own block of vocab rows (a token
    outside the block gives zeros) and the blocks' partial sums are reduced,
    so the table is never gathered (Megatron's vocab-parallel embedding;
    DTensor's own rule for it keeps a mask in the placement, which breaks
    when the lookup repeats)."""
    if not is_dtensor(table):
        return table[tokens.long()]
    mesh = table.device_mesh
    vocab = [p.is_shard(0) for p in table.placements]
    tp = [Shard(0) if v else Replicate() for v in vocab]
    rows = [Shard(0) if p.is_shard(0) and not v else Replicate()
            for p, v in zip(tokens.placements, vocab)]
    _, offset = shard_of(mesh, tp, table.shape)

    def lookup(t, i):
        idx = i.long() - offset[0]
        inside = (idx >= 0) & (idx < t.shape[0])
        return torch.where(inside[..., None],
                           t[torch.clamp(idx, 0, t.shape[0] - 1)], 0.0)

    out = on_shards(lookup, mesh, [Partial() if v else r for v, r in zip(vocab, rows)],
                    (tp, rows), (product_grads(tp, rows)[0], rows))(table, tokens)
    return out.redistribute(mesh, [Replicate() if p.is_partial() else p
                                   for p in out.placements])


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)``: activations onto heads. On
    DTensors it runs shard by shard: the weight gathered on its input dim
    (FSDP's all-gather) with its heads kept split, the activations gathered
    on their feature dim and on every mesh dim that splits the heads (the
    sequence, under sequence parallelism), so that each device's heads come
    out whole, whatever their number against the mesh."""
    if not is_dtensor(w):
        return torch.einsum("bsd,dhk->bshk", x, w)
    wp = [p if p.is_shard(1) else Replicate() for p in w.placements]
    xp = [p if p.is_shard() and p.dim < 2 and not wp[i].is_shard() else Replicate()
          for i, p in enumerate(x.placements)]
    out = [Shard(2) if wp[i].is_shard() else xp[i] for i in range(len(wp))]
    return on_shards(lambda x, w: torch.einsum("bsd,dhk->bshk", x, w),
                     w.device_mesh, out, (xp, wp), product_grads(xp, wp))(x, w)


def merge_heads(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", o, w)``: heads back onto features. On
    DTensors it runs shard by shard: the weight split over the heads as
    ``o`` is and gathered on its output dim, ``o``'s batch, sequence and
    head shards kept, and the result a partial sum over the head shards
    (DTensor would otherwise split the flattened heads over ways they do not
    divide in backward)."""
    if not is_dtensor(w):
        return torch.einsum("bshk,hkd->bsd", o, w)
    op = [p if p.is_shard() and p.dim < 3 else Replicate() for p in o.placements]
    wp = [Shard(0) if p.is_shard(2) else Replicate() for p in op]
    out = [Partial() if p.is_shard(2) else p for p in op]
    return on_shards(lambda o, w: torch.einsum("bshk,hkd->bsd", o, w),
                     w.device_mesh, out, (op, wp), product_grads(op, wp))(o, w)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """The rotary angles' (cos, sin), each (..., S, 1, D/2), for positions
    broadcastable to (..., S): computed once, they serve every layer."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)  # (D/2,)
    angles = positions[..., None].float() * freqs          # (..., S, D/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D) rotated by :func:`rope_cos_sin`'s angles."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos, sin = like(x, cos), like(x, sin)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


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
    """Dispatch. On the CPU as the reference: dense for short sequences,
    chunked-streaming for long. Any other device goes to the flash attention
    kernels, which raise for a device other than CUDA; they take no
    ``q_offset``, which no caller passes (serving prefills through
    ``decode_step``, as the reference does). DTensors go to the flash
    attention of each shard on every device, laid out by
    :func:`attention_placements`; where the kv heads do not split over the
    ways the q heads do, k and v are first expanded to one head a q head,
    as the reference's GSPMD attention expands them."""
    if q.device.type != "cpu" or is_dtensor(q):
        if q_offset != 0:
            raise NotImplementedError(
                "attention with q_offset != 0 has no kernel on the card; "
                "serving prefills through decode_step and never passes one")
        if not is_dtensor(q):
            return flash_attention(q, k, v, causal=causal, window=window)
        placements, kv_split = attention_placements(q, k.shape[2])
        if not kv_split:
            g = q.shape[2] // k.shape[2]
            k = torch.repeat_interleave(k, g, dim=2)
            v = torch.repeat_interleave(v, g, dim=2)
        return flash_attention(q, k, v, causal=causal, window=window,
                               placements=placements)
    if k.shape[1] <= 2048:
        return attention_reference(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    return attention_chunked(q, k, v, causal=causal, window=window,
                             chunk=chunk, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, cur_index, *,
                     window: Optional[int] = None):
    """One-token attention over a (possibly ring-buffered) KV cache.

    q: (B,1,Hq,D); caches: (B,S_cache,Hkv,D); ``cur_index``: the number of
    valid tokens already in the cache (the new token's position), one for
    the batch or a (B,) tensor, one a lane. GQA by a grouped product: the
    kv repeat is never materialized. The reference multiplies q against the
    cache in q's dtype with f32 products (an f32 q against a bf16 cache
    promotes to f32); the cache slice is upcast here, and softmax and
    ``p @ v`` are f32 as its ``preferred_element_type`` makes them.
    """
    b, sq, hq, d = q.shape
    s_cache, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    if is_dtensor(q):
        # q's heads stay split only where the kv heads split as they do
        qp, kv_split = attention_placements(q, hkv)
        if not kv_split:
            qp = [Replicate() if p.is_shard(2) else p for p in qp]
        q = q.redistribute(q.device_mesh, qp)
    scale = 1.0 / math.sqrt(d)
    qg = (q.float() * scale).reshape(b, sq, hkv, g, d).to(q.dtype).float()
    qh = qg.permute(0, 2, 1, 3, 4).reshape(b, hkv, sq * g, d)
    # each cache slice read once: transposed for the products and upcast
    # to f32 in one copy
    kt = k_cache.permute(0, 2, 3, 1).to(torch.float32,
                                        memory_format=torch.contiguous_format)
    s = torch.matmul(qh, kt)                          # (B, Hkv, Sq*G, S)
    cur = torch.as_tensor(cur_index, device=q.device).reshape(-1, 1)
    kpos = torch.arange(s_cache, device=q.device)[None, :]
    mask = kpos <= cur
    if window is not None:
        mask &= kpos > cur - window
    s = torch.where(like(s, mask[:, None, None, :]), s, NEG_INF)
    p = F.softmax(s, dim=-1)
    vh = v_cache.permute(0, 2, 1, 3).to(torch.float32,
                                        memory_format=torch.contiguous_format)
    out = torch.matmul(p.to(q.dtype).float(), vh)     # (B, Hkv, Sq*G, D)
    out = out.reshape(b, hkv, sq, g, d).permute(0, 2, 1, 3, 4)
    return out.reshape(b, sq, hq, d).to(q.dtype)


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out + b_out


# ---------------------------------------------------------------------------
# MoE: top-k routing with sort-based capacity dispatch (no S x E x C tensor)
# ---------------------------------------------------------------------------

def moe_capacity(tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Slots an expert has for ``tokens`` tokens: beyond them its tokens are
    dropped. At ``capacity_factor >= n_experts / top_k`` none is."""
    return max(int(math.ceil(tokens * top_k / n_experts * capacity_factor)),
               top_k)


def moe_ffn(x, router, w_gate, w_up, w_down, *, top_k: int,
            capacity_factor: float = 1.25):
    """Sparse MoE via a stable sort and a fixed-capacity grouped product;
    returns ``(y, aux_loss)``.

    x ``(B, S, D)``, router ``(D, E)``, w_gate and w_up ``(E, D, F)``,
    w_down ``(E, F, D)``. Router logits in f32, softmax, top-k and
    renormalised gates; the Switch load-balancing loss ``E * sum(me * ce)``.
    Tokens sorted by expert (stably: the order inside an expert decides
    which overflow its capacity, :func:`moe_capacity`), an ``(E, C, D)``
    buffer through SwiGLU experts, then each token's gated outputs summed
    back; overflowing tokens go to a dump slot and get nothing. Counts are
    a scatter-add, not ``bincount``, which reads its largest value back to
    the host and so cannot run inside a captured CUDA graph.
    """
    b, s, d = x.shape
    e = router.shape[-1]
    t = b * s
    dev = x.device
    xf = x.reshape(t, d)
    logits = xf.float() @ router.float()                            # (T, E)
    probs = F.softmax(logits, dim=-1)
    gate_w, gate_ids = torch.topk(probs, top_k, dim=-1)             # (T, k)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    expert_flat = gate_ids.reshape(-1)                              # (T*k,)
    me = probs.mean(dim=0)
    ce = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, expert_flat, torch.ones(t * top_k, dtype=torch.float32,
                                   device=dev)) / (t * top_k)
    aux = e * torch.sum(me * ce)

    capacity = moe_capacity(t, e, top_k, capacity_factor)
    token_flat = torch.arange(t, device=dev)[:, None].expand(t, top_k).reshape(-1)
    weight_flat = gate_w.reshape(-1)
    order = torch.argsort(expert_flat, stable=True)
    sorted_experts = expert_flat[order]
    sorted_tokens = token_flat[order]
    sorted_weights = weight_flat[order]
    counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, sorted_experts, torch.ones_like(sorted_experts))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * top_k, device=dev) - starts[sorted_experts]
    slot = torch.where(rank < capacity, sorted_experts * capacity + rank,
                       e * capacity)

    buf = x.new_zeros((e * capacity + 1, d)).index_put((slot,), xf[sorted_tokens])
    xe = buf[:e * capacity].reshape(e, capacity, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, w_gate)) * torch.einsum(
        "ecd,edf->ecf", xe, w_up)
    ye = torch.einsum("ecf,efd->ecd", h, w_down)

    # combine: each slot's output, weighted by its gate, added to its token
    # (the dump slot's token is the extra row t)
    token_for_slot = torch.full((e * capacity + 1,), t, dtype=torch.long,
                                device=dev).index_put((slot,), sorted_tokens)
    weight_for_slot = torch.zeros(e * capacity + 1, dtype=torch.float32,
                                  device=dev).index_put(
        (slot,), sorted_weights.float())
    contrib = ye.reshape(e * capacity, d) * weight_for_slot[:e * capacity, None].to(x.dtype)
    y = x.new_zeros((t + 1, d)).index_add(0, token_for_slot[:e * capacity], contrib)
    return y[:t].reshape(b, s, d), aux
