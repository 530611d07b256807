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
                        window: Optional[int] = None, q_offset=0):
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
                      q_offset=0):
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
              q_offset=0, chunk: int = 1024):
    """Dispatch. On the CPU as the reference: dense for short sequences,
    chunked-streaming for long. Any other device goes to the flash attention
    kernels, which raise for a device other than CUDA. ``q_offset`` (an int
    or a 0-d integer tensor, the reference's ``int | jax.Array``) puts query
    row ``i`` at position ``i + q_offset``: a block of queries that
    continues a sequence whose keys come first. DTensors go to the flash
    attention of each shard on every device, laid out by
    :func:`attention_placements`; where the kv heads do not split over the
    ways the q heads do, k and v are first expanded to one head a q head,
    as the reference's GSPMD attention expands them."""
    if q.device.type != "cpu" or is_dtensor(q):
        if not is_dtensor(q):
            return flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
        placements, kv_split = attention_placements(q, k.shape[2])
        if not kv_split:
            g = q.shape[2] // k.shape[2]
            k = torch.repeat_interleave(k, g, dim=2)
            v = torch.repeat_interleave(v, g, dim=2)
        return flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, placements=placements)
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
    DTensors take :func:`_decode_attention_sharded`.
    """
    if is_dtensor(k_cache):
        return _decode_attention_sharded(q, k_cache, v_cache, cur_index, window)
    return _decode_attention(q, k_cache, v_cache, cur_index, window)


def _decode_attention(q, k_cache, v_cache, cur_index, window, first: int = 0,
                      groups=()):
    """:func:`decode_attention` of local tensors whose cache holds the
    positions ``first ..``; with ``groups``, the process groups over which
    the cache's sequence is split, the softmax and ``p @ v`` are reduced
    over them (flash decoding: maxima, then sums)."""
    b, sq, hq, d = q.shape
    s_cache, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qg = (q.float() * scale).reshape(b, sq, hkv, g, d).to(q.dtype).float()
    qh = qg.permute(0, 2, 1, 3, 4).reshape(b, hkv, sq * g, d)
    # each cache slice read once: transposed for the products and upcast
    # to f32 in one copy
    kt = k_cache.permute(0, 2, 3, 1).to(torch.float32,
                                        memory_format=torch.contiguous_format)
    s = torch.matmul(qh, kt)                          # (B, Hkv, Sq*G, S)
    cur = torch.as_tensor(cur_index, device=q.device).reshape(-1, 1)
    kpos = torch.arange(s_cache, device=q.device)[None, :] + first
    mask = kpos <= cur
    if window is not None:
        mask &= kpos > cur - window
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    if groups:
        from torch.distributed import _functional_collectives as funcol

        def reduce(t, op):
            for grp in groups:
                t = funcol.all_reduce(t, op, grp)
            return t

        e = torch.exp(s - reduce(s.amax(dim=-1, keepdim=True), "max"))
        p = e / reduce(e.sum(dim=-1, keepdim=True), "sum")
    else:
        p = F.softmax(s, dim=-1)
    vh = v_cache.permute(0, 2, 1, 3).to(torch.float32,
                                        memory_format=torch.contiguous_format)
    out = torch.matmul(p.to(q.dtype).float(), vh)     # (B, Hkv, Sq*G, D)
    if groups:
        out = reduce(out, "sum")
    out = out.reshape(b, hkv, sq, g, d).permute(0, 2, 1, 3, 4)
    return out.reshape(b, sq, hq, d).to(q.dtype)


def _decode_attention_sharded(q, k_cache, v_cache, cur_index, window):
    """:func:`decode_attention` of DTensors, shard by shard: each device its
    lanes, its kv heads with their q heads, and its block of the cache's
    sequence; across a sequence split the softmax and ``p @ v`` are reduced
    (:func:`_decode_attention`), so no key is gathered. DTensor's own
    products flatten lanes and heads, which torch 2.11 cannot do with the
    heads split."""
    mesh = k_cache.device_mesh
    cp = [p if p.is_shard() and p.dim < 3 else Replicate()
          for p in k_cache.placements]
    qp = [Shard(0) if p.is_shard(0) else Shard(2) if p.is_shard(2) else Replicate()
          for p in cp]
    lanes = [Shard(0) if p.is_shard(0) else Replicate() for p in cp]
    _, offset = shard_of(mesh, cp, k_cache.shape)
    groups = [mesh.get_group(i) for i, p in enumerate(cp)
              if p.is_shard(1) and mesh.size(i) > 1]
    cur = torch.as_tensor(cur_index, device=q.device).reshape(-1).expand(q.shape[0])
    return on_shards(
        lambda q, k, v, c: _decode_attention(q, k, v, c, window, offset[1], groups),
        mesh, qp, (qp, cp, cp, lanes))(q, k_cache, v_cache, like(k_cache, cur))


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``: ``(..., D)`` activations onto a ``(D, F)`` weight's
    outputs. On DTensors it runs shard by shard, on each mesh dim as one of
    Megatron's products: where the weight's outputs are split and the
    batch is not, the activations are gathered (a sequence split under
    sequence parallelism: gathered before a column-parallel product) and
    the result is split as the weight; where the activations' features are
    split, the weight's inputs are split alike and the result is a partial
    sum (row-parallel); a split of the activations' leading dims is kept,
    the weight gathered there (FSDP's all-gather); where neither is split,
    the weight's outputs are. DTensor's own product flattens the leading
    dims, here and in its backward, which torch 2.11 cannot do with the
    second one split."""
    if not is_dtensor(w):
        return x @ w
    last = x.ndim - 1
    xp, wp, out = [], [], []
    for i, (p, q) in enumerate(zip(x.placements, w.placements)):
        if q.is_shard(1) and not p.is_shard(0):
            xp.append(Replicate()), wp.append(q), out.append(Shard(last))
        elif p.is_shard(last):
            xp.append(p), wp.append(Shard(0)), out.append(Partial())
        elif p.is_shard():
            xp.append(p), wp.append(Replicate()), out.append(p)
        elif w.shape[1] % w.device_mesh.size(i) == 0:
            # split nowhere: the weight's outputs split here, as DTensor
            # would (a local slice), so that no device repeats the product
            xp.append(Replicate()), wp.append(Shard(1)), out.append(Shard(last))
        else:
            xp.append(Replicate()), wp.append(Replicate()), out.append(Replicate())
    return on_shards(lambda x, w: x @ w, w.device_mesh, out, (xp, wp),
                     product_grads(xp, wp))(x, w)


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(project(x, w_gate)) * project(x, w_up)
    return project(h, w_down)


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(project(x, w_in) + b_in, approximate="tanh")
    return project(h, w_out) + b_out


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
    the host and so cannot run inside a captured CUDA graph. DTensors take
    :func:`_moe_ffn_sharded`, the same global function shard by shard.
    """
    if is_dtensor(x):
        return _moe_ffn_sharded(x, router, w_gate, w_up, w_down, top_k=top_k,
                                capacity_factor=capacity_factor)
    b, s, d = x.shape
    e = router.shape[-1]
    t = b * s
    dev = x.device
    xf = x.reshape(t, d)
    logits = xf.float() @ router.float()                            # (T, E)
    probs = F.softmax(logits, dim=-1)
    gate_w, gate_ids = _top_k_gates(probs, top_k)                   # (T, k)

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    expert_flat = gate_ids.reshape(-1)                              # (T*k,)
    me = probs.mean(dim=0)
    ce = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, expert_flat, torch.ones(t * top_k, dtype=torch.float32,
                                   device=dev)) / (t * top_k)
    aux = e * torch.sum(me * ce)

    capacity = moe_capacity(t, e, top_k, capacity_factor)
    y = _dispatch_combine(x, gate_w, gate_ids, w_gate, w_up, w_down,
                          n_experts=e, capacity=capacity, slots=capacity)
    return y, aux


def _top_k_gates(probs, top_k: int):
    """Each token's top-k experts and their gates, renormalised."""
    gate_w, gate_ids = torch.topk(probs, top_k, dim=-1)
    return gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9), gate_ids


def _assign(gate_ids, *, n_experts: int, capacity: int, slots: int, el: int,
            prefix=None, first: int = 0):
    """Where each top-k assignment goes: ``(order, slot)``, the assignments
    in stable expert order (token-major, then k, inside an expert) and each
    one's row in the ``(el * slots + 1)``-row buffer of the experts
    ``first .. first + el``, the last row the dump. An assignment is kept
    while its rank inside its expert plus ``prefix[expert]`` (the
    assignments of earlier tokens held elsewhere; by default none) is under
    ``capacity``."""
    t, top_k = gate_ids.shape
    dev = gate_ids.device
    expert_flat = gate_ids.reshape(-1)                              # (T*k,)
    order = torch.argsort(expert_flat, stable=True)
    sorted_experts = expert_flat[order]
    counts = torch.zeros(n_experts, dtype=torch.long, device=dev).scatter_add_(
        0, sorted_experts, torch.ones_like(sorted_experts))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * top_k, device=dev) - starts[sorted_experts]
    if prefix is None:
        return order, torch.where(rank < capacity,
                                  sorted_experts * capacity + rank, el * slots)
    keep = ((rank + prefix[sorted_experts] < capacity)
            & (sorted_experts >= first) & (sorted_experts < first + el))
    return order, torch.where(keep, (sorted_experts - first) * slots + rank,
                              el * slots)


def _dispatch_combine(x, gate_w, gate_ids, w_gate, w_up, w_down, *,
                      n_experts: int, capacity: int, slots: int,
                      prefix=None, first: int = 0):
    """The experts ``first ..`` whose weights are ``w_*`` applied to the
    tokens of ``x`` ``(B, S, D)`` routed to them (``gate_ids``, ``gate_w``
    ``(B*S, k)``), summed back into ``(B, S, D)``; each expert's buffer has
    ``slots`` rows, one an assignment of these tokens that it keeps
    (:func:`_assign`)."""
    b, s, d = x.shape
    t, top_k = gate_ids.shape
    el = w_gate.shape[0]
    dev = x.device
    xf = x.reshape(t, d)
    order, slot = _assign(gate_ids, n_experts=n_experts, capacity=capacity,
                          slots=slots, el=el, prefix=prefix, first=first)
    token_flat = torch.arange(t, device=dev)[:, None].expand(t, top_k).reshape(-1)
    sorted_tokens = token_flat[order]
    sorted_weights = gate_w.reshape(-1)[order]

    buf = x.new_zeros((el * slots + 1, d)).index_put((slot,), xf[sorted_tokens])
    xe = buf[:el * slots].reshape(el, slots, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, w_gate)) * torch.einsum(
        "ecd,edf->ecf", xe, w_up)
    ye = torch.einsum("ecf,efd->ecd", h, w_down)

    # combine: each slot's output, weighted by its gate, added to its token
    # (the dump slot's token is the extra row t)
    token_for_slot = torch.full((el * slots + 1,), t, dtype=torch.long,
                                device=dev).index_put((slot,), sorted_tokens)
    weight_for_slot = torch.zeros(el * slots + 1, dtype=torch.float32,
                                  device=dev).index_put(
        (slot,), sorted_weights.float())
    contrib = ye.reshape(el * slots, d) * weight_for_slot[:el * slots, None].to(x.dtype)
    y = x.new_zeros((t + 1, d)).index_add(0, token_for_slot[:el * slots], contrib)
    return y[:t].reshape(b, s, d)


def _moe_ffn_sharded(x, router, w_gate, w_up, w_down, *, top_k: int,
                     capacity_factor: float):
    """:func:`moe_ffn` of DTensors: the reference's global function (GSPMD
    runs it on the global ``(B, S, D)`` array), shard by shard.

    Each device takes its batch rows whole (a sequence split is gathered)
    and the router whole: the logits and probabilities of its tokens, then
    the top-k of each. Capacity is that of the global token count, and an
    assignment's rank inside its expert is its rank in the global order:
    the expert counts of the batch rows before the device's, gathered once
    (a ``(B, E)`` integer tensor), start its ranks. The aux loss takes the
    global ``me`` and ``ce`` (DTensor reductions). Each device runs the
    experts it holds (split over "model" by default, their hidden dim under
    ``moe_tp``) on its tokens, in a buffer of ``min(capacity, its tokens)``
    rows an expert, and its combine is a partial sum over the mesh dims
    that split the experts, reduced once into ``(B, S, D)``. On a one-rank
    mesh every step is the plain route's."""
    mesh = x.device_mesh
    b, s, d = x.shape
    e = router.shape[-1]
    t = b * s
    capacity = moe_capacity(t, e, top_k, capacity_factor)
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in x.placements]
    whole = [Replicate()] * mesh.ndim

    def route(x, r):
        return F.softmax(x.reshape(-1, d).float() @ r.float(), dim=-1)

    probs = on_shards(route, mesh, rows, (rows, whole),
                      product_grads(rows, whole))(x, router)         # (T, E)

    def row_counts(p):
        ids = torch.topk(p, top_k, dim=-1)[1].reshape(-1, s * top_k)
        return torch.zeros(ids.shape[0], e, dtype=torch.long,
                           device=p.device).scatter_add_(1, ids, torch.ones_like(ids))

    counts = on_shards(row_counts, mesh, rows, (rows,))(probs.detach())
    counts = counts.redistribute(mesh, whole)                        # (B, E)
    me = probs.mean(dim=0)
    ce = counts.sum(0).float() / (t * top_k)
    aux = e * torch.sum(me * ce)

    # weights: the expert dim and the hidden dim keep their splits, except
    # on a mesh dim that splits the tokens; the rest is gathered
    def weight_placements(w, hidden: int):
        return [Replicate() if rows[i].is_shard()
                else p if p.is_shard(0) or p.is_shard(hidden) else Replicate()
                for i, p in enumerate(w.placements)]

    gp, dp = weight_placements(w_gate, 2), weight_placements(w_down, 1)
    out = [Partial() if gp[i].is_shard() else rows[i] for i in range(mesh.ndim)]
    local_rows, row_off = shard_of(mesh, rows, x.shape)
    _, expert_off = shard_of(mesh, gp, w_gate.shape)
    slots = min(capacity, local_rows[0] * s)

    def experts(x, p, c, wg, wu, wd):
        gate_w, gate_ids = _top_k_gates(p, top_k)
        return _dispatch_combine(x, gate_w, gate_ids, wg, wu, wd, n_experts=e,
                                 capacity=capacity, slots=slots,
                                 prefix=c[:row_off[0]].sum(0), first=expert_off[0])

    act_g, gate_g = product_grads(rows, gp)
    down_g = product_grads(rows, dp)[1]
    y = on_shards(experts, mesh, out, (rows, rows, whole, gp, gp, dp),
                  (act_g, act_g, whole, gate_g, gate_g, down_g))(
        x, probs, counts, w_gate, w_up, w_down)
    return y, aux
