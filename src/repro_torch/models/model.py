"""Model protocol + dispatcher (the counterpart of ``repro.models.model``).

Every family implements:

  param_specs()                       -> SpecTree (shapes/dtypes/logical axes)
  forward(params, batch)              -> logits (B, S, V), aux dict
  cache_specs(batch, max_seq)         -> SpecTree for the decode cache
  decode_step(params, cache, tokens, cur_index, active=None)
                                      -> (logits (B, 1, V), cache)
  extra_input_specs(batch)            -> the modality stub's inputs

``init``, ``loss`` and ``input_specs`` are shared. Params and caches are
plain nested dicts.

Decode differs from the reference's in one way, for the card's sake: a
KV cache leaf is written **in place** (a scatter at each lane's position),
so that a step never copies the whole cache; recurrent state leaves come
back as new tensors in the dtypes the step computes them in, as the
reference's do. ``cur_index`` is one position for the batch or a (B,)
tensor, one a lane, so one batched step does what the reference's
``vmap`` over single-lane steps does (:meth:`BaseModel.decode_step_lanes`).
Lanes where ``active`` is false keep every cache value bit for bit: their
K/V slot is rewritten with its old value and their state is the old one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.dist.sharding import (
    current_rules,
    is_dtensor,
    like,
    on_shards,
    product_grads,
    shard_of,
)
from repro_torch.models.module import (
    SpecTree,
    abstract_from_specs,
    init_from_specs,
    tree_map,
)


class BaseModel:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    # -- to be provided by families -----------------------------------------
    def param_specs(self) -> SpecTree:
        raise NotImplementedError

    def forward(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def cache_specs(self, batch_size: int, max_seq: int) -> SpecTree:
        raise NotImplementedError

    def decode_step(self, params, cache, tokens, cur_index, active=None):
        raise NotImplementedError

    # -- shared --------------------------------------------------------------
    def init(self, seed: int = 0, *, device="cuda", dtype=None):
        """Parameters drawn from a ``torch.Generator`` on ``device`` seeded
        with ``seed``. Torch's draws differ from ``jax.random``'s: to start
        from the reference's weights use ``params_from_reference``."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return init_from_specs(self.param_specs(), gen, device, dtype=dtype)

    def init_cache(self, batch_size: int, max_seq: int, device):
        """The zero cache of ``cache_specs`` on ``device``."""
        return init_from_specs(self.cache_specs(batch_size, max_seq), None,
                               device)

    def abstract_params(self, dtype=None):
        """The parameters' shapes and dtypes, as ``meta`` tensors."""
        return abstract_from_specs(self.param_specs(), dtype=dtype)

    def abstract_cache(self, batch_size: int, max_seq: int):
        """The cache's shapes and dtypes, as ``meta`` tensors."""
        return abstract_from_specs(self.cache_specs(batch_size, max_seq))

    def loss(self, params, batch) -> torch.Tensor:
        logits, aux = self.forward(params, batch)
        ce = cross_entropy(logits, batch["labels"])
        return ce + 0.01 * aux.get("moe_aux", 0.0)

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """``meta`` stand-ins for every model input of ``shape``."""
        b, s = shape.global_batch, shape.seq_len

        def ints(*dims):
            return torch.empty(dims, dtype=torch.int32, device="meta")

        if shape.kind in ("train", "prefill"):
            out = {"tokens": ints(b, s)}
            if shape.kind == "train":
                out["labels"] = ints(b, s)
            out.update(self.extra_input_specs(b))
            return out
        # decode: one new token against a max_seq cache
        return {"tokens": ints(b, 1)}

    def extra_input_specs(self, batch_size: int) -> Dict[str, Any]:
        """Modality-frontend stub inputs (patch/frame embeddings)."""
        return {}

    def steady_decode_cache(self, params, cache):
        """Cast cache leaves to the dtypes one ``decode_step`` application
        emits (its dtype fixed point).

        Some families return a cache leaf wider than its spec (the Mamba2
        conv window comes back f32 against a bf16 spec). A fixed-shape step
        that writes each leaf back into its buffer must pick one dtype up
        front: casting back to the spec's dtype every step would round the
        recurrent state each token. The dtypes are read off one step run on
        the ``meta`` device (no storage, no arithmetic); casting the zero
        cache up front is lossless.
        """
        def meta(t):
            return torch.empty(t.shape, dtype=t.dtype, device="meta")

        batch = next(iter(cache.values())).shape[CACHE_BATCH_AXIS]
        _, evolved = self.decode_step(
            tree_map(meta, params), tree_map(meta, cache),
            torch.zeros((batch, 1), dtype=torch.long, device="meta"),
            torch.zeros((), dtype=torch.long, device="meta"))
        return {k: v.to(evolved[k].dtype) for k, v in cache.items()}

    def decode_step_lanes(self, params, cache, tokens, positions, active=None):
        """Per-lane decode: every batch lane advances at its *own* position
        (continuous batching, where lane b holds a request ``positions[b]``
        tokens deep). The reference vmaps its single-lane ``decode_step``
        over the cache's batch axis; the port's ``decode_step`` takes a
        position a lane directly: RoPE, the K/V write and the mask are each
        lane's own.

        tokens ``(B, 1)``, positions ``(B,)`` -> (logits ``(B, 1, Vp)``,
        cache).
        """
        if positions.shape != (tokens.shape[0],):
            raise ValueError(f"positions {tuple(positions.shape)} must be "
                             f"one a lane of tokens {tuple(tokens.shape)}")
        return self.decode_step(params, cache, tokens, positions, active)


# Every family lays its decode cache out as (layers, batch, ...): the batch
# ("lane") axis is axis 1 of every leaf (dense, MoE and VLM KV, SSM/conv
# state and the hybrid's KV, wkv/shift state, the encoder-decoder's self
# and cross K/V). The lane helpers below key off it.
CACHE_BATCH_AXIS = 1


def _lane_index(lane, device) -> torch.Tensor:
    return torch.as_tensor(lane, dtype=torch.long, device=device).reshape(1)


def cache_lane(cache, lane):
    """A copy of one lane (batch index kept, size 1) of a cache; ``lane``
    is an int or a one-element tensor on the cache's device."""
    return {k: v.index_select(CACHE_BATCH_AXIS, _lane_index(lane, v.device))
            for k, v in cache.items()}


def set_cache_lane(cache, lane_cache, lane):
    """Write a single-lane cache into ``cache`` at batch index ``lane``, in
    place (dtypes follow the destination); returns ``cache``."""
    for k, full in cache.items():
        full.index_copy_(CACHE_BATCH_AXIS, _lane_index(lane, full.device),
                         lane_cache[k].to(full.dtype))
    return cache


def zero_cache_lane(cache, lane):
    """Zero one lane of every cache leaf in place — the evict/admit barrier;
    returns ``cache``.

    Attention caches are self-masking (``kpos <= cur_index`` hides stale
    keys), but recurrent state (SSM/conv/wkv/token-shift) is *not*: a new
    request prefilling into a lane still holding its predecessor's state
    would be conditioned on a conversation it never saw.
    """
    for v in cache.values():
        v.index_fill_(CACHE_BATCH_AXIS, _lane_index(lane, v.device), 0)
    return cache


def decode_positions(cur_index, batch: int, device) -> torch.Tensor:
    """``cur_index`` (an int, a 0-d or a (B,) tensor) as a (B,) long tensor
    of each lane's position."""
    cur = torch.as_tensor(cur_index, device=device).long()
    return cur.expand(batch) if cur.dim() == 0 else cur


def kv_slots(positions: torch.Tensor, cache_len: int):
    """Where one step writes its K/V in a (B, S, Hkv, D) layer cache: each
    lane's index and its position, clamped to the last slot as the
    reference's ``dynamic_update_slice`` clamps (the padded tail of a
    prompt's last prefill chunk can reach past the cache, masked).
    Computed once a step for every layer."""
    lanes = torch.arange(positions.shape[0], device=positions.device)
    return lanes, torch.clamp(positions, max=cache_len - 1)


def write_kv(cache_l, slots, new, active: Optional[torch.Tensor]):
    """Write one token's K or V, ``new`` (B, 1, Hkv, D), into one layer's
    cache ``cache_l`` (B, S, Hkv, D) at :func:`kv_slots`, in place and in
    the cache's dtype; a lane where ``active`` is false keeps its old
    value."""
    if is_dtensor(cache_l):
        return _write_kv_sharded(cache_l, slots[1], new, active)
    val = new[:, 0].to(cache_l.dtype)
    if active is not None:
        val = torch.where(active[:, None, None], val, cache_l[slots])
    cache_l[slots] = val


def _write_kv_sharded(cache_l, positions, new, active) -> None:
    """:func:`write_kv` of a DTensor cache, shard by shard: each device
    writes the lanes it holds whose position falls in its block of the
    sequence, at the position less the block's offset, and rewrites its
    other lanes' slot with their old value."""
    mesh, placements = cache_l.device_mesh, cache_l.placements
    _, offset = shard_of(mesh, placements, cache_l.shape)
    lane_p = [Shard(0) if p == Shard(0) else Replicate() for p in placements]
    new_p = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
             for p in placements]
    if active is None:
        active = torch.ones(positions.shape, dtype=torch.bool,
                            device=positions.device)

    def local(c, pos, val, act):
        lanes = torch.arange(c.shape[0], device=c.device)
        idx = pos - offset[1]
        inside = act & (idx >= 0) & (idx < c.shape[1])
        slot = (lanes, torch.clamp(idx, 0, c.shape[1] - 1))
        c[slot] = torch.where(inside[:, None, None], val[:, 0].to(c.dtype),
                              c[slot])

    on_shards(local, mesh, None, (placements, lane_p, new_p, lane_p))(
        cache_l, like(cache_l, positions), new, like(cache_l, active))


def keep_state(new, old, active: Optional[torch.Tensor]):
    """A recurrent state leaf after one step: ``new`` on active lanes, the
    old value elsewhere (``active`` is one flag a lane, axis 1 of the
    stacked leaf)."""
    if active is None:
        return new
    mask = active.reshape((1, -1) + (1,) * (new.dim() - 2))
    return torch.where(mask, new, old)


# the logits' logical axes
LOGITS = ("batch", "seq", "act_vocab")


def masked_lm_head(h, w, vocab: int):
    """Logits over the padded vocab with pad slots masked to -inf (exact CE
    under Megatron-style vocab padding). Under active rules, DTensor logits
    are laid out as the rules lay out :data:`LOGITS` (:func:`_head_to`)."""
    if is_dtensor(w) and current_rules() is not None:
        logits = _head_to(h, w)
    else:
        logits = torch.einsum("bsd,dv->bsv", h, w)
    vp = w.shape[-1]
    if vp == vocab:
        return logits
    mask = torch.arange(vp, device=logits.device) < vocab
    return torch.where(like(logits, mask[None, None, :]), logits, -1e30)


def _head_to(h, w):
    """``einsum("bsd,dv->bsv", h, w)`` on DTensors, shard by shard, straight
    into the rules' layout of :data:`LOGITS`: ``h`` split as the logits' batch
    and sequence, ``w`` gathered on its input dim and split as their vocab.
    (The product does not see the hint that follows it; left to itself,
    DTensor gathers the activations over a sequence split and makes every
    device compute every logit.)"""
    rules = current_rules()
    shape = (h.shape[0], h.shape[1], w.shape[1])
    # one token a lane (decode): a mesh axis that the sequence would claim
    # but cannot split is left to the vocab
    axes = LOGITS if shape[1] > 1 else (LOGITS[0], None, LOGITS[2])
    out = list(rules.placements(rules.spec_for_shape(axes, shape)))
    hp = [p if p.is_shard() and p.dim < 2 else Replicate() for p in out]
    wp = [Shard(1) if p.is_shard(2) else Replicate() for p in out]
    return on_shards(lambda h, w: torch.einsum("bsd,dv->bsv", h, w),
                     w.device_mesh, out, (hp, wp), product_grads(hp, wp))(h, w)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy; labels are pre-shifted by the pipeline.
    One row a token. DTensor logits whose vocab is split over more than one
    device take :func:`_vocab_parallel_ce` (DTensor would gather the whole
    vocab for the log-sum-exp and scatter the gather's gradient into it);
    others have their vocab rows made whole first."""
    logits = logits.float().reshape(-1, logits.shape[-1])
    labels = labels.long().reshape(-1, 1)
    if is_dtensor(logits):
        if _split_dims(logits, 1):
            return torch.mean(_vocab_parallel_ce(logits, labels))
        # whole vocab rows on every device: no masked gather
        logits = logits.redistribute(logits.device_mesh, [
            Replicate() if p.is_shard(1) else p for p in logits.placements])
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    gold = torch.gather(logits, -1, labels)
    return torch.mean(logz - gold)


def _split_dims(x, dim: int) -> list:
    """The mesh dims of more than one device that split ``x``'s ``dim``."""
    return [i for i, p in enumerate(x.placements)
            if p.is_shard(dim) and x.device_mesh.size(i) > 1]


def _vocab_parallel_ce(logits, labels):
    """Each row's ``logsumexp - gold`` of (N, V) DTensor logits, shard by
    shard (Megatron's vocab-parallel cross-entropy): each device holds a
    block of the vocab; the row maxima, the sums of exponentials and the
    gold logits are reduced over the vocab's mesh dims, never the logits."""
    mesh = logits.device_mesh
    lp = [p if p.is_shard(0) or p.is_shard(1) else Replicate()
          for p in logits.placements]
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in lp]
    _, offset = shard_of(mesh, lp, logits.shape)
    groups = [mesh.get_group(i) for i in _split_dims(logits, 1)]
    return on_shards(lambda l, y: _VocabCE.apply(l, y, offset[1], groups),
                     mesh, rows, (lp, rows))(logits, labels)


class _VocabCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, l, y, offset, groups):
        from torch.distributed import _functional_collectives as funcol

        def reduce(t, op):
            for g in groups:
                t = funcol.all_reduce(t, op, g)
            return t

        m = reduce(l.amax(dim=-1, keepdim=True), "max")
        s = reduce(torch.exp(l - m).sum(dim=-1, keepdim=True), "sum")
        idx = y - offset
        inside = (idx >= 0) & (idx < l.shape[1])
        idx = torch.clamp(idx, 0, l.shape[1] - 1)
        gold = reduce(torch.where(inside, torch.gather(l, 1, idx), 0.0), "sum")
        lse = torch.log(s) + m
        ctx.save_for_backward(l, lse, idx, inside)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        l, lse, idx, inside = ctx.saved_tensors
        grad = torch.exp(l - lse) * g
        grad.scatter_add_(1, idx, -(g * inside))
        return grad, None, None, None


def build_model(cfg: ArchConfig) -> BaseModel:
    from repro_torch.models import encdec, moe_model, rwkv, ssm, transformer

    if cfg.family in ("dense", "vlm"):
        return transformer.DenseLM(cfg)
    if cfg.family == "moe":
        return moe_model.MoeLM(cfg)
    if cfg.family == "hybrid":
        return ssm.Zamba2LM(cfg)
    if cfg.family == "ssm":
        return ssm.Mamba2LM(cfg)
    if cfg.family == "rwkv":
        return rwkv.Rwkv6LM(cfg)
    if cfg.family == "encdec":
        return encdec.WhisperLM(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")
