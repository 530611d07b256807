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

from repro_torch.configs.base import ArchConfig, ShapeConfig
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
    val = new[:, 0].to(cache_l.dtype)
    if active is not None:
        val = torch.where(active[:, None, None], val, cache_l[slots])
    cache_l[slots] = val


def keep_state(new, old, active: Optional[torch.Tensor]):
    """A recurrent state leaf after one step: ``new`` on active lanes, the
    old value elsewhere (``active`` is one flag a lane, axis 1 of the
    stacked leaf)."""
    if active is None:
        return new
    mask = active.reshape((1, -1) + (1,) * (new.dim() - 2))
    return torch.where(mask, new, old)


def masked_lm_head(h, w, vocab: int):
    """Logits over the padded vocab with pad slots masked to -inf (exact CE
    under Megatron-style vocab padding)."""
    logits = torch.einsum("bsd,dv->bsv", h, w)
    vp = w.shape[-1]
    if vp == vocab:
        return logits
    mask = torch.arange(vp, device=logits.device) < vocab
    return torch.where(mask[None, None, :], logits, -1e30)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy; labels are pre-shifted by the pipeline."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


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
