"""Dense decoder-only transformer (GQA / RoPE / SwiGLU / qk-norm / SWA), the
counterpart of ``repro.models.transformer.DenseLM``; with family ``"vlm"``
it takes precomputed patch embeddings ahead of the tokens (internvl2-26b's
vision tower is a stub, as in the reference).

Layers are stacked along a leading "layers" dim as in the reference, so a
parameter tree has the same 14 leaves in both packages. The forward pass
unbinds each stacked leaf once (its backward is one stack, not one
full-size scatter per layer) and runs the layers in a loop; ``cfg.remat``
recomputes each layer in backward through ``torch.utils.checkpoint``.
Decode keeps a bf16 KV cache a layer (a ring buffer of the window's length
for sliding-window configs) and runs in plain torch on every device, as the
reference's does in XLA.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models.model import (
    LOGITS,
    BaseModel,
    decode_positions,
    kv_slots,
    masked_lm_head,
    write_kv,
)
from repro_torch.models.module import ParamSpec, _flatten, _unflatten


# the residual stream's layout. The reference hints it at each block's output
# and GSPMD infers the rest; DTensor places each operator on its own, so the
# residual after attention (a partial sum over the heads' shards) is held to
# it too
ACT = ("batch", "seq", "act_embed")


def _attn_specs(cfg: ArchConfig, n_layers: int,
                prefix_axes=("layers",)) -> Dict[str, ParamSpec]:
    """Attention weights stacked over ``n_layers``; with ``prefix_axes=()``
    one unstacked set (Zamba2's shared block)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lead, lax = ((n_layers,) if prefix_axes else ()), prefix_axes
    out = {
        "wq": ParamSpec(lead + (d, h, hd), lax + ("embed", "heads", "head_dim")),
        "wk": ParamSpec(lead + (d, kv, hd), lax + ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec(lead + (d, kv, hd), lax + ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec(lead + (h, hd, d), lax + ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        out["q_norm"] = ParamSpec(lead + (hd,), lax + ("head_dim",), init="ones")
        out["k_norm"] = ParamSpec(lead + (hd,), lax + ("head_dim",), init="ones")
    return out


def unstack(stacked: Dict[str, torch.Tensor]):
    """One (nested) dict of leaves per layer, each stacked leaf unbound
    once."""
    paths, leaves = zip(*_flatten(stacked))
    return [_unflatten(dict(zip(paths, layer)))
            for layer in zip(*(torch.unbind(v, 0) for v in leaves))]


def _mlp_specs(cfg: ArchConfig, n_layers: int,
               prefix_axes=("layers",)) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    lead, lax = ((n_layers,) if prefix_axes else ()), prefix_axes
    return {
        "w_gate": ParamSpec(lead + (d, f), lax + ("embed", "mlp")),
        "w_up": ParamSpec(lead + (d, f), lax + ("embed", "mlp")),
        "w_down": ParamSpec(lead + (f, d), lax + ("mlp", "embed")),
    }


class DenseLM(BaseModel):
    """Decoder-only LM."""

    def param_specs(self):
        cfg = self.cfg
        nl = cfg.n_layers
        block = {
            "ln1": ParamSpec((nl, cfg.d_model), ("layers", "embed"), init="ones"),
            "ln2": ParamSpec((nl, cfg.d_model), ("layers", "embed"), init="ones"),
            **_attn_specs(cfg, nl),
            **_mlp_specs(cfg, nl),
        }
        return {
            "embed": ParamSpec((cfg.padded_vocab, cfg.d_model),
                               ("vocab", "embed"), init="embed", scale=0.02),
            "blocks": block,
            "ln_f": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
            "lm_head": ParamSpec((cfg.d_model, cfg.padded_vocab), ("embed", "vocab")),
        }

    def _attn(self, lp, x, positions):
        cfg = self.cfg
        q = L.project_heads(x, lp["wq"])
        k = L.project_heads(x, lp["wk"])
        v = L.project_heads(x, lp["wv"])
        if cfg.qk_norm:
            q = L.rms_norm(q, lp["q_norm"])
            k = L.rms_norm(k, lp["k_norm"])
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        q = constrain(q, ("batch", "seq", "act_heads", None))
        o = L.attention(q, k, v, causal=True, window=cfg.sliding_window)
        return L.merge_heads(o, lp["wo"])

    def _block_train(self, lp, h, positions):
        x = L.rms_norm(h, lp["ln1"])
        h = constrain(h + self._attn(lp, x, positions), ACT)
        x = L.rms_norm(h, lp["ln2"])
        h = h + L.swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])
        return constrain(h, ACT)

    def _embed_inputs(self, params, batch):
        """Token embeddings, with a VLM's patch embeddings prepended."""
        h = L.embed(params["embed"], batch["tokens"])
        if self.cfg.family == "vlm" and "patch_embeds" in batch:
            h = torch.cat([batch["patch_embeds"].to(h.dtype), h], dim=1)
        return h

    def forward(self, params, batch):
        cfg = self.cfg
        h = self._embed_inputs(params, batch)
        h = constrain(h, ACT)
        positions = torch.arange(h.shape[1], device=h.device)
        for lp in unstack(params["blocks"]):
            if cfg.remat:
                h = checkpoint(self._block_train, lp, h, positions,
                               use_reentrant=False)
            else:
                h = self._block_train(lp, h, positions)
        h = L.rms_norm(h, params["ln_f"])
        if cfg.family == "vlm" and "patch_embeds" in batch:
            h = h[:, batch["patch_embeds"].shape[1]:]  # logits for text positions
        logits = masked_lm_head(h, params["lm_head"], cfg.vocab)
        logits = constrain(logits, LOGITS)
        return logits, {}

    def extra_input_specs(self, batch_size: int):
        if self.cfg.family == "vlm":
            return {"patch_embeds": torch.empty(
                (batch_size, self.cfg.n_patches, self.cfg.d_model),
                dtype=torch.bfloat16, device="meta")}
        return {}

    # -- decode ----------------------------------------------------------------
    def cache_len(self, max_seq: int) -> int:
        cfg = self.cfg
        if cfg.sliding_window is not None:
            return min(max_seq, cfg.sliding_window)
        return max_seq

    def cache_specs(self, batch_size: int, max_seq: int,
                    dtype=torch.bfloat16):
        cfg = self.cfg
        sc = self.cache_len(max_seq)
        shape = (cfg.n_layers, batch_size, sc, cfg.n_kv_heads, cfg.head_dim)
        axes = ("layers", "batch", "seq", "kv_heads", "head_dim")
        return {
            "k": ParamSpec(shape, axes, dtype=dtype, init="zeros"),
            "v": ParamSpec(shape, axes, dtype=dtype, init="zeros"),
        }

    def decode_step(self, params, cache, tokens, cur_index, active=None):
        """One token a lane: write each layer's K/V at the lane's position
        (in place), attend, return the logits.

        Sliding-window configs keep a ring buffer of window length: the
        token is written at ``cur % sc`` and, once the buffer is full,
        every slot is valid (the attention index is ``min(cur, sc - 1)``).
        """
        cfg = self.cfg
        h = L.embed(params["embed"], tokens)  # (B, 1, D)
        cur = decode_positions(cur_index, h.shape[0], h.device)
        sc = cache["k"].shape[2]
        if cfg.sliding_window is not None:
            write_at, attend_to = cur % sc, torch.clamp(cur, max=sc - 1)
        else:
            write_at, attend_to = cur, cur
        slots = kv_slots(write_at, sc)
        cos, sin = L.rope_cos_sin(cur[:, None], cfg.head_dim, cfg.rope_theta)
        for li, lp in enumerate(unstack(params["blocks"])):
            x = L.rms_norm(h, lp["ln1"])
            q = L.project_heads(x, lp["wq"])
            k = L.project_heads(x, lp["wk"])
            v = L.project_heads(x, lp["wv"])
            if cfg.qk_norm:
                q = L.rms_norm(q, lp["q_norm"])
                k = L.rms_norm(k, lp["k_norm"])
            q, k = L.rotate(q, cos, sin), L.rotate(k, cos, sin)
            k_cache, v_cache = cache["k"][li], cache["v"][li]
            write_kv(k_cache, slots, k, active)
            write_kv(v_cache, slots, v, active)
            o = L.decode_attention(q, k_cache, v_cache, attend_to)
            h = h + L.merge_heads(o, lp["wo"])
            x = L.rms_norm(h, lp["ln2"])
            h = h + self._decode_ffn(lp, x)
        h = L.rms_norm(h, params["ln_f"])
        logits = masked_lm_head(h, params["lm_head"], cfg.vocab)
        return logits, {"k": cache["k"], "v": cache["v"]}

    def _decode_ffn(self, lp, x):
        """The FFN of one decode token a lane."""
        return L.swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])
