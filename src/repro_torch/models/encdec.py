"""Whisper-large-v3-style encoder-decoder backbone (the counterpart of
``repro.models.encdec``).

The conv/mel frontend is a stub, as in the reference: the inputs carry
precomputed frame embeddings ``frames`` (B, n_frames, d_model). Encoder = a
bidirectional transformer with learned positions; decoder = a causal
transformer with cross-attention (RoPE in its self-attention, the
reference's deviation from Whisper's learned positions). On a CUDA tensor
all three attentions (the encoder's, the decoder's causal one and its
cross-attention, whose queries and keys differ in length) go to the flash
attention kernels through :func:`layers.attention`.

Decode keeps the decoder's self K/V (written in place at each lane's
position) and cross K/V of ``n_frames`` a lane in its cache. Like the
reference's engine, nothing here fills the cross K/V from the encoder: the
engine's cache starts at zero and decode attends to those zeros.

On DTensors (the GSPMD path) the residual streams take the reference's
hints (``constrain`` at each embedding, each block's output and the
logits), and the decoder's after each attention too, as ``DenseLM``'s do.
Heads are projected and merged shard by shard (:func:`layers.
project_heads`, :func:`layers.merge_heads`), so whisper's 20 heads run on
a 16-way "model" axis, and all three attentions go through
:func:`layers.attention`'s layout (a sequence split moves to the heads;
heads that do not divide are gathered).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

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
from repro_torch.models.module import ParamSpec
from repro_torch.models.transformer import ACT, unstack


def _ln(nl, d):
    return {
        "w": ParamSpec((nl, d), ("layers", "embed"), init="ones"),
        "b": ParamSpec((nl, d), ("layers", "embed"), init="zeros"),
    }


def _final_ln(d):
    return {"w": ParamSpec((d,), ("embed",), init="ones"),
            "b": ParamSpec((d,), ("embed",), init="zeros")}


def _mha(nl, d, h, kv, hd):
    return {
        "wq": ParamSpec((nl, d, h, hd), ("layers", "embed", "heads", "head_dim")),
        "wk": ParamSpec((nl, d, kv, hd), ("layers", "embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((nl, d, kv, hd), ("layers", "embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((nl, h, hd, d), ("layers", "heads", "head_dim", "embed")),
    }


def _gelu_mlp(nl, d, f):
    return {
        "w_in": ParamSpec((nl, d, f), ("layers", "embed", "mlp")),
        "b_in": ParamSpec((nl, f), ("layers", "mlp"), init="zeros"),
        "w_out": ParamSpec((nl, f, d), ("layers", "mlp", "embed")),
        "b_out": ParamSpec((nl, d), ("layers", "embed"), init="zeros"),
    }


def _norm(x, ln):
    return L.layer_norm(x, ln["w"], ln["b"])


def _mlp(lp, x):
    return L.gelu_mlp(x, lp["w_in"], lp["b_in"], lp["w_out"], lp["b_out"])


class WhisperLM(BaseModel):
    def param_specs(self):
        cfg = self.cfg
        d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cfg.d_ff)
        ne, nd = cfg.n_enc_layers, cfg.n_layers
        enc_block = {
            "ln1": _ln(ne, d), "ln2": _ln(ne, d),
            **_mha(ne, d, h, kv, hd), **_gelu_mlp(ne, d, f),
        }
        dec_block = {
            "ln1": _ln(nd, d), "ln_x": _ln(nd, d), "ln2": _ln(nd, d),
            **_mha(nd, d, h, kv, hd),
            "xq": ParamSpec((nd, d, h, hd), ("layers", "embed", "heads", "head_dim")),
            "xk": ParamSpec((nd, d, kv, hd), ("layers", "embed", "kv_heads", "head_dim")),
            "xv": ParamSpec((nd, d, kv, hd), ("layers", "embed", "kv_heads", "head_dim")),
            "xo": ParamSpec((nd, h, hd, d), ("layers", "heads", "head_dim", "embed")),
            **_gelu_mlp(nd, d, f),
        }
        return {
            "enc_pos": ParamSpec((cfg.n_frames, d), ("frames", "embed"),
                                 scale=0.02),
            "enc_blocks": enc_block,
            "enc_ln_f": _final_ln(d),
            "embed": ParamSpec((cfg.padded_vocab, d), ("vocab", "embed"),
                               init="embed", scale=0.02),
            "dec_blocks": dec_block,
            "ln_f": _final_ln(d),
            "lm_head": ParamSpec((d, cfg.padded_vocab), ("embed", "vocab")),
        }

    # -- encoder ----------------------------------------------------------------
    def _enc_block(self, lp, h):
        x = _norm(h, lp["ln1"])
        q, k, v = (L.project_heads(x, lp[w]) for w in ("wq", "wk", "wv"))
        o = L.attention(q, k, v, causal=False)
        h = constrain(h + L.merge_heads(o, lp["wo"]), ACT)
        return constrain(h + _mlp(lp, _norm(h, lp["ln2"])), ACT)

    def encode(self, params, frames):
        h = constrain(frames + params["enc_pos"][None].to(frames.dtype), ACT)
        for lp in unstack(params["enc_blocks"]):
            if self.cfg.remat:
                h = checkpoint(self._enc_block, lp, h, use_reentrant=False)
            else:
                h = self._enc_block(lp, h)
        return _norm(h, params["enc_ln_f"])

    # -- decoder ----------------------------------------------------------------
    def _dec_block(self, lp, h, enc_out, positions):
        cfg = self.cfg
        x = _norm(h, lp["ln1"])
        q = L.apply_rope(L.project_heads(x, lp["wq"]), positions, cfg.rope_theta)
        k = L.apply_rope(L.project_heads(x, lp["wk"]), positions, cfg.rope_theta)
        o = L.attention(q, k, L.project_heads(x, lp["wv"]), causal=True)
        h = constrain(h + L.merge_heads(o, lp["wo"]), ACT)
        x = _norm(h, lp["ln_x"])
        o = L.attention(L.project_heads(x, lp["xq"]),
                        L.project_heads(enc_out, lp["xk"]),
                        L.project_heads(enc_out, lp["xv"]), causal=False)
        h = constrain(h + L.merge_heads(o, lp["xo"]), ACT)
        return constrain(h + _mlp(lp, _norm(h, lp["ln2"])), ACT)

    def forward(self, params, batch):
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"])
        h = constrain(L.embed(params["embed"], batch["tokens"]), ACT)
        positions = torch.arange(h.shape[1], device=h.device)
        for lp in unstack(params["dec_blocks"]):
            if cfg.remat:
                h = checkpoint(self._dec_block, lp, h, enc_out, positions,
                               use_reentrant=False)
            else:
                h = self._dec_block(lp, h, enc_out, positions)
        h = _norm(h, params["ln_f"])
        logits = masked_lm_head(h, params["lm_head"], cfg.vocab)
        return constrain(logits, LOGITS), {}

    # -- decode -------------------------------------------------------------------
    def cache_specs(self, batch_size: int, max_seq: int,
                    dtype=torch.bfloat16):
        cfg = self.cfg
        nd = cfg.n_layers
        self_shape = (nd, batch_size, max_seq, cfg.n_kv_heads, cfg.head_dim)
        cross_shape = (nd, batch_size, cfg.n_frames, cfg.n_kv_heads, cfg.head_dim)
        ax = ("layers", "batch", "seq", "kv_heads", "head_dim")
        xax = ("layers", "batch", "frames", "kv_heads", "head_dim")
        return {
            "k": ParamSpec(self_shape, ax, dtype=dtype, init="zeros"),
            "v": ParamSpec(self_shape, ax, dtype=dtype, init="zeros"),
            "xk": ParamSpec(cross_shape, xax, dtype=dtype, init="zeros"),
            "xv": ParamSpec(cross_shape, xax, dtype=dtype, init="zeros"),
        }

    def decode_step(self, params, cache, tokens, cur_index, active=None):
        """One decoder token a lane: self K/V written in place at the lane's
        position; the cross K/V are read from the cache, all ``n_frames``
        of them, and come back unchanged."""
        cfg = self.cfg
        h = L.embed(params["embed"], tokens)
        cur = decode_positions(cur_index, h.shape[0], h.device)
        slots = kv_slots(cur, cache["k"].shape[2])
        cos, sin = L.rope_cos_sin(cur[:, None], cfg.head_dim, cfg.rope_theta)
        # every lane attends to all n_frames cross keys; a tensor made on
        # the device, so that a captured step copies nothing from the host
        last_frame = torch.full_like(cur, cache["xk"].shape[2] - 1)
        for li, lp in enumerate(unstack(params["dec_blocks"])):
            x = _norm(h, lp["ln1"])
            q = L.rotate(L.project_heads(x, lp["wq"]), cos, sin)
            k = L.rotate(L.project_heads(x, lp["wk"]), cos, sin)
            k_c, v_c = cache["k"][li], cache["v"][li]
            write_kv(k_c, slots, k, active)
            write_kv(v_c, slots, L.project_heads(x, lp["wv"]), active)
            h = h + L.merge_heads(L.decode_attention(q, k_c, v_c, cur), lp["wo"])
            x = _norm(h, lp["ln_x"])
            o = L.decode_attention(L.project_heads(x, lp["xq"]), cache["xk"][li],
                                   cache["xv"][li], last_frame)
            h = h + L.merge_heads(o, lp["xo"])
            h = h + _mlp(lp, _norm(h, lp["ln2"]))
        h = _norm(h, params["ln_f"])
        logits = masked_lm_head(h, params["lm_head"], cfg.vocab)
        return logits, dict(cache)

    def extra_input_specs(self, batch_size: int):
        return {"frames": torch.empty(
            (batch_size, self.cfg.n_frames, self.cfg.d_model),
            dtype=torch.bfloat16, device="meta")}
