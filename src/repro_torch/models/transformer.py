"""Dense decoder-only transformer (GQA / RoPE / SwiGLU / qk-norm / SWA), the
counterpart of ``repro.models.transformer.DenseLM``.

Layers are stacked along a leading "layers" dim as in the reference, so a
parameter tree has the same 14 leaves in both packages. The forward pass
unbinds each stacked leaf once (its backward is one stack, not one
full-size scatter per layer) and runs the layers in a loop; ``cfg.remat``
recomputes each layer in backward through ``torch.utils.checkpoint``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.model import BaseModel, masked_lm_head
from repro_torch.models.module import ParamSpec


def _attn_specs(cfg: ArchConfig, n_layers: int) -> Dict[str, ParamSpec]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lead, lax = (n_layers,), ("layers",)
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


def _mlp_specs(cfg: ArchConfig, n_layers: int) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    lead, lax = (n_layers,), ("layers",)
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
        q = torch.einsum("bsd,dhk->bshk", x, lp["wq"])
        k = torch.einsum("bsd,dhk->bshk", x, lp["wk"])
        v = torch.einsum("bsd,dhk->bshk", x, lp["wv"])
        if cfg.qk_norm:
            q = L.rms_norm(q, lp["q_norm"])
            k = L.rms_norm(k, lp["k_norm"])
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        o = L.attention(q, k, v, causal=True, window=cfg.sliding_window)
        return torch.einsum("bshk,hkd->bsd", o, lp["wo"])

    def _block_train(self, lp, h, positions):
        x = L.rms_norm(h, lp["ln1"])
        h = h + self._attn(lp, x, positions)
        x = L.rms_norm(h, lp["ln2"])
        return h + L.swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])

    def forward(self, params, batch):
        cfg = self.cfg
        h = params["embed"][batch["tokens"].long()]
        positions = torch.arange(h.shape[1], device=h.device)
        names = list(params["blocks"])
        per_layer = zip(*(torch.unbind(params["blocks"][n], 0) for n in names))
        for leaves in per_layer:
            lp = dict(zip(names, leaves))
            if cfg.remat:
                h = checkpoint(self._block_train, lp, h, positions,
                               use_reentrant=False)
            else:
                h = self._block_train(lp, h, positions)
        h = L.rms_norm(h, params["ln_f"])
        logits = masked_lm_head(h, params["lm_head"], cfg.vocab)
        return logits, {}
