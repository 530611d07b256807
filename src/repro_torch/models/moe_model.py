"""Mixture-of-experts LM (the counterpart of ``repro.models.moe_model``):
phi3.5-moe (16 experts, top-2) and arctic-480b (128 experts, top-2, with a
*dense residual* MLP in parallel: Snowflake's dense+MoE hybrid).

Training routes each rank's tokens through :func:`layers.moe_ffn` at the
config's capacity factor, so capacity follows the rank's own token count.
Decode gives every lane what the reference's engine gives it, which runs
its single-lane ``decode_step`` under ``vmap``: routing at one token, where
the capacity, ``max(ceil(k / E * cf), k)``, never drops it. Routed over the
whole batch at the config's factor instead, lanes would take each other's
expert slots, so a decode step routes at the factor ``E / k``, at which no
token is dropped either: each lane's output is its own dropless top-k
mixture, whatever the other lanes hold.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.model import masked_lm_head
from repro_torch.models.module import ParamSpec
from repro_torch.models.transformer import DenseLM, _attn_specs, _mlp_specs, unstack


class MoeLM(DenseLM):
    """DenseLM with the FFN replaced (or paralleled) by a routed MoE."""

    def param_specs(self):
        cfg = self.cfg
        nl = cfg.n_layers
        d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_dff or cfg.d_ff
        block = {
            "ln1": ParamSpec((nl, d), ("layers", "embed"), init="ones"),
            "ln2": ParamSpec((nl, d), ("layers", "embed"), init="ones"),
            **_attn_specs(cfg, nl),
            "router": ParamSpec((nl, d, e), ("layers", "embed", "experts"),
                                scale=0.02),
            "we_gate": ParamSpec((nl, e, d, f),
                                 ("layers", "experts", "embed", "moe_mlp")),
            "we_up": ParamSpec((nl, e, d, f),
                               ("layers", "experts", "embed", "moe_mlp")),
            "we_down": ParamSpec((nl, e, f, d),
                                 ("layers", "experts", "moe_mlp", "embed")),
        }
        if cfg.dense_residual:
            block.update(_mlp_specs(cfg, nl))  # arctic's parallel dense MLP
        return {
            "embed": ParamSpec((cfg.padded_vocab, d), ("vocab", "embed"),
                               init="embed", scale=0.02),
            "blocks": block,
            "ln_f": ParamSpec((d,), ("embed",), init="ones"),
            "lm_head": ParamSpec((d, cfg.padded_vocab), ("embed", "vocab")),
        }

    def _ffn(self, lp, x, capacity_factor=None):
        cfg = self.cfg
        y, aux = L.moe_ffn(
            x, lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"],
            top_k=cfg.top_k,
            capacity_factor=(cfg.moe_capacity if capacity_factor is None
                             else capacity_factor))
        if cfg.dense_residual:
            y = y + L.swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])
        return y, aux

    def _block_train(self, lp, h, positions):
        x = L.rms_norm(h, lp["ln1"])
        h = h + self._attn(lp, x, positions)
        x = L.rms_norm(h, lp["ln2"])
        y, aux = self._ffn(lp, x)
        return h + y, aux

    def forward(self, params, batch):
        cfg = self.cfg
        h = self._embed_inputs(params, batch)
        positions = torch.arange(h.shape[1], device=h.device)
        aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        for lp in unstack(params["blocks"]):
            if cfg.remat:
                h, aux = checkpoint(self._block_train, lp, h, positions,
                                    use_reentrant=False)
            else:
                h, aux = self._block_train(lp, h, positions)
            aux_sum = aux_sum + aux
        h = L.rms_norm(h, params["ln_f"])
        logits = masked_lm_head(h, params["lm_head"], cfg.vocab)
        return logits, {"moe_aux": aux_sum / cfg.n_layers}

    def _decode_ffn(self, lp, x):
        """Each lane's dropless top-k mixture (module docstring)."""
        cfg = self.cfg
        return self._ffn(lp, x, capacity_factor=cfg.n_experts / cfg.top_k)[0]
