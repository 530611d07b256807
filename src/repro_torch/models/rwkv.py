"""RWKV6 ("Finch"): attention-free LM with data-dependent per-channel decay
(the counterpart of ``repro.models.rwkv``).

Time-mix runs the chunked WKV recurrence: intra-chunk pairwise decay
products in the rebased log-space factorization plus an inter-chunk
``(P, P)`` state. The per-step log-decay is bounded at ``-DECAY_CLAMP`` as
part of the model definition, which keeps the factorization inside f32. On
the CPU the recurrence is :func:`wkv6_chunked`, the reference's formulation
in plain torch; on a CUDA tensor it goes through the hand-written WKV6
kernels (``repro_torch.kernels.rwkv6_wkv.wkv6``), forward and backward, and
never through the plain form.

Layers are stacked along a leading "layers" dim as in the reference; the
forward unbinds each stacked leaf once and runs the layers in a loop, and
``cfg.remat`` recomputes each layer in backward through
``torch.utils.checkpoint``. Decode (:func:`wkv6_decode_step` and the
``decode=True`` branches) is one token a lane through the recurrence in
plain torch on every device, as the reference's is in XLA: an f32 WKV
state and two bf16 token-shift states a layer.

On DTensors (the GSPMD path) the residual stream takes the reference's
hints (``constrain`` at the embedding, each block's output and the
logits), and the one after the time-mix too, as ``DenseLM``'s after
attention. Each mix first makes the sequence whole on every device (the
token shift needs the previous row): a split of "seq" moves off it, an
all-gather, not a halo. r, k, v and the decays are cut into heads shard by
shard (:func:`_heads`), and the WKV runs shard by shard over batch and
heads (:func:`_wkv_sharded`) through B8's operators on every device: the
kernels on the card, their plain versions on the CPU, their shapes alone on
the dry run's fake tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import (
    attention_placements,
    constrain,
    is_dtensor,
    on_shards,
    whole_seq,
)
from repro_torch.kernels.rwkv6_wkv import WKV_CHUNK, wkv6
from repro_torch.models import layers as L
from repro_torch.models.model import LOGITS, BaseModel, keep_state, masked_lm_head
from repro_torch.models.module import ParamSpec
from repro_torch.models.transformer import ACT, unstack

DECAY_CLAMP = 2.5   # per-step |log w| bound
LORA_RANK = 64


def wkv6_chunked(r, k, v, logw, u, initial_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``y_t = r_t . (S_t + diag(u) k_t v_t^T)``, ``S_{t+1} = diag(w_t) S_t
    + k_t v_t^T``. r/k/v/logw ``(B, S, H, P)``, u ``(H, P)``, the state
    ``(B, H, P, P)`` f32; returns f32 y and the final state."""
    b, s, h, p = r.shape
    lc = min(WKV_CHUNK, s)
    if s % lc:
        pad = lc - s % lc
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, logw))
    sp = r.shape[1]
    nc = sp // lc
    rf, kf, vf, lw = (a.float().reshape(b, nc, lc, h, p) for a in (r, k, v, logw))
    cum = torch.cumsum(lw, dim=2)                 # (B,nc,L,H,P), <= 0
    cumprev = cum - lw                            # cum_{t-1}
    r_dec = rf * torch.exp(cumprev)               # exp(<=0), safe
    k_boost = kf * torch.exp(-cum)                # bounded by e^{L*clamp}
    a = torch.einsum("bclhp,bcmhp->bchlm", r_dec, k_boost)   # (B,nc,H,L,L)
    mask = torch.tril(torch.ones(lc, lc, dtype=torch.bool, device=r.device),
                      diagonal=-1)                # strictly j < t
    a = torch.where(mask, a, 0.0)
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", a, vf)
    bonus = torch.einsum("bclhp,hp,bclhp->bclh", rf, u.float(), kf)
    y_intra = y_intra + bonus[..., None] * vf

    # inter-chunk state recurrence
    k_tail = kf * torch.exp(cum[:, :, -1:] - cum)            # exp(<=0)
    s_chunk = torch.einsum("bclhp,bclhq->bchpq", k_tail, vf)  # (B,nc,H,P,P)
    chunk_decay = torch.exp(cum[:, :, -1])                   # (B,nc,H,P)
    state = (torch.zeros((b, h, p, p), dtype=torch.float32, device=r.device)
             if initial_state is None else initial_state.float())
    states_prev = []
    for c in range(nc):
        states_prev.append(state)
        state = state * chunk_decay[:, c, ..., None] + s_chunk[:, c]
    states_prev = torch.stack(states_prev, dim=1)            # (B,nc,H,P,P)
    y_inter = torch.einsum("bclhp,bchpq->bclhq", r_dec, states_prev)
    y = (y_intra + y_inter).reshape(b, sp, h, p)[:, :s]
    return y, state


def wkv6_decode_step(r, k, v, logw, u, state):
    """One token. r/k/v/logw ``(B, 1, H, P)``, the state ``(B, H, P, P)``
    f32; returns f32 y ``(B, 1, H, P)`` and the new state. A DTensor state
    runs shard by shard, each device its lanes and heads."""
    if is_dtensor(state):
        sp = [p if p.is_shard(0) or p.is_shard(1) else Replicate()
              for p in state.placements]
        rp = [Shard(2) if p.is_shard(1) else p for p in sp]
        up = [Shard(0) if p.is_shard(1) else Replicate() for p in sp]
        return on_shards(wkv6_decode_step, state.device_mesh, (rp, sp),
                         (rp,) * 4 + (up, sp))(r, k, v, logw, u, state)
    rf, kf, vf, lw = (a.float()[:, 0] for a in (r, k, v, logw))
    kv = torch.einsum("bhp,bhq->bhpq", kf, vf)
    y = torch.einsum("bhp,bhpq->bhq", rf, state + u.float()[..., None] * kv)
    state = state * torch.exp(lw)[..., None] + kv
    return y[:, None], state


def _shift(x: torch.Tensor) -> torch.Tensor:
    """The token shift: x one step later along the sequence, zeros first;
    on a DTensor, shard by shard, its sequence whole (:func:`whole_seq`)."""
    if is_dtensor(x):
        xp = [Replicate() if p.is_shard(1) else p for p in x.placements]
        return on_shards(_shift, x.device_mesh, xp, (xp,))(x)
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _head_ways(t: torch.Tensor, heads: int) -> list:
    """``t``'s placements with its split of dim 2 (``heads`` heads of whole
    rows) kept where the heads divide over its ways and gathered where they
    do not; batch splits kept, every other dim gathered."""
    ways = 1
    for i, p in enumerate(t.placements):
        if p.is_shard(2):
            ways *= t.device_mesh.size(i)
    return [p if p.is_shard(0) or (p.is_shard(2) and heads % ways == 0)
            else Replicate() for p in t.placements]


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """``(B, S, D)`` cut into ``(B, S, heads, D / heads)``; on a DTensor,
    shard by shard, a split of D becoming a split of the heads."""
    b, s, d = t.shape
    if not is_dtensor(t):
        return t.reshape(b, s, heads, d // heads)
    tp = _head_ways(t, heads)
    return on_shards(lambda a: a.reshape(a.shape[0], a.shape[1], -1, d // heads),
                     t.device_mesh, tp, (tp,))(t)


def _unheads(y: torch.Tensor) -> torch.Tensor:
    """``(B, S, H, P)`` back to ``(B, S, H P)``; on a DTensor, shard by
    shard, a split of the heads becoming a split of the features."""
    b, s, h, p = y.shape
    if not is_dtensor(y):
        return y.reshape(b, s, h * p)
    yp = _head_ways(y, h)
    return on_shards(lambda a: a.reshape(a.shape[0], a.shape[1], -1),
                     y.device_mesh, yp, (yp,))(y)


def _wkv_sharded(r, k, v, logw, u):
    """:func:`wkv6` of DTensors, shard by shard: each device runs B8's
    operators on its batch rows and heads (``layers.attention_placements``'s
    layout: a sequence split moves to the heads, heads that do not divide
    are gathered), with the bonus u split as the heads; u's gradient is a
    partial sum over the batch's mesh dims."""
    rp, _ = attention_placements(r, r.shape[2])
    up = [Shard(0) if p.is_shard(2) else Replicate() for p in rp]
    ug = [Partial() if p.is_shard(0) else q for p, q in zip(rp, up)]
    return on_shards(wkv6, r.device_mesh, rp, (rp,) * 4 + (up,),
                     (rp,) * 4 + (ug,))(r, k, v, logw, u)


class Rwkv6LM(BaseModel):
    def param_specs(self):
        cfg = self.cfg
        nl, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
        p = cfg.rwkv_head_dim
        h = d // p
        lead = (nl,)
        ax = ("layers",)
        tm = {
            "ln": ParamSpec(lead + (d,), ax + ("embed",), init="ones"),
            "mu_r": ParamSpec(lead + (d,), ax + ("embed",), init="zeros"),
            "mu_k": ParamSpec(lead + (d,), ax + ("embed",), init="zeros"),
            "mu_v": ParamSpec(lead + (d,), ax + ("embed",), init="zeros"),
            "mu_g": ParamSpec(lead + (d,), ax + ("embed",), init="zeros"),
            "mu_w": ParamSpec(lead + (d,), ax + ("embed",), init="zeros"),
            "w_r": ParamSpec(lead + (d, d), ax + ("embed", "ssm_heads")),
            "w_k": ParamSpec(lead + (d, d), ax + ("embed", "ssm_heads")),
            "w_v": ParamSpec(lead + (d, d), ax + ("embed", "ssm_heads")),
            "w_g": ParamSpec(lead + (d, d), ax + ("embed", "ssm_heads")),
            "w_o": ParamSpec(lead + (d, d), ax + ("ssm_heads", "embed")),
            "decay_base": ParamSpec(lead + (d,), ax + ("ssm_heads",), init="zeros"),
            "decay_lora_a": ParamSpec(lead + (d, LORA_RANK), ax + ("embed", None)),
            "decay_lora_b": ParamSpec(lead + (LORA_RANK, d), ax + (None, "ssm_heads"),
                                      scale=0.01),
            "bonus_u": ParamSpec(lead + (h, p), ax + ("ssm_heads", None),
                                 init="zeros"),
            "gn": ParamSpec(lead + (d,), ax + ("ssm_heads",), init="ones"),
        }
        cm = {
            "ln": ParamSpec(lead + (d,), ax + ("embed",), init="ones"),
            "mu_k": ParamSpec(lead + (d,), ax + ("embed",), init="zeros"),
            "mu_r": ParamSpec(lead + (d,), ax + ("embed",), init="zeros"),
            "w_k": ParamSpec(lead + (d, f), ax + ("embed", "mlp")),
            "w_v": ParamSpec(lead + (f, d), ax + ("mlp", "embed")),
            "w_r": ParamSpec(lead + (d, d), ax + ("embed", None)),
        }
        return {
            "embed": ParamSpec((cfg.padded_vocab, d), ("vocab", "embed"),
                               init="embed", scale=0.02),
            "time_mix": tm,
            "chan_mix": cm,
            "ln_f": ParamSpec((d,), ("embed",), init="ones"),
            "lm_head": ParamSpec((d, cfg.padded_vocab), ("embed", "vocab")),
        }

    # -- block pieces ---------------------------------------------------------
    def _decay(self, lp, xw):
        raw = lp["decay_base"] + L.project(
            torch.tanh(L.project(xw, lp["decay_lora_a"])), lp["decay_lora_b"])
        return -torch.clamp(torch.exp(raw.float()), max=DECAY_CLAMP)

    def _time_mix(self, lp, h, *, shift_state=None, wkv_state=None,
                  decode: bool = False):
        """Returns (h_out, the shift state out, the WKV state out). In
        decode the previous token's normed input is ``shift_state``; on
        the card the training form goes through the kernels, which give no
        final state (None)."""
        nh = h.shape[-1] // self.cfg.rwkv_head_dim
        x = whole_seq(L.rms_norm(h, lp["ln"]))
        x_prev = shift_state[:, None, :].to(x.dtype) if decode else _shift(x)
        new_shift = x[:, -1, :]

        def mix(mu):
            return x + (x_prev - x) * mu

        r = _heads(L.project(mix(lp["mu_r"]), lp["w_r"]), nh)
        k = _heads(L.project(mix(lp["mu_k"]), lp["w_k"]), nh)
        v = _heads(L.project(mix(lp["mu_v"]), lp["w_v"]), nh)
        g = L.project(mix(lp["mu_g"]), lp["w_g"])
        logw = _heads(self._decay(lp, mix(lp["mu_w"])), nh)
        if decode:
            y, new_state = wkv6_decode_step(r, k, v, logw, lp["bonus_u"],
                                            wkv_state)
        elif is_dtensor(h):
            y, new_state = _wkv_sharded(r, k, v, logw, lp["bonus_u"]), None
        elif h.device.type == "cpu":
            y, new_state = wkv6_chunked(r, k, v, logw, lp["bonus_u"])
        else:
            y, new_state = wkv6(r, k, v, logw, lp["bonus_u"]), None
        y = _unheads(y).to(h.dtype)
        y = L.rms_norm(y, lp["gn"]) * F.silu(g)
        return h + L.project(y, lp["w_o"]), new_shift, new_state

    def _chan_mix(self, lp, h, *, shift_state=None, decode: bool = False):
        """Returns (h_out, the shift state out)."""
        x = whole_seq(L.rms_norm(h, lp["ln"]))
        x_prev = shift_state[:, None, :].to(x.dtype) if decode else _shift(x)
        xk = x + (x_prev - x) * lp["mu_k"]
        xr = x + (x_prev - x) * lp["mu_r"]
        kk = torch.square(torch.relu(L.project(xk, lp["w_k"])))
        out = torch.sigmoid(L.project(xr, lp["w_r"])) * L.project(kk, lp["w_v"])
        return h + out, x[:, -1, :]

    def _block(self, tm, cm, h):
        h = constrain(self._time_mix(tm, h)[0], ACT)
        return constrain(self._chan_mix(cm, h)[0], ACT)

    def forward(self, params, batch):
        cfg = self.cfg
        h = constrain(L.embed(params["embed"], batch["tokens"]), ACT)
        for tm, cm in zip(unstack(params["time_mix"]),
                          unstack(params["chan_mix"])):
            if cfg.remat:
                h = checkpoint(self._block, tm, cm, h, use_reentrant=False)
            else:
                h = self._block(tm, cm, h)
        h = L.rms_norm(h, params["ln_f"])
        logits = masked_lm_head(h, params["lm_head"], cfg.vocab)
        return constrain(logits, LOGITS), {}

    def cache_specs(self, batch_size: int, max_seq: int,
                    dtype=torch.bfloat16):
        cfg = self.cfg
        d = cfg.d_model
        p = cfg.rwkv_head_dim
        nh = d // p
        nl = cfg.n_layers
        return {
            "wkv": ParamSpec((nl, batch_size, nh, p, p),
                             ("layers", "batch", "ssm_heads", None, None),
                             dtype=torch.float32, init="zeros"),
            "shift_tm": ParamSpec((nl, batch_size, d),
                                  ("layers", "batch", None),
                                  dtype=dtype, init="zeros"),
            "shift_cm": ParamSpec((nl, batch_size, d),
                                  ("layers", "batch", None),
                                  dtype=dtype, init="zeros"),
        }

    def decode_step(self, params, cache, tokens, cur_index, active=None):
        """One token a lane through every layer's time-mix and channel-mix
        from their states; the shift states come back bf16, as the
        reference casts them."""
        cfg = self.cfg
        h = L.embed(params["embed"], tokens)
        new_wkv, new_tm, new_cm = [], [], []
        for li, (tm, cm) in enumerate(zip(unstack(params["time_mix"]),
                                          unstack(params["chan_mix"]))):
            # each mix's input held to the residual's layout, as in
            # training: on DTensors its partial sums reduced before the
            # shift states are cast to bf16
            h, sh_tm, wkv_s = self._time_mix(
                tm, constrain(h, ACT), shift_state=cache["shift_tm"][li],
                wkv_state=cache["wkv"][li], decode=True)
            h, sh_cm = self._chan_mix(cm, constrain(h, ACT),
                                      shift_state=cache["shift_cm"][li],
                                      decode=True)
            new_wkv.append(wkv_s)
            new_tm.append(sh_tm)
            new_cm.append(sh_cm)
        h = L.rms_norm(h, params["ln_f"])
        logits = masked_lm_head(h, params["lm_head"], cfg.vocab)
        stacked = {"wkv": torch.stack(new_wkv),
                   "shift_tm": torch.stack(new_tm).to(torch.bfloat16),
                   "shift_cm": torch.stack(new_cm).to(torch.bfloat16)}
        return logits, {k: keep_state(v, cache[k], active)
                        for k, v in stacked.items()}
