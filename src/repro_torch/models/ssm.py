"""Mamba2 (SSD) blocks and the Zamba2 hybrid, a Mamba2 backbone with one
*shared* attention block applied every ``attn_every`` layers (the
counterpart of ``repro.models.ssm``).

The SSD runs the chunked algorithm (Dao & Gu, 2024): a dense intra-chunk
term with per-head scalar decay plus an inter-chunk ``(N, P)`` state, every
decay an exponent of ``g_t - g_j <= 0``. On the CPU it is
:func:`ssd_chunked`, the reference's formulation in plain torch at the
config's chunk; on a CUDA tensor it goes through the hand-written SSD
kernels (``repro_torch.kernels.ssd_scan.ssd_scan``), forward and backward,
and never through the plain form. The shared block's attention goes
through ``layers.attention``, the flash attention kernels on the card.

Mamba layers are stacked along a leading "layers" dim as in the reference;
the forward unbinds each stacked leaf once and runs the layers in a loop,
and ``cfg.remat`` recomputes each Mamba layer in backward through
``torch.utils.checkpoint``. As in the reference, the shared attention
block is not rematerialized.

Decode (:func:`ssd_decode_step`, ``mamba2_block(decode=True)``, the
families' ``decode_step``) is one token a lane through the recurrence in
plain torch on every device, as the reference's is in XLA: an f32 SSM state
and the conv window a layer, and, in Zamba2, one KV slot per application of
the shared attention block.

On DTensors (the GSPMD path) the residual stream takes the reference's
hints (``constrain`` at the embedding, each Mamba layer's output and the
logits), and the shared block's after its attention and at its output, as
``DenseLM``'s do; the shared block projects and merges heads shard by
shard and attends through :func:`layers.attention`'s layout. A Mamba2
layer runs shard by shard over its batch rows and its SSM heads
(:func:`_mamba2_sharded`): each device takes its heads' columns of
``in_proj`` (z, x and dt) and B's and C's, which every head shares, from
the gathered weight, and the same channels of the conv, so that a split of
``in_proj`` or of the conv's ``din + 2n`` channels that falls inside a part
never matters; the sequence is made whole first (the conv reads the
``CONV_K - 1`` rows before each): a split of "seq" moves off it, an
all-gather, not a halo. The SSD goes through B9's operators on every
device: the kernels on the card, their plain versions on the CPU, their
shapes alone on the dry run's fake tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import (
    constrain,
    is_dtensor,
    on_shards,
    shard_of,
    whole_seq,
)
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import layers as L
from repro_torch.models.model import (
    LOGITS,
    BaseModel,
    decode_positions,
    keep_state,
    kv_slots,
    masked_lm_head,
    write_kv,
)
from repro_torch.models.module import ParamSpec
from repro_torch.models.transformer import ACT, _attn_specs, _mlp_specs, unstack

CONV_K = 4  # mamba2 depthwise conv kernel width


# ---------------------------------------------------------------------------
# SSD core (chunked)
# ---------------------------------------------------------------------------

def ssd_chunked(x, dt, A, Bm, Cm, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``(B, S, H, P)``, dt ``(B, S, H)`` (softplus'd), A ``(H,)``
    (negative), Bm and Cm ``(B, S, N)``, the state ``(B, H, N, P)``.
    Returns f32 y ``(B, S, H, P)`` and the final state. The pairwise decay
    masks its exponent before ``exp`` (the reference masks after it), so
    no ``inf`` reaches autograd's ``0 * inf`` when ``g`` spans more than
    88 over a chunk."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    lc = min(chunk, s)
    if s % lc:
        pad = lc - s % lc
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (dt, Bm, Cm))
    sp = x.shape[1]
    nc = sp // lc

    xf = (x * dt[..., None]).float().reshape(b, nc, lc, h, p)
    a = (dt.float() * A.float()).reshape(b, nc, lc, h)
    Bc = Bm.float().reshape(b, nc, lc, n)
    Cc = Cm.float().reshape(b, nc, lc, n)

    g = torch.cumsum(a, dim=2)                          # (B,nc,L,H)
    # intra-chunk: y[t] += sum_{j<=t} exp(g_t - g_j) (C_t.B_j) x_j
    mask = torch.tril(torch.ones(lc, lc, dtype=torch.bool, device=x.device))
    mask = mask[None, None, :, :, None]
    diff = g[:, :, :, None, :] - g[:, :, None, :, :]    # (B,nc,L,L,H), t index 2
    decay = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    cb = torch.einsum("bcln,bcmn->bclm", Cc, Bc)        # (B,nc,L,L)
    y_intra = torch.einsum("bclm,bclmh,bcmhp->bclhp", cb, decay, xf)

    # chunk summaries: S_c = sum_j exp(g_last - g_j) B_j (x) x_j
    wlast = torch.exp(g[:, :, -1:, :] - g)              # (B,nc,L,H)
    s_chunk = torch.einsum("bcln,bclh,bclhp->bchnp", Bc, wlast, xf)
    chunk_decay = torch.exp(g[:, :, -1, :])             # (B,nc,H)

    # inter-chunk recurrence
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    states_prev = []
    for c in range(nc):
        states_prev.append(state)                       # state entering chunk c
        state = state * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    states_prev = torch.stack(states_prev, dim=1)       # (B,nc,H,N,P)

    y_inter = torch.einsum("bcln,bclh,bchnp->bclhp", Cc, torch.exp(g), states_prev)
    y = (y_intra + y_inter).reshape(b, sp, h, p)[:, :s]
    return y, state


def ssd_decode_step(x, dt, A, Bm, Cm, state):
    """One token of the SSD recurrence. x ``(B, 1, H, P)``, dt ``(B, 1,
    H)``, A ``(H,)``, Bm and Cm ``(B, 1, N)``, the state ``(B, H, N, P)``
    f32; returns f32 y ``(B, 1, H, P)`` and the new state."""
    xf = (x * dt[..., None]).float()[:, 0]                 # (B,H,P)
    dec = torch.exp(dt.float()[:, 0] * A)                  # (B,H)
    state = state * dec[..., None, None] + torch.einsum(
        "bn,bhp->bhnp", Bm.float()[:, 0], xf)
    y = torch.einsum("bn,bhnp->bhp", Cm.float()[:, 0], state)
    return y[:, None], state


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def mamba2_specs(cfg: ArchConfig, nl: int) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    din = cfg.d_inner
    n = cfg.ssm_state
    h = cfg.n_ssm_heads
    conv_dim = din + 2 * n
    d_in_proj = 2 * din + 2 * n + h
    lead = (nl,)
    ax = ("layers",)
    return {
        "ln": ParamSpec(lead + (d,), ax + ("embed",), init="ones"),
        "in_proj": ParamSpec(lead + (d, d_in_proj), ax + ("embed", "ssm_heads")),
        "conv_w": ParamSpec(lead + (CONV_K, conv_dim), ax + (None, "ssm_heads"),
                            scale=0.5),
        "conv_b": ParamSpec(lead + (conv_dim,), ax + ("ssm_heads",), init="zeros"),
        "dt_bias": ParamSpec(lead + (h,), ax + ("ssm_heads",), init="zeros"),
        "A_log": ParamSpec(lead + (h,), ax + ("ssm_heads",), init="ones"),
        "D": ParamSpec(lead + (h,), ax + ("ssm_heads",), init="ones"),
        "gate_ln": ParamSpec(lead + (din,), ax + ("ssm_heads",), init="ones"),
        "out_proj": ParamSpec(lead + (din, d), ax + ("ssm_heads", "embed")),
    }


def _split_in_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    din, n, h = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    z, xbc, dt = torch.split(zxbcdt, [din, din + 2 * n, h], dim=-1)
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d, kernel CONV_K. xbc: (B,S,C), w: (K,C).

    Returns (out (B,S,C), new_state (B,K-1,C)) — state carries the last K-1
    inputs for decode.
    """
    k = w.shape[0]
    if state is None:
        ctx = F.pad(xbc, (0, 0, k - 1, 0))
    else:
        ctx = torch.cat([state.to(xbc.dtype), xbc], dim=1)
    out = sum(ctx[:, i:i + xbc.shape[1]] * w[i] for i in range(k)) + b
    new_state = ctx[:, -(k - 1):] if k > 1 else None
    return F.silu(out), new_state


def mamba2_block(cfg: ArchConfig, lp, h_in: torch.Tensor, *,
                 ssm_state: Optional[torch.Tensor] = None,
                 conv_state: Optional[torch.Tensor] = None,
                 decode: bool = False):
    """Returns (h_out, new_ssm_state, new_conv_state). ``decode``: one token
    through :func:`ssd_decode_step` from ``ssm_state``. Otherwise, on the
    card, the SSD goes through the kernels, which start from a zero state
    and give no final state (None); nothing passes them a state (serving
    prefills through ``decode_step``, as the reference does). DTensors take
    :func:`_mamba2_sharded`."""
    if is_dtensor(h_in):
        return _mamba2_sharded(cfg, lp, h_in, ssm_state=ssm_state,
                               conv_state=conv_state, decode=decode)
    din, n, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    p = cfg.ssm_head_dim
    x = L.rms_norm(h_in, lp["ln"])
    zxbcdt = x @ lp["in_proj"]
    z, xbc, dt = _split_in_proj(cfg, zxbcdt)
    xbc, new_conv = _causal_conv(xbc, lp["conv_w"], lp["conv_b"],
                                 state=conv_state)
    xs, Bm, Cm = torch.split(xbc, [din, n, n], dim=-1)
    dt = F.softplus(dt.float() + lp["dt_bias"].float())
    A = -torch.exp(lp["A_log"].float())
    b, s, _ = xs.shape
    xh = xs.reshape(b, s, nh, p)
    if decode:
        y, new_state = ssd_decode_step(xh, dt, A, Bm, Cm, ssm_state)
    elif xh.device.type == "cpu":
        y, new_state = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk,
                                   initial_state=ssm_state)
    elif ssm_state is not None:
        raise NotImplementedError(
            "the SSD from an initial state has no kernel on the card; "
            "serving prefills through decode_step and never passes one")
    else:
        y, new_state = ssd_scan(xh, dt, A, Bm, Cm), None
    y = y.float() + lp["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(b, s, din).to(h_in.dtype)
    y = L.rms_norm(y * F.silu(z), lp["gate_ln"])
    return h_in + y @ lp["out_proj"], new_state, new_conv


def _mamba2_sharded(cfg: ArchConfig, lp, h_in, *, ssm_state=None,
                    conv_state=None, decode: bool = False):
    """:func:`mamba2_block` of DTensors (module docstring). Every device
    runs its batch rows and its heads: the mesh dims that split
    ``in_proj``'s output split the heads where they divide over them. In
    training and prefill a device projects and convolves its heads' x
    channels and B and C; in decode it convolves every channel, since the
    conv state it returns is the whole of it, and steps its heads' SSD
    state. ``in_proj`` and the conv's weights are gathered (their gradients
    partial sums), the per-head parameters taken as the heads are split.
    The gate's norm and ``out_proj`` run on DTensors. On a one-rank mesh
    every step is the plain route's."""
    din, n, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    p = cfg.ssm_head_dim
    x = whole_seq(L.rms_norm(h_in, lp["ln"]))
    mesh = x.device_mesh
    rows = [Shard(0) if q.is_shard(0) else Replicate() for q in x.placements]
    split = [q.is_shard(1) and not r.is_shard() for q, r in
             zip(lp["in_proj"].placements, rows)]
    ways = 1
    for i, sp in enumerate(split):
        ways *= mesh.size(i) if sp else 1
    if nh % ways:
        split = [False] * mesh.ndim
    whole = [Replicate()] * mesh.ndim
    heads = [Shard(0) if sp else Replicate() for sp in split]
    summed = [Partial() if r.is_shard() or sp else Replicate()
              for r, sp in zip(rows, split)]
    heads_g = [Partial() if r.is_shard() else q for r, q in zip(rows, heads)]
    act_g = [r if r.is_shard() else Partial() if sp else r
             for r, sp in zip(rows, split)]
    (hl,), (lo,) = shard_of(mesh, heads, (nh,))

    def block(x, w, cw, cb, dt_bias, a_log, d_skip, *state):
        if hl == nh:
            z, xbc, dt = _split_in_proj(cfg, x @ w)
        else:
            z_cols = slice(lo * p, (lo + hl) * p)
            x_cols = slice(din + lo * p, din + (lo + hl) * p)
            bc_cols = slice(2 * din, 2 * din + 2 * n)
            dt_cols = slice(2 * din + 2 * n + lo, 2 * din + 2 * n + lo + hl)
            # decode convolves every channel: its conv state is all of them
            xbc_cols = [slice(din, 2 * din + 2 * n)] if decode else [x_cols, bc_cols]
            cols = [z_cols] + xbc_cols + [dt_cols]
            z, xbc, dt = torch.split(
                x @ torch.cat([w[:, c] for c in cols], dim=1),
                [hl * p, sum(c.stop - c.start for c in xbc_cols), hl], dim=-1)
            cw = torch.cat([cw[:, c.start - din:c.stop - din] for c in xbc_cols], 1)
            cb = torch.cat([cb[c.start - din:c.stop - din] for c in xbc_cols])
        xbc, new_conv = _causal_conv(xbc, cw, cb,
                                     state=state[1] if decode else None)
        if decode and hl != nh:
            xs, Bm, Cm = torch.split(xbc, [din, n, n], dim=-1)
            xs = xs[..., lo * p:(lo + hl) * p]
        else:
            xs, Bm, Cm = torch.split(xbc, [hl * p, n, n], dim=-1)
        dt = F.softplus(dt.float() + dt_bias.float())
        A = -torch.exp(a_log.float())
        b, s, _ = xs.shape
        xh = xs.reshape(b, s, hl, p)
        if decode:
            y, new_state = ssd_decode_step(xh, dt, A, Bm, Cm, state[0])
        else:
            y = ssd_scan(xh, dt, A, Bm, Cm)
        y = y.float() + d_skip.float()[None, None, :, None] * xh.float()
        y = y.reshape(b, s, hl * p).to(h_in.dtype) * F.silu(z)
        return (y, new_state, new_conv) if decode else y

    out = [Shard(2) if sp else r for r, sp in zip(rows, split)]
    ins = [rows, whole, whole, whole, heads, heads, heads]
    args = [x, lp["in_proj"], lp["conv_w"], lp["conv_b"], lp["dt_bias"],
            lp["A_log"], lp["D"]]
    if decode:
        state_p = [Shard(1) if sp else r for r, sp in zip(rows, split)]
        y, new_state, new_conv = on_shards(
            block, mesh, (out, state_p, rows), ins + [state_p, rows])(
            *args, ssm_state, conv_state)
    else:
        if ssm_state is not None:
            raise NotImplementedError(
                "the SSD from an initial state has no kernel; serving "
                "prefills through decode_step and never passes one")
        new_state = new_conv = None
        y = on_shards(block, mesh, out, ins,
                      [act_g, summed, summed, summed, heads_g, heads_g, heads_g])(
            *args)
    y = L.rms_norm(y, lp["gate_ln"])
    return h_in + L.project(y, lp["out_proj"]), new_state, new_conv


def _mamba_layer(cfg: ArchConfig, lp, h):
    return constrain(mamba2_block(cfg, lp, h)[0], ACT)


def _mamba_layers(cfg: ArchConfig, layers, h):
    """The Mamba layers in turn, each recomputed in backward under
    ``cfg.remat``."""
    for lp in layers:
        if cfg.remat:
            h = checkpoint(_mamba_layer, cfg, lp, h, use_reentrant=False)
        else:
            h = _mamba_layer(cfg, lp, h)
    return h


# ---------------------------------------------------------------------------
# Pure Mamba2 LM (used for testing + as a family baseline)
# ---------------------------------------------------------------------------

class Mamba2LM(BaseModel):
    def param_specs(self):
        cfg = self.cfg
        return {
            "embed": ParamSpec((cfg.padded_vocab, cfg.d_model),
                               ("vocab", "embed"), init="embed", scale=0.02),
            "mamba": mamba2_specs(cfg, cfg.n_layers),
            "ln_f": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
            "lm_head": ParamSpec((cfg.d_model, cfg.padded_vocab), ("embed", "vocab")),
        }

    def forward(self, params, batch):
        cfg = self.cfg
        h = constrain(L.embed(params["embed"], batch["tokens"]), ACT)
        h = _mamba_layers(cfg, unstack(params["mamba"]), h)
        h = L.rms_norm(h, params["ln_f"])
        logits = masked_lm_head(h, params["lm_head"], cfg.vocab)
        return constrain(logits, LOGITS), {}

    def cache_specs(self, batch_size: int, max_seq: int,
                    dtype=torch.bfloat16):
        return _mamba_cache_specs(self.cfg, batch_size, dtype)

    def decode_step(self, params, cache, tokens, cur_index, active=None):
        cfg = self.cfg
        h = L.embed(params["embed"], tokens)
        new_ssm, new_conv = [], []
        for li, lp in enumerate(unstack(params["mamba"])):
            h, s2, c2 = mamba2_block(cfg, lp, h, ssm_state=cache["ssm"][li],
                                     conv_state=cache["conv"][li], decode=True)
            new_ssm.append(s2)
            new_conv.append(c2)
        h = L.rms_norm(h, params["ln_f"])
        logits = masked_lm_head(h, params["lm_head"], cfg.vocab)
        return logits, {
            "ssm": keep_state(torch.stack(new_ssm), cache["ssm"], active),
            "conv": keep_state(torch.stack(new_conv), cache["conv"], active)}


def _mamba_cache_specs(cfg: ArchConfig, batch_size: int, dtype):
    n, p, nh = cfg.ssm_state, cfg.ssm_head_dim, cfg.n_ssm_heads
    conv_dim = cfg.d_inner + 2 * n
    return {
        "ssm": ParamSpec((cfg.n_layers, batch_size, nh, n, p),
                         ("layers", "batch", "ssm_heads", None, None),
                         dtype=torch.float32, init="zeros"),
        "conv": ParamSpec((cfg.n_layers, batch_size, CONV_K - 1, conv_dim),
                          ("layers", "batch", None, "ssm_heads"),
                          dtype=dtype, init="zeros"),
    }


# ---------------------------------------------------------------------------
# Zamba2: mamba2 backbone + one shared attention block every attn_every layers
# ---------------------------------------------------------------------------

class Zamba2LM(BaseModel):
    """38 mamba2 layers; a single *weight-shared* full-attention block (MHA +
    SwiGLU) applied after every ``attn_every``-th mamba layer (Zamba2's
    shared-block design; per-use LoRA adapters omitted — noted in config)."""

    def _layout(self):
        cfg = self.cfg
        g = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
        rem = cfg.n_layers - g * cfg.attn_every
        return g, rem

    def param_specs(self):
        cfg = self.cfg
        shared = {
            "ln1": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
            "ln2": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
            **_attn_specs(cfg, 0, prefix_axes=()),
            **_mlp_specs(cfg, 0, prefix_axes=()),
        }
        return {
            "embed": ParamSpec((cfg.padded_vocab, cfg.d_model),
                               ("vocab", "embed"), init="embed", scale=0.02),
            "mamba": mamba2_specs(cfg, cfg.n_layers),
            "shared_attn": shared,
            "ln_f": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
            "lm_head": ParamSpec((cfg.d_model, cfg.padded_vocab), ("embed", "vocab")),
        }

    def _shared_attn_train(self, sp, h, positions):
        cfg = self.cfg
        x = L.rms_norm(h, sp["ln1"])
        q, k, v = (L.project_heads(x, sp[w]) for w in ("wq", "wk", "wv"))
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        q = constrain(q, ("batch", "seq", "act_heads", None))
        o = L.attention(q, k, v, causal=True)
        h = constrain(h + L.merge_heads(o, sp["wo"]), ACT)
        x = L.rms_norm(h, sp["ln2"])
        return constrain(h + L.swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"]),
                         ACT)

    def _mamba_span(self, layers, h, lo, hi):
        return _mamba_layers(self.cfg, layers[lo:hi], h)

    def forward(self, params, batch):
        cfg = self.cfg
        g, rem = self._layout()
        h = constrain(L.embed(params["embed"], batch["tokens"]), ACT)
        positions = torch.arange(h.shape[1], device=h.device)
        layers = unstack(params["mamba"])
        for gi in range(g):
            h = self._mamba_span(layers, h, gi * cfg.attn_every,
                                 (gi + 1) * cfg.attn_every)
            h = self._shared_attn_train(params["shared_attn"], h, positions)
        if rem:
            h = self._mamba_span(layers, h, g * cfg.attn_every, cfg.n_layers)
        h = L.rms_norm(h, params["ln_f"])
        logits = masked_lm_head(h, params["lm_head"], cfg.vocab)
        return constrain(logits, LOGITS), {}

    def cache_specs(self, batch_size: int, max_seq: int,
                    dtype=torch.bfloat16):
        cfg = self.cfg
        g, _ = self._layout()
        shape = (g, batch_size, max_seq, cfg.n_kv_heads, cfg.head_dim)
        axes = ("groups", "batch", "seq", "kv_heads", "head_dim")
        return {**_mamba_cache_specs(cfg, batch_size, dtype),
                "k": ParamSpec(shape, axes, dtype=dtype, init="zeros"),
                "v": ParamSpec(shape, axes, dtype=dtype, init="zeros")}

    def decode_step(self, params, cache, tokens, cur_index, active=None):
        """One token a lane: the Mamba2 layers from their states, and the
        shared attention block with this application's KV slot (written in
        place at the lane's position)."""
        cfg = self.cfg
        g, _ = self._layout()
        h = L.embed(params["embed"], tokens)
        cur = decode_positions(cur_index, h.shape[0], h.device)
        slots = kv_slots(cur, cache["k"].shape[2])
        cos, sin = L.rope_cos_sin(cur[:, None], cfg.head_dim, cfg.rope_theta)
        layers = unstack(params["mamba"])
        sp = params["shared_attn"]
        new_ssm, new_conv = [], []

        def mamba(h, li):
            h, s2, c2 = mamba2_block(cfg, layers[li], h,
                                     ssm_state=cache["ssm"][li],
                                     conv_state=cache["conv"][li], decode=True)
            new_ssm.append(s2)
            new_conv.append(c2)
            return h

        for gi in range(g):
            for li in range(gi * cfg.attn_every, (gi + 1) * cfg.attn_every):
                h = mamba(h, li)
            x = L.rms_norm(h, sp["ln1"])
            q, k, v = (L.project_heads(x, sp[w]) for w in ("wq", "wk", "wv"))
            q, k = L.rotate(q, cos, sin), L.rotate(k, cos, sin)
            k_cache, v_cache = cache["k"][gi], cache["v"][gi]
            write_kv(k_cache, slots, k, active)
            write_kv(v_cache, slots, v, active)
            o = L.decode_attention(q, k_cache, v_cache, cur)
            h = h + L.merge_heads(o, sp["wo"])
            x = L.rms_norm(h, sp["ln2"])
            h = h + L.swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"])
        for li in range(g * cfg.attn_every, cfg.n_layers):
            h = mamba(h, li)
        h = L.rms_norm(h, params["ln_f"])
        logits = masked_lm_head(h, params["lm_head"], cfg.vocab)
        return logits, {
            "ssm": keep_state(torch.stack(new_ssm), cache["ssm"], active),
            "conv": keep_state(torch.stack(new_conv), cache["conv"], active),
            "k": cache["k"], "v": cache["v"]}
