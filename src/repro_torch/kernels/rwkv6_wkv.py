"""RWKV6's chunked WKV recurrence, forward and backward (the counterpart of
``repro.kernels.rwkv6_wkv``).

For one head, with r, k, v, logw ``(S, P)`` and the bonus u ``(P,)``::

    y_t     = r_t . (S_t + diag(u) k_t v_t^T)
    S_{t+1} = diag(exp(logw_t)) S_t + k_t v_t^T,    S_0 given or 0

computed as ``wkv6_pallas`` computes it: per chunk of ``L = min(32, S)``
steps (``S`` zero-padded to whole chunks, which leaves ``cum`` flat over the
pad), ``cum = cumsum(logw)``, ``cumprev = cum - logw``, the intra-chunk
pairs ``(r exp(cumprev)) (k exp(-cum))^T`` strictly below the diagonal times
v, the bonus ``sum_p r u k`` times v, the carried state ``r exp(cumprev) S``,
and the state update ``S exp(cum_L) + (k exp(cum_L - cum))^T v``. Everything
is f32 inside; y comes out in r's dtype.

:func:`wkv6` is a ``torch.autograd.Function`` over two hand-written CUDA
entry points in ``csrc/wkv6.cu``, each a chunk-parallel scan whose products
run on the tensor cores in split TF32 (three TF32 products an f32 product,
as B4's and B9's kernels):

  * ``wkv6_fwd`` (W1) — y, the state at the start of every chunk,
    ``(B, H, chunks, P, P)`` f32, which the backward reads instead of
    forming them again (67 MB at the main shape), and the final state
    ``(B, H, P, P)`` f32, from an initial state (the reference's
    ``wkv6_chunked(initial_state=)``; none is zeros). Three kernels: every
    chunk's summary ``(k exp(cum_L - cum))^T v``; the short pass that
    carries the states across the chunks from the initial state, and one
    step past the last to the final state; every chunk's outputs;
  * ``wkv6_bwd`` (W2) — dr, dk, dv, dlogw and du, from the final state's
    gradient (none is zeros), and the initial state's gradient where it is
    asked for. Four kernels: every chunk's ``(r exp(cumprev))^T dy``; the
    pass that carries ``dS`` back across the chunks from the final state's
    gradient, and one step past the first to the initial state's; every
    chunk's local terms from its state and ``dS``,
    with du's partial of each chunk; and du's sum over the batch and the
    chunks in a fixed order: no atomics, the same bits every run.

The kernels refer each chunk's pair decays to its middle row ``m``:
``A = (r exp(cumprev - m)) (k exp(m - cum))^T``, every exponent within
``(L / 2) 2.5`` of 0, and the backward's pair sums are products of the same
factors (``csrc/wkv6.cu``). The plain backward below computes each
intra-chunk pair's decay ``exp(cumprev_t - cum_j)`` (at most 1) on its own
instead: referred to the chunk's first row, as the forward's factorization
is, its products ``dA K exp(-cum)`` would sum values up to ``|k| e^80``
before the small factor comes in. The wrappers allocate the kernels'
scratch (``exp(cum_L)`` of every chunk, W2's ``dS`` and du's partials) in
one ``torch.empty`` a call.

Each kernel has a plain PyTorch version beside it (``*_plain``), the same
formulas in torch ops: the backward written out, not autograd of the
forward. A tensor on the CPU takes the plain versions; a CUDA tensor
launches the kernels or raises; any other device raises. Every launch adds
one to its kernel's entry in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

WKV_CHUNK = 32
# what the CUDA kernels take
HEAD_DIMS = (32, 64)


def _work_dtype(x: torch.Tensor) -> torch.dtype:
    """f32, as in B8; f64 inputs stay f64 (``gradcheck`` of the plain path)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _dims(r, k, v, logw, u):
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"r, k, v, logw must be one (B, S, H, P) shape; got "
                         f"{[tuple(t.shape) for t in (r, k, v, logw)]}")
    b, s, h, p = r.shape
    if tuple(u.shape) != (h, p):
        raise ValueError(f"u must be (H, P) = {(h, p)}, got {tuple(u.shape)}")
    return b, s, h, p


def _chunks(x: torch.Tensor, lc: int, wt: torch.dtype) -> torch.Tensor:
    """``(B, S, H, P)`` zero-padded to whole chunks, as
    ``(B, H, chunks, L, P)`` in ``wt``."""
    b, s, h, p = x.shape
    x = F.pad(x.to(wt), (0, 0, 0, 0, 0, (-s) % lc))
    return x.reshape(b, -1, lc, h, p).permute(0, 3, 1, 2, 4)


def _unchunk(x: torch.Tensor, s: int, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`_chunks`: ``(B, S, H, P)`` in ``dtype``."""
    b, h, nc, lc, p = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(b, nc * lc, h, p)[:, :s].to(dtype)


def _strictly_lower(lc: int, device) -> torch.Tensor:
    return torch.tril(torch.ones(lc, lc, dtype=torch.bool, device=device),
                      diagonal=-1)


# ---------------------------------------------------------------------------
# plain PyTorch versions: the reference the kernels are held against
# ---------------------------------------------------------------------------

def _state(t: Optional[torch.Tensor], b: int, h: int, p: int,
           name: str) -> Optional[torch.Tensor]:
    """Check a carried state (or its gradient): ``(B, H, P, P)``, or None."""
    if t is not None and tuple(t.shape) != (b, h, p, p):
        raise ValueError(f"{name} must be (B, H, P, P) = {(b, h, p, p)}, got "
                         f"{tuple(t.shape)}")
    return t


def wkv6_plain(r, k, v, logw, u, initial_state=None, *, chunk: int = WKV_CHUNK
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, states, final_state)``: B8's body, each chunk's terms for all
    chunks at once, then the state carried chunk by chunk from
    ``initial_state`` (zeros if None). ``states[:, :, c]`` is the state at
    the start of chunk ``c``, ``final_state`` the state after the last."""
    b, s, h, p = _dims(r, k, v, logw, u)
    wt = _work_dtype(r)
    lc = min(chunk, s)
    rc, kc, vc, lw = (_chunks(t, lc, wt) for t in (r, k, v, logw))
    uf = u.to(wt)[None, :, None, None, :]             # (1, H, 1, 1, P)
    cum = torch.cumsum(lw, dim=3)
    r_dec = rc * torch.exp(cum - lw)
    k_boost = kc * torch.exp(-cum)
    a = r_dec @ k_boost.transpose(-1, -2)              # (B, H, nc, L, L)
    a = torch.where(_strictly_lower(lc, r.device), a, 0.0)
    y = a @ vc
    bonus = torch.sum(rc * uf * kc, dim=-1)
    y = y + bonus[..., None] * vc
    k_tail = kc * torch.exp(cum[..., -1:, :] - cum)
    s_chunk = k_tail.transpose(-1, -2) @ vc            # (B, H, nc, P, P)
    decay = torch.exp(cum[..., -1, :])[..., None]      # (B, H, nc, P, 1)
    state = _state(initial_state, b, h, p, "initial_state")
    state = torch.zeros((b, h, p, p), dtype=wt, device=r.device) \
        if state is None else state.to(wt)
    states = []
    for c in range(rc.shape[2]):
        states.append(state)
        state = state * decay[:, :, c] + s_chunk[:, :, c]
    states = torch.stack(states, dim=2)
    y = y + r_dec @ states
    return _unchunk(y, s, r.dtype), states, state


def wkv6_bwd_plain(r, k, v, logw, u, states, dy, d_final=None, *,
                   with_initial: bool = False) -> Tuple[Optional[torch.Tensor], ...]:
    """``(dr, dk, dv, dlogw, du, d_initial)`` from the explicit formulas,
    chunk by chunk in reverse with ``dS`` carried from ``d_final`` (zeros if
    None), as W2 computes them; ``d_initial``, the ``dS`` carried past the
    first chunk, is None unless ``with_initial``. ``states`` is the
    forward's (its first the initial state); each intra-chunk pair's decay
    is ``exp(cumprev_t - cum_j)``."""
    b, s, h, p = _dims(r, k, v, logw, u)
    wt = _work_dtype(r)
    lc = min(WKV_CHUNK, s)
    rc, kc, vc, lw, dyc = (_chunks(t, lc, wt) for t in (r, k, v, logw, dy))
    uf = u.to(wt)[None, :, None, :]                    # (1, H, 1, P)
    lower = _strictly_lower(lc, r.device)
    cum = torch.cumsum(lw, dim=3)
    cumprev = cum - lw
    d_s = _state(d_final, b, h, p, "d_final")
    d_s = torch.zeros((b, h, p, p), dtype=wt, device=r.device) \
        if d_s is None else d_s.to(wt)
    du = torch.zeros((b, h, p), dtype=wt, device=r.device)
    grads = [torch.empty_like(rc) for _ in range(4)]   # dr, dk, dv, dlogw
    for c in reversed(range(rc.shape[2])):
        rj, kj, vj, dyj = (t[:, :, c] for t in (rc, kc, vc, dyc))
        cj, cpj, st = cum[:, :, c], cumprev[:, :, c], states[:, :, c].to(wt)
        cum_l = cj[..., -1:, :]                        # (B, H, 1, P)
        e = torch.exp(cum_l[..., 0, :])                # (B, H, P)
        r_dec = rj * torch.exp(cpj)
        k_tail = kj * torch.exp(cum_l - cj)
        a = torch.where(lower, r_dec @ (kj * torch.exp(-cj)).transpose(-1, -2),
                        0.0)
        d_a = torch.where(lower, dyj @ vj.transpose(-1, -2), 0.0)
        bonus = torch.sum(rj * uf * kj, dim=-1)        # (B, H, L)
        d_bonus = torch.sum(dyj * vj, dim=-1)
        # pair (t, j): exp(cumprev_t - cum_j) <= 1 where j < t, 0 elsewhere
        gap = cpj[..., :, None, :] - cj[..., None, :, :]
        pair = torch.where(lower[..., None], torch.exp(
            torch.where(lower[..., None], gap, 0.0)), 0.0)   # (B, H, L, L, P)
        dr_dec = (torch.einsum("bhtj,bhjp,bhtjp->bhtp", d_a, kj, pair)
                  + torch.exp(cpj) * (dyj @ st.transpose(-1, -2)))
        dk_boost = torch.einsum("bhtj,bhtp,bhtjp->bhjp", d_a, rj, pair)
        dk_tail = torch.exp(cum_l - cj) * (vj @ d_s.transpose(-1, -2))
        grads[0][:, :, c] = dr_dec + d_bonus[..., None] * uf * kj
        grads[1][:, :, c] = dk_boost + dk_tail + d_bonus[..., None] * uf * rj
        grads[2][:, :, c] = (a.transpose(-1, -2) @ dyj + bonus[..., None] * dyj
                             + k_tail @ d_s)
        du = du + torch.sum(d_bonus[..., None] * rj * kj, dim=2)
        d_cumprev = rj * dr_dec
        d_cum = d_cumprev - kj * dk_boost - kj * dk_tail
        d_cum_l = (torch.sum(kj * dk_tail, dim=2)
                   + e * torch.sum(st * d_s, dim=-1))
        d_cum[..., -1, :] += d_cum_l
        grads[3][:, :, c] = (torch.flip(torch.cumsum(torch.flip(d_cum, [2]),
                                                     dim=2), [2]) - d_cumprev)
        d_s = e[..., None] * d_s + r_dec.transpose(-1, -2) @ dyj
    dr, dk, dv, dlw = (_unchunk(g, s, t.dtype)
                       for g, t in zip(grads, (r, k, v, logw)))
    return (dr, dk, dv, dlw, du.sum(dim=0).to(u.dtype),
            d_s if with_initial else None)


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# batch, seq, heads, head_dim, chunk; bf16
_DIMS = [_INT] * 6
_SIGNATURES = {
    "wkv6_fwd": [_PTR] * 10 + _DIMS,
    "wkv6_bwd": [_PTR] * 17 + _DIMS,
}

LIB = build.Library("wkv6", _SIGNATURES)
# launches of each CUDA kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = LIB.launches
reset_launches = LIB.reset


def _kernel_inputs(r, k, v, logw, u):
    """Check what the CUDA kernels take; return r, k, v, logw in the
    kernels' input dtype (bf16 only when all four are bf16, else f32:
    widening is exact), u as f32, all contiguous, r, k, v and logw on 16
    bytes (the kernels read their rows 16 or 8 bytes at a time), and the
    dimension arguments. Raise on anything else."""
    b, s, h, p = _dims(r, k, v, logw, u)
    if p not in HEAD_DIMS:
        raise ValueError(f"head_dim {p} not supported; the kernels take {HEAD_DIMS}")
    if s < 1 or b < 1 or h < 1 or b > 65535 or h > 65535:
        raise ValueError(f"r {tuple(r.shape)}: need S >= 1 and 1 <= batch, "
                         "heads <= 65535")
    if r.numel() >= 2 ** 62:
        raise ValueError("tensor too large")
    ins = (r, k, v, logw)
    for t in ins + (u,):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"the kernels take f32 or bf16 inputs; got {t.dtype}")
    dt = torch.bfloat16 if all(t.dtype == torch.bfloat16 for t in ins) \
        else torch.float32
    ins = build.on_16_bytes(*(t.to(dt) for t in ins))
    lc = min(WKV_CHUNK, s)
    return ins, u.float().contiguous(), [b, s, h, p, lc,
                                         int(dt == torch.bfloat16)]


def _state_input(t: Optional[torch.Tensor], dims, name: str) -> Optional[torch.Tensor]:
    """A carried state (or its gradient) as the kernels take it: f32
    ``(B, H, P, P)``, contiguous, on 16 bytes; None stays None."""
    b, _, h, p = dims[:4]
    if _state(t, b, h, p, name) is None:
        return None
    return build.on_16_bytes(t.float())[0]


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def wkv6_fwd(r, k, v, logw, u, initial_state=None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, states, final_state)`` through W1 on a CUDA tensor, the plain
    version on the CPU, from ``initial_state`` (zeros if None). y is in r's
    dtype, states f32 ``(B, H, chunks, P, P)``, the final state f32 ``(B, H,
    P, P)``."""
    if not build.route("WKV6", r, k, v, logw, u,
                       *(() if initial_state is None else (initial_state,))):
        return wkv6_plain(r, k, v, logw, u, initial_state)
    ins, uf, args = _kernel_inputs(r, k, v, logw, u)
    b, s, h, p, lc, _ = args
    init = _state_input(initial_state, args, "initial_state")
    nc, dev = -(-s // lc), r.device
    y = torch.empty(r.shape, dtype=ins[0].dtype, device=dev)
    states = torch.empty((b, h, nc, p, p), dtype=torch.float32, device=dev)
    final = torch.empty((b, h, p, p), dtype=torch.float32, device=dev)
    # exp(cum_L) of every chunk
    _, scratch = build.scratch(dev, b * h * nc * p)
    LIB.launch("wkv6_fwd", dev, *(t.data_ptr() for t in ins), uf.data_ptr(),
               y.data_ptr(), states.data_ptr(), _ptr(init), final.data_ptr(),
               *scratch, *args)
    return y.to(r.dtype), states, final


def wkv6_bwd(r, k, v, logw, u, states, dy, d_final=None, *,
             with_initial: bool = False) -> Tuple[Optional[torch.Tensor], ...]:
    """``(dr, dk, dv, dlogw, du, d_initial)`` through W2 on a CUDA tensor,
    the plain version on the CPU, from the final state's gradient
    ``d_final`` (zeros if None); each gradient in its input's dtype,
    ``d_initial`` f32 ``(B, H, P, P)`` if ``with_initial``, else None."""
    more = () if d_final is None else (d_final,)
    if not build.route("WKV6", r, k, v, logw, u, states, dy, *more):
        return wkv6_bwd_plain(r, k, v, logw, u, states, dy, d_final,
                              with_initial=with_initial)
    ins, uf, args = _kernel_inputs(r, k, v, logw, u)
    b, s, h, p, lc, _ = args
    nc, dev = -(-s // lc), r.device
    if states.shape != (b, h, nc, p, p) or states.dtype != torch.float32:
        raise ValueError(f"states must be f32 {(b, h, nc, p, p)}, got "
                         f"{states.dtype} {tuple(states.shape)}")
    if dy.shape != r.shape:
        raise ValueError(f"dy must be {tuple(r.shape)}, got {tuple(dy.shape)}")
    d_fin = _state_input(d_final, args, "d_final")
    states, dy = build.on_16_bytes(states, dy.to(ins[0].dtype))
    grads = [torch.empty(r.shape, dtype=torch.float32, device=dev) for _ in range(4)]
    du = torch.empty((h, p), dtype=torch.float32, device=dev)
    d_init = torch.empty((b, h, p, p), dtype=torch.float32, device=dev) \
        if with_initial else None
    # dS of every chunk, then exp(cum_L) and du's partials of every chunk
    _, scratch = build.scratch(dev, b * h * nc * p * p, b * h * nc * p, b * h * nc * p)
    LIB.launch("wkv6_bwd", dev, *(t.data_ptr() for t in ins), uf.data_ptr(),
               states.data_ptr(), dy.data_ptr(), _ptr(d_fin),
               *(g.data_ptr() for g in grads + [du]), _ptr(d_init), *scratch, *args)
    dr, dk, dv, dlw = (g.to(t.dtype) for g, t in zip(grads, (r, k, v, logw)))
    return dr, dk, dv, dlw, du.to(u.dtype), d_init


@torch.library.custom_op("repro_torch::wkv6_fwd", mutates_args=())
def _fwd_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            logw: torch.Tensor, u: torch.Tensor, initial_state: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`wkv6_fwd` as one operator: a dispatch mode sees the call once
    (``OpCostModel`` prices it), and a fake tensor takes its shapes alone."""
    return wkv6_fwd(r, k, v, logw, u, initial_state)


@_fwd_op.register_fake
def _(r, k, v, logw, u, initial_state):
    b, s, h, p = r.shape
    nc = -(-s // min(WKV_CHUNK, s))
    return (torch.empty_like(r), r.new_empty((b, h, nc, p, p), dtype=torch.float32),
            r.new_empty((b, h, p, p), dtype=torch.float32))


@torch.library.custom_op("repro_torch::wkv6_bwd", mutates_args=())
def _bwd_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            logw: torch.Tensor, u: torch.Tensor, states: torch.Tensor,
            dy: torch.Tensor, d_final: Optional[torch.Tensor], with_initial: bool
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`wkv6_bwd` as one operator (as :func:`_fwd_op`); without
    ``with_initial`` its last output is empty."""
    *grads, d_init = wkv6_bwd(r, k, v, logw, u, states, dy, d_final,
                              with_initial=with_initial)
    if d_init is None:
        d_init = r.new_empty((0,), dtype=torch.float32)
    return (*grads, d_init)


@_bwd_op.register_fake
def _(r, k, v, logw, u, states, dy, d_final, with_initial):
    b, _, h, p = r.shape
    shape = (b, h, p, p) if with_initial else (0,)
    return tuple(torch.empty_like(t) for t in (r, k, v, logw, u)) + (
        r.new_empty(shape, dtype=torch.float32),)


class _Wkv6(torch.autograd.Function):
    """Saves the inputs and the chunk states, nothing larger. A gradient
    that does not reach y or the final state is zeros (none of the final
    state's: W2 starts from zeros)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, initial_state):
        build.route("WKV6", r, k, v, logw, u)   # raises for a device without a route
        y, states, final = _fwd_op(r, k, v, logw, u, initial_state)
        ctx.save_for_backward(r, k, v, logw, u, states)
        ctx.initial = None if initial_state is None else initial_state.dtype
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, d_final):
        saved = ctx.saved_tensors
        with_initial = ctx.initial is not None and ctx.needs_input_grad[5]
        if dy is None:
            dy = torch.zeros_like(saved[0])
        *grads, d_init = _bwd_op(*saved, dy, d_final, with_initial)
        return (*grads, d_init.to(ctx.initial) if with_initial else None)


def wkv6(r, k, v, logw, u, initial_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV of ``r, k, v, logw (B, S, H, P)`` and ``u (H, P)`` from
    ``initial_state`` ``(B, H, P, P)`` (zeros if None): ``(y,
    final_state)``, y in r's dtype, the final state f32, differentiable in
    all six inputs (the reference's ``wkv6_chunked``). Replaces
    ``wkv6_pallas``, with a backward of its own. Forward and backward are
    each one operator (``repro_torch::wkv6_fwd``, ``wkv6_bwd``), so that the
    GSPMD path runs them on each device's shards and its dry run on fake
    tensors."""
    return _Wkv6.apply(r, k, v, logw, u, initial_state)
