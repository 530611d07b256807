"""Mamba2's SSD chunked scan, forward and backward (the counterpart of
``repro.kernels.ssd_scan``).

For one head, with x ``(S, P)``, dt ``(S,)``, the scalar decay rate A < 0,
and B, C ``(S, N)`` shared by all heads (ngroups = 1)::

    S_t = exp(A dt_t) S_{t-1} + B_t (x) (dt_t x_t),    S_0 = 0
    y_t = C_t . S_t

computed as ``ssd_scan_pallas`` computes it: per chunk of ``L`` steps
(``S`` zero-padded to whole chunks, which leaves the decay flat over the
pad), ``g = cumsum(dt A)``, ``xf = x dt``, the intra-chunk term
``(C B^T ⊙ exp(g_t - g_j))_{t >= j} xf``, the readout ``(C ⊙ exp(g)) S``,
and the state update ``S exp(g_L) + (B ⊙ exp(g_L - g))^T xf``. Every decay
is an exponent that is at most 0: ``exp(g_t - g_j)`` is never factorized
into ``exp(g_t) exp(-g_j)``, which overflows once g falls below -88 (at
init, A = -e and dt near 0.7, g falls about 2 a step). Everything is f32
inside (the CUDA kernels take g and its differences in f64); y comes out in
x's dtype.

:func:`ssd_scan` is a ``torch.autograd.Function`` over two hand-written
CUDA entry points in ``csrc/ssd_scan.cu``, each a chunk-parallel scan whose
products run on the tensor cores in split TF32 (three TF32 products an f32
product, as B4's kernels):

  * ``ssd_fwd`` (S1) — y, and the state at the start of every chunk,
    ``(B, H, chunks, N, P)`` f32, which the backward reads instead of
    walking the chunks forward again. Three kernels: every chunk's summary
    ``(B ⊙ exp(g_L - g))^T xf`` and ``C B^T`` once per batch row and chunk
    (B and C are shared by the heads); the short pass that carries the
    states across the chunks; every chunk's outputs;
  * ``ssd_bwd`` (S2) — dx, d(dt), dA, dB and dC. Four kernels: every
    chunk's ``(C ⊙ exp(g))^T dy``; the pass that carries ``dS`` back across
    the chunks; every chunk's local terms from its state and ``dS``, dB and
    dC summed over a block's heads in order; and the sums over head groups,
    batch rows and chunks, each in a fixed order: no atomics, the same bits
    every run.

The wrappers allocate the scratch (``C B^T`` of every chunk, ``exp(g_L)``
of every chunk and head, S2's ``dS`` and partial sums) with ``torch.empty``.
At the main shape the function's fewest operations bound it on f32 FMAs,
and its bytes once its products run on the tensor cores
(``chip_smoke.ssd_bound``).

The kernels take chunks of :data:`SSD_CHUNK` = 64 steps, not B9's 128 or
the model's 256: S2's tiles at 64 (with two buffers of a head's) take 214
KB of an SM's 227 KB of shared memory. The chunked algorithm is exact for
any chunk; only the rounding moves.

Each kernel has a plain PyTorch version beside it (``*_plain``), the same
formulas in torch ops: the backward written out, not autograd of the
forward. A tensor on the CPU takes the plain versions; a CUDA tensor
launches the kernels or raises; any other device raises. Every launch adds
one to its kernel's entry in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

# the kernels' chunk
SSD_CHUNK = 64
# what the CUDA kernels take, (state size N, head dim P): the reduced and
# the full zamba2-1.2b
STATE_HEAD_DIMS = ((16, 32), (64, 64))
# most heads a block of S2's chunk-local stage takes (a divisor of H)
SSD_BWD_HEADS = 16


def _work_dtype(x: torch.Tensor) -> torch.dtype:
    """f32, as in B9; f64 inputs stay f64 (``gradcheck`` of the plain path)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _dims(x, dt, A, Bm, Cm):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    b, s, h, p = x.shape
    if tuple(dt.shape) != (b, s, h):
        raise ValueError(f"dt must be (B, S, H) = {(b, s, h)}, got {tuple(dt.shape)}")
    if tuple(A.shape) != (h,):
        raise ValueError(f"A must be (H,) = {(h,)}, got {tuple(A.shape)}")
    if Bm.dim() != 3 or tuple(Bm.shape[:2]) != (b, s) or Cm.shape != Bm.shape:
        raise ValueError(f"Bm and Cm must be one (B, S, N) shape with (B, S) = "
                         f"{(b, s)}; got {tuple(Bm.shape)}, {tuple(Cm.shape)}")
    return b, s, h, p, Bm.shape[-1]


def _chunks(x: torch.Tensor, lc: int, wt: torch.dtype) -> torch.Tensor:
    """``(B, S, H, K)`` zero-padded to whole chunks, as
    ``(B, H, chunks, L, K)`` in ``wt``."""
    b, s, h, k = x.shape
    x = F.pad(x.to(wt), (0, 0, 0, 0, 0, (-s) % lc))
    return x.reshape(b, -1, lc, h, k).permute(0, 3, 1, 2, 4)


def _unchunk(x: torch.Tensor, s: int, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`_chunks`: ``(B, S, H, K)`` in ``dtype``."""
    b, h, nc, lc, k = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(b, nc * lc, h, k)[:, :s].to(dtype)


def _chunk_all(x, dt, A, Bm, Cm, lc: int, wt: torch.dtype):
    """x ``(B, H, nc, L, P)``, dt ``(B, H, nc, L)``, B and C
    ``(B, 1, nc, L, N)``, and ``g = cumsum(dt A)`` down each chunk."""
    xc = _chunks(x, lc, wt)
    dtc = _chunks(dt[..., None], lc, wt)[..., 0]
    bc, cc = (_chunks(m[:, :, None], lc, wt) for m in (Bm, Cm))
    g = torch.cumsum(dtc * A.to(wt)[None, :, None, None], dim=-1)
    return xc, dtc, bc, cc, g


def _pair_decay(g: torch.Tensor) -> torch.Tensor:
    """``exp(g_t - g_j)`` where ``j <= t``, 0 elsewhere, ``(..., L, L)``;
    the exponent is masked before ``exp``, so nothing overflows, in either
    direction of autograd."""
    lc = g.shape[-1]
    lower = torch.tril(torch.ones(lc, lc, dtype=torch.bool, device=g.device))
    gap = g[..., :, None] - g[..., None, :]
    return torch.where(lower, torch.exp(torch.where(lower, gap, 0.0)), 0.0)


# ---------------------------------------------------------------------------
# plain PyTorch versions: the reference the kernels are held against
# ---------------------------------------------------------------------------

def ssd_scan_plain(x, dt, A, Bm, Cm, *, chunk: int = SSD_CHUNK
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, states)``: B9's body, each chunk's terms for all chunks at
    once, then the state carried chunk by chunk. ``states[:, :, c]`` is the
    state at the start of chunk ``c``."""
    b, s, h, p, n = _dims(x, dt, A, Bm, Cm)
    wt = _work_dtype(x)
    lc = min(chunk, s)
    xc, dtc, bc, cc, g = _chunk_all(x, dt, A, Bm, Cm, lc, wt)
    xf = xc * dtc[..., None]
    y = ((cc @ bc.transpose(-1, -2)) * _pair_decay(g)) @ xf
    w_last = torch.exp(g[..., -1:] - g)                   # (B, H, nc, L)
    s_chunk = (bc * w_last[..., None]).transpose(-1, -2) @ xf   # (B, H, nc, N, P)
    decay = torch.exp(g[..., -1])[..., None, None]        # (B, H, nc, 1, 1)
    state = torch.zeros((b, h, n, p), dtype=wt, device=x.device)
    states = []
    for c in range(xc.shape[2]):
        states.append(state)
        state = state * decay[:, :, c] + s_chunk[:, :, c]
    states = torch.stack(states, dim=2)
    y = y + (cc * torch.exp(g)[..., None]) @ states
    return _unchunk(y, s, x.dtype), states


def ssd_scan_bwd_plain(x, dt, A, Bm, Cm, states, dy, *, chunk: int = SSD_CHUNK
                       ) -> Tuple[torch.Tensor, ...]:
    """``(dx, ddt, dA, dB, dC)`` from the explicit formulas, as S2 computes
    them. ``states`` is the forward's at the same chunk. First ``dS``, the
    gradient of the state after each chunk, carried back chunk by chunk
    (``dS_start = exp(g_L) dS_end + (C ⊙ exp(g))^T dy``); then every chunk's
    terms at once. With ``M = C B^T ⊙ exp(g_t - g_j)`` (``j <= t``),
    ``G = dy xf^T ⊙ exp(g_t - g_j)`` and ``Q = G ⊙ C B^T`` (``j < t``)::

        dxf = M^T dy + exp(g_L - g) ⊙ (B dS)
        dC  = G B + exp(g) ⊙ (dy S^T)
        dB  = G^T C + exp(g_L - g) ⊙ (xf dS^T)
        dg  = rowsum Q - colsum Q + exp(g) ⊙ rowsum(dy ⊙ C S) - R,
              R = exp(g_L - g) ⊙ rowsum(xf ⊙ B dS); the last step adds
              exp(g_L) <S, dS> + sum R
        da  = reverse cumsum of dg;  ddt = da A + rowsum(dxf ⊙ x);
        dx  = dxf dt;  dA = sum da dt
    """
    b, s, h, p, n = _dims(x, dt, A, Bm, Cm)
    wt = _work_dtype(x)
    lc = min(chunk, s)
    xc, dtc, bc, cc, g = _chunk_all(x, dt, A, Bm, Cm, lc, wt)
    dyc = _chunks(dy, lc, wt)
    nc = xc.shape[2]
    if tuple(states.shape) != (b, h, nc, n, p):
        raise ValueError(f"states must be {(b, h, nc, n, p)}, got "
                         f"{tuple(states.shape)}")
    st = states.to(wt)
    xf = xc * dtc[..., None]
    e = torch.exp(g)                                       # (B, H, nc, L)
    e_last = e[..., -1]                                    # (B, H, nc)
    w_last = torch.exp(g[..., -1:] - g)
    read = (cc * e[..., None]).transpose(-1, -2) @ dyc    # (B, H, nc, N, P)
    d_end = torch.zeros((b, h, n, p), dtype=wt, device=x.device)
    d_ends = []
    for c in reversed(range(nc)):
        d_ends.append(d_end)
        d_end = e_last[:, :, c, None, None] * d_end + read[:, :, c]
    ds = torch.stack(d_ends[::-1], dim=2)                  # dS after each chunk
    decay = _pair_decay(g)
    cb = cc @ bc.transpose(-1, -2)                         # (B, 1, nc, L, L)
    m = cb * decay
    gg = (dyc @ xf.transpose(-1, -2)) * decay
    strict = torch.tril(torch.ones(lc, lc, dtype=torch.bool, device=x.device),
                        diagonal=-1)
    q = torch.where(strict, gg * cb, 0.0)
    b_ds = bc @ ds                                         # (B, H, nc, L, P)
    dxf = m.transpose(-1, -2) @ dyc + w_last[..., None] * b_ds
    dc = gg @ bc + e[..., None] * (dyc @ st.transpose(-1, -2))
    db = gg.transpose(-1, -2) @ cc + w_last[..., None] * (xf @ ds.transpose(-1, -2))
    r = w_last * torch.sum(xf * b_ds, dim=-1)
    dg = (q.sum(dim=-1) - q.sum(dim=-2) - r
          + e * torch.sum(dyc * (cc @ st), dim=-1))
    dg[..., -1] += e_last * torch.sum(st * ds, dim=(-1, -2)) + r.sum(dim=-1)
    da = torch.flip(torch.cumsum(torch.flip(dg, [-1]), dim=-1), [-1])
    ddt = da * A.to(wt)[None, :, None, None] + torch.sum(dxf * xc, dim=-1)
    da_dt = (da * dtc).sum(dim=(0, 2, 3))
    dx = _unchunk(dxf * dtc[..., None], s, x.dtype)
    ddt = _unchunk(ddt[..., None], s, dt.dtype)[..., 0]
    db, dc = (_unchunk(t.sum(dim=1, keepdim=True), s, m_.dtype)[:, :, 0]
              for t, m_ in ((db, Bm), (dc, Cm)))
    return dx, ddt, da_dt.to(A.dtype), db, dc


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# batch, seq, heads, head_dim, state, chunk; S2: heads a block; bf16
_SIGNATURES = {
    "ssd_fwd": [_PTR] * 9 + [_INT] * 7,
    "ssd_bwd": [_PTR] * 18 + [_INT] * 8,
}

# launches of each CUDA kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = dict.fromkeys(_SIGNATURES, 0)
# set to a list to time every launch: (kernel, start, end) CUDA events are
# appended to it; None (the default) records nothing
TIMED: Optional[List[Tuple[str, torch.cuda.Event, torch.cuda.Event]]] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes + [_PTR]   # then the stream
        fn.restype = ctypes.c_int
    return lib


def _route(*tensors: torch.Tensor) -> bool:
    """True for the CUDA kernels, False for the plain versions on the CPU."""
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError(f"tensors on several devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if device.type == "cpu":
        return False
    if device.type == "cuda":
        return True
    raise ValueError(f"no SSD kernel for device {device}")


def _launch(kernel: str, device: torch.device, *args) -> None:
    """Launch ``kernel`` on ``device``'s current stream; raise on error."""
    fn = getattr(_lib(), kernel)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        if TIMED is not None:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record(stream)
        err = fn(*args, stream.cuda_stream)
        if TIMED is not None:
            end.record(stream)
            TIMED.append((kernel, start, end))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[kernel] += 1


def _kernel_inputs(x, dt, A, Bm, Cm):
    """Check what the CUDA kernels take; return x, Bm, Cm in the kernels'
    input dtype (bf16 only when all three are bf16, else f32: widening is
    exact), dt and A as f32, all contiguous (x reaches the SSD as a view of
    a split of the conv output: this is where it is copied into the
    kernels' layout), x, Bm and Cm on 16 bytes (the kernels read their rows
    16 or 8 bytes at a time), and the dimension arguments. Raise on
    anything else."""
    b, s, h, p, n = _dims(x, dt, A, Bm, Cm)
    if (n, p) not in STATE_HEAD_DIMS:
        raise ValueError(f"state size {n} with head_dim {p} not supported; the "
                         f"kernels take (state size, head_dim) in {STATE_HEAD_DIMS}")
    if s < 1 or b < 1 or h < 1 or b > 65535 or h > 65535:
        raise ValueError(f"x {tuple(x.shape)}: need S >= 1 and 1 <= batch, "
                         "heads <= 65535")
    if x.numel() >= 2 ** 62:
        raise ValueError("tensor too large")
    ins = (x, Bm, Cm)
    for t in ins + (dt, A):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"the kernels take f32 or bf16 inputs; got {t.dtype}")
    wire = torch.bfloat16 if all(t.dtype == torch.bfloat16 for t in ins) \
        else torch.float32
    xk, bk, ck = build.on_16_bytes(*(t.to(wire) for t in ins))
    dtk, ak = (t.float().contiguous() for t in (dt, A))
    lc = min(SSD_CHUNK, s)
    return (xk, dtk, ak, bk, ck), [b, s, h, p, n, lc, int(wire == torch.bfloat16)]


def _heads_per_block(h: int) -> int:
    """Heads a block of S2's chunk-local stage: the largest divisor of
    ``h`` up to :data:`SSD_BWD_HEADS`."""
    return max(k for k in range(1, SSD_BWD_HEADS + 1) if h % k == 0)


def _f32(*shape, device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=device)


def ssd_scan_fwd(x, dt, A, Bm, Cm) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, states)`` through S1 on a CUDA tensor, the plain version on the
    CPU. y is in x's dtype, states f32 ``(B, H, chunks, N, P)``."""
    if not _route(x, dt, A, Bm, Cm):
        return ssd_scan_plain(x, dt, A, Bm, Cm)
    ins, args = _kernel_inputs(x, dt, A, Bm, Cm)
    b, s, h, p, n, lc, _ = args
    nc, dev = -(-s // lc), x.device
    y = torch.empty(x.shape, dtype=ins[0].dtype, device=dev)
    states = _f32(b, h, nc, n, p, device=dev)
    # C B^T of every chunk, exp(g_L) of every chunk and head
    _, scratch = build.scratch(dev, b * nc * SSD_CHUNK ** 2, b * h * nc)
    _launch("ssd_fwd", dev, *(t.data_ptr() for t in ins + (y, states)), *scratch, *args)
    return y.to(x.dtype), states


def ssd_scan_bwd(x, dt, A, Bm, Cm, states, dy) -> Tuple[torch.Tensor, ...]:
    """``(dx, ddt, dA, dB, dC)`` through S2 on a CUDA tensor, the plain
    version on the CPU; each gradient in its input's dtype."""
    if not _route(x, dt, A, Bm, Cm, states, dy):
        return ssd_scan_bwd_plain(x, dt, A, Bm, Cm, states, dy)
    ins, args = _kernel_inputs(x, dt, A, Bm, Cm)
    b, s, h, p, n, lc, _ = args
    if states.shape != (b, h, -(-s // lc), n, p) or states.dtype != torch.float32:
        raise ValueError(f"states must be f32 {(b, h, -(-s // lc), n, p)}, got "
                         f"{states.dtype} {tuple(states.shape)}")
    if dy.shape != x.shape:
        raise ValueError(f"dy must be {tuple(x.shape)}, got {tuple(dy.shape)}")
    states, dy = build.on_16_bytes(states, dy.to(ins[0].dtype))
    nc, dev, hb = -(-s // lc), x.device, _heads_per_block(h)
    outs = (_f32(b, s, h, p, device=dev), _f32(b, s, h, device=dev), _f32(h, device=dev),
            _f32(b, s, n, device=dev), _f32(b, s, n, device=dev))
    # C B^T of every chunk, dS, the groups' partials of dB and dC (each on
    # 16 bytes), then exp(g_L) and dA's partials of every chunk and head
    _, (cb, ds, db_part, dc_part, el, da_part) = build.scratch(
        dev, b * nc * SSD_CHUNK ** 2, b * h * nc * n * p, b * (h // hb) * s * n,
        b * (h // hb) * s * n, b * h * nc, b * h * nc)
    _launch("ssd_bwd", dev, *(t.data_ptr() for t in ins + (states, dy) + outs),
            cb, el, ds, da_part, db_part, dc_part, *args[:-1], hb, args[-1])
    return tuple(g.to(t.dtype) for g, t in zip(outs, (x, dt, A, Bm, Cm)))


@torch.library.custom_op("repro_torch::ssd_scan_fwd", mutates_args=())
def _fwd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_scan_fwd` as one operator: a dispatch mode sees the call
    once (``OpCostModel`` prices it), and a fake tensor takes its shapes
    alone."""
    return ssd_scan_fwd(x, dt, A, Bm, Cm)


@_fwd_op.register_fake
def _(x, dt, A, Bm, Cm):
    b, s, h, p = x.shape
    nc = -(-s // min(SSD_CHUNK, s))
    return (torch.empty_like(x),
            x.new_empty((b, h, nc, Bm.shape[-1], p), dtype=torch.float32))


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=())
def _bwd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, states: torch.Tensor,
            dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """:func:`ssd_scan_bwd` as one operator (as :func:`_fwd_op`)."""
    return ssd_scan_bwd(x, dt, A, Bm, Cm, states, dy)


@_bwd_op.register_fake
def _(x, dt, A, Bm, Cm, states, dy):
    return tuple(torch.empty_like(t) for t in (x, dt, A, Bm, Cm))


class _SsdScan(torch.autograd.Function):
    """Saves the inputs and the chunk states, nothing larger."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        _route(x, dt, A, Bm, Cm)   # raises for a device without a route
        y, states = _fwd_op(x, dt, A, Bm, Cm)
        ctx.save_for_backward(x, dt, A, Bm, Cm, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        return _bwd_op(*ctx.saved_tensors, dy)


def ssd_scan(x, dt, A, Bm, Cm) -> torch.Tensor:
    """The SSD scan of x ``(B, S, H, P)``, dt ``(B, S, H)``, A ``(H,)`` and
    Bm, Cm ``(B, S, N)``, in x's dtype, from a zero state, differentiable
    in all five. Replaces ``ssd_scan_pallas``, with a backward of its own.
    Forward and backward are each one operator (``repro_torch::
    ssd_scan_fwd``, ``ssd_scan_bwd``), so that the GSPMD path runs them on
    each device's shards and its dry run on fake tensors."""
    return _SsdScan.apply(x, dt, A, Bm, Cm)
