"""Mamba2's SSD chunked scan, forward and backward (the counterpart of
``repro.kernels.ssd_scan``).

For one head, with x ``(S, P)``, dt ``(S,)``, the scalar decay rate A < 0,
and B, C ``(S, N)`` of its group (Mamba2's ngroups G: B and C ``(B, S, G,
N)``, head h reading group ``h // (H / G)``; ``(B, S, N)`` is G = 1, shared
by all heads)::

    S_t = exp(A dt_t) S_{t-1} + B_t (x) (dt_t x_t),    S_0 given or 0
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

  * ``ssd_fwd`` (S1) — y, the state at the start of every chunk,
    ``(B, H, chunks, N, P)`` f32, which the backward reads instead of
    walking the chunks forward again, and the final state ``(B, H, N, P)``
    f32, from an initial state (the reference's ``ssd_chunked(
    initial_state=)``; none is zeros). Three kernels: every chunk's summary
    ``(B ⊙ exp(g_L - g))^T xf`` and ``C B^T`` once per batch row and chunk
    (B and C are shared by a group's heads); the short pass that carries the
    states across the chunks from the initial state, and one step past the
    last to the final state; every chunk's outputs;
  * ``ssd_bwd`` (S2) — dx, d(dt), dA, dB and dC, from the final state's
    gradient (none is zeros), and the initial state's gradient where it is
    asked for. Four kernels: every chunk's ``(C ⊙ exp(g))^T dy``; the pass
    that carries ``dS`` back across the chunks from the final state's
    gradient, and one step past the first to the initial state's; every
    chunk's local terms from its state and ``dS``, dB and
    dC summed over a block's heads in order; and the sums over head groups,
    batch rows and chunks, each in a fixed order: no atomics, the same bits
    every run.

The wrappers allocate the scratch (``C B^T`` of every chunk, ``exp(g_L)``
of every chunk and head, S2's ``dS`` and partial sums) with ``torch.empty``.
At the main shape the function's fewest operations bound it on f32 FMAs,
and its bytes once its products run on the tensor cores
(``chip_smoke.ssd_bound``).

Each entry point is one launch of each of its kernels whatever G: no
``(B, S, H / G, P)`` slice is copied out. G = 1, in either layout, is the
ungrouped arithmetic, bit for bit.

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
from typing import Dict, Optional, Tuple

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
    """``(B, S, H, P, N)``; B and C ``(B, S, N)`` or ``(B, S, G, N)`` with G
    dividing H (:func:`_groups`)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    b, s, h, p = x.shape
    if tuple(dt.shape) != (b, s, h):
        raise ValueError(f"dt must be (B, S, H) = {(b, s, h)}, got {tuple(dt.shape)}")
    if tuple(A.shape) != (h,):
        raise ValueError(f"A must be (H,) = {(h,)}, got {tuple(A.shape)}")
    if Bm.dim() not in (3, 4) or tuple(Bm.shape[:2]) != (b, s) \
            or Cm.shape != Bm.shape:
        raise ValueError(f"Bm and Cm must be one (B, S, N) or (B, S, G, N) shape "
                         f"with (B, S) = {(b, s)}; got {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    _groups(Bm, h)
    return b, s, h, p, Bm.shape[-1]


def _groups(Bm: torch.Tensor, h: int) -> int:
    """B's (and C's) groups G: 1 for ``(B, S, N)``; G must divide H."""
    g = Bm.shape[2] if Bm.dim() == 4 else 1
    if g < 1 or h % g:
        raise ValueError(f"{g} B/C groups do not divide {h} heads")
    return g


def _grouped(m: torch.Tensor) -> torch.Tensor:
    """B or C as ``(B, S, G, N)``: a ``(B, S, N)`` one as one group."""
    return m if m.dim() == 4 else m[:, :, None]


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
    ``(B, 1, nc, L, N)`` (one group, for every head) or ``(B, H, nc, L, N)``
    (each head its group's), and ``g = cumsum(dt A)`` down each chunk."""
    xc = _chunks(x, lc, wt)
    dtc = _chunks(dt[..., None], lc, wt)[..., 0]
    bc, cc = (_chunks(_grouped(m), lc, wt) for m in (Bm, Cm))
    if bc.shape[1] > 1:
        bc, cc = (t.repeat_interleave(x.shape[2] // t.shape[1], dim=1)
                  for t in (bc, cc))
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


def _group_sum(t: torch.Tensor, g: int) -> torch.Tensor:
    """``(B, H, ...)`` summed over each of ``g`` groups' heads: ``(B, g,
    ...)``."""
    if g == 1:
        return t.sum(dim=1, keepdim=True)
    return t.reshape(t.shape[0], g, t.shape[1] // g, *t.shape[2:]).sum(dim=2)


# ---------------------------------------------------------------------------
# plain PyTorch versions: the reference the kernels are held against
# ---------------------------------------------------------------------------

def _state(t: Optional[torch.Tensor], b: int, h: int, n: int, p: int,
           name: str) -> Optional[torch.Tensor]:
    """Check a carried state (or its gradient): ``(B, H, N, P)``, or None."""
    if t is not None and tuple(t.shape) != (b, h, n, p):
        raise ValueError(f"{name} must be (B, H, N, P) = {(b, h, n, p)}, got "
                         f"{tuple(t.shape)}")
    return t


def ssd_scan_plain(x, dt, A, Bm, Cm, initial_state=None, *, chunk: int = SSD_CHUNK
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, states, final_state)``: B9's body, each chunk's terms for all
    chunks at once, then the state carried chunk by chunk from
    ``initial_state`` (zeros if None). ``states[:, :, c]`` is the state at
    the start of chunk ``c``, ``final_state`` the state after the last."""
    b, s, h, p, n = _dims(x, dt, A, Bm, Cm)
    wt = _work_dtype(x)
    lc = min(chunk, s)
    xc, dtc, bc, cc, g = _chunk_all(x, dt, A, Bm, Cm, lc, wt)
    xf = xc * dtc[..., None]
    y = ((cc @ bc.transpose(-1, -2)) * _pair_decay(g)) @ xf
    w_last = torch.exp(g[..., -1:] - g)                   # (B, H, nc, L)
    s_chunk = (bc * w_last[..., None]).transpose(-1, -2) @ xf   # (B, H, nc, N, P)
    decay = torch.exp(g[..., -1])[..., None, None]        # (B, H, nc, 1, 1)
    state = _state(initial_state, b, h, n, p, "initial_state")
    state = torch.zeros((b, h, n, p), dtype=wt, device=x.device) \
        if state is None else state.to(wt)
    states = []
    for c in range(xc.shape[2]):
        states.append(state)
        state = state * decay[:, :, c] + s_chunk[:, :, c]
    states = torch.stack(states, dim=2)
    y = y + (cc * torch.exp(g)[..., None]) @ states
    return _unchunk(y, s, x.dtype), states, state


def ssd_scan_bwd_plain(x, dt, A, Bm, Cm, states, dy, d_final=None, *,
                       with_initial: bool = False, chunk: int = SSD_CHUNK
                       ) -> Tuple[Optional[torch.Tensor], ...]:
    """``(dx, ddt, dA, dB, dC, d_initial)`` from the explicit formulas, as
    S2 computes them. ``states`` is the forward's at the same chunk (its
    first the initial state). First ``dS``, the gradient of the state after
    each chunk, carried back chunk by chunk from ``d_final`` (zeros if None)
    (``dS_start = exp(g_L) dS_end + (C ⊙ exp(g))^T dy``), the last step
    giving ``d_initial`` (None unless ``with_initial``); then every chunk's
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

    dB and dC are summed over each group's heads, in B's and C's layout.
    """
    b, s, h, p, n = _dims(x, dt, A, Bm, Cm)
    ng = _groups(Bm, h)
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
    d_end = _state(d_final, b, h, n, p, "d_final")
    d_end = torch.zeros((b, h, n, p), dtype=wt, device=x.device) \
        if d_end is None else d_end.to(wt)
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
    db, dc = (_unchunk(_group_sum(t, ng), s, m_.dtype).reshape(m_.shape)
              for t, m_ in ((db, Bm), (dc, Cm)))
    return dx, ddt, da_dt.to(A.dtype), db, dc, d_end if with_initial else None


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# batch, seq, heads, head_dim, state, chunk, B/C groups; S2: heads a block;
# bf16
_SIGNATURES = {
    "ssd_fwd": [_PTR] * 11 + [_INT] * 8,
    "ssd_bwd": [_PTR] * 20 + [_INT] * 9,
}

LIB = build.Library("ssd_scan", _SIGNATURES)
# launches of each CUDA kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = LIB.launches
reset_launches = LIB.reset


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


def _heads_per_block(h: int, g: int = 1) -> int:
    """Heads a block of S2's chunk-local stage: the largest divisor of a
    group's ``h / g`` heads up to :data:`SSD_BWD_HEADS`."""
    return max(k for k in range(1, SSD_BWD_HEADS + 1) if (h // g) % k == 0)


def _f32(*shape, device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=device)


def _state_input(t: Optional[torch.Tensor], dims, name: str) -> Optional[torch.Tensor]:
    """A carried state (or its gradient) as the kernels take it: f32
    ``(B, H, N, P)``, contiguous, on 16 bytes; None stays None."""
    b, _, h, p, n = dims[:5]
    if _state(t, b, h, n, p, name) is None:
        return None
    return build.on_16_bytes(t.float())[0]


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def ssd_scan_fwd(x, dt, A, Bm, Cm, initial_state=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, states, final_state)`` through S1 on a CUDA tensor, the plain
    version on the CPU, from ``initial_state`` (zeros if None). y is in x's
    dtype, states f32 ``(B, H, chunks, N, P)``, the final state f32 ``(B,
    H, N, P)``."""
    if not build.route("SSD", x, dt, A, Bm, Cm,
                       *(() if initial_state is None else (initial_state,))):
        return ssd_scan_plain(x, dt, A, Bm, Cm, initial_state)
    ins, args = _kernel_inputs(x, dt, A, Bm, Cm)
    b, s, h, p, n, lc, bf16 = args
    g = _groups(Bm, h)
    init = _state_input(initial_state, args, "initial_state")
    nc, dev = -(-s // lc), x.device
    y = torch.empty(x.shape, dtype=ins[0].dtype, device=dev)
    states, final = _f32(b, h, nc, n, p, device=dev), _f32(b, h, n, p, device=dev)
    # C B^T of every chunk and group, exp(g_L) of every chunk and head
    _, scratch = build.scratch(dev, b * g * nc * SSD_CHUNK ** 2, b * h * nc)
    LIB.launch("ssd_fwd", dev, *(t.data_ptr() for t in ins + (y, states)), _ptr(init),
               final.data_ptr(), *scratch, *args[:-1], g, bf16)
    return y.to(x.dtype), states, final


def ssd_scan_bwd(x, dt, A, Bm, Cm, states, dy, d_final=None, *,
                 with_initial: bool = False) -> Tuple[Optional[torch.Tensor], ...]:
    """``(dx, ddt, dA, dB, dC, d_initial)`` through S2 on a CUDA tensor, the
    plain version on the CPU, from the final state's gradient ``d_final``
    (zeros if None); each gradient in its input's dtype, ``d_initial`` f32
    ``(B, H, N, P)`` if ``with_initial``, else None."""
    more = () if d_final is None else (d_final,)
    if not build.route("SSD", x, dt, A, Bm, Cm, states, dy, *more):
        return ssd_scan_bwd_plain(x, dt, A, Bm, Cm, states, dy, d_final,
                                  with_initial=with_initial)
    ins, args = _kernel_inputs(x, dt, A, Bm, Cm)
    b, s, h, p, n, lc, bf16 = args
    g = _groups(Bm, h)
    if states.shape != (b, h, -(-s // lc), n, p) or states.dtype != torch.float32:
        raise ValueError(f"states must be f32 {(b, h, -(-s // lc), n, p)}, got "
                         f"{states.dtype} {tuple(states.shape)}")
    if dy.shape != x.shape:
        raise ValueError(f"dy must be {tuple(x.shape)}, got {tuple(dy.shape)}")
    d_fin = _state_input(d_final, args, "d_final")
    states, dy = build.on_16_bytes(states, dy.to(ins[0].dtype))
    nc, dev, hb = -(-s // lc), x.device, _heads_per_block(h, g)
    outs = (_f32(b, s, h, p, device=dev), _f32(b, s, h, device=dev), _f32(h, device=dev),
            _f32(*Bm.shape, device=dev), _f32(*Cm.shape, device=dev))
    d_init = _f32(b, h, n, p, device=dev) if with_initial else None
    # C B^T of every chunk and group, dS, the head groups' partials of dB
    # and dC (each on 16 bytes), then exp(g_L) and dA's partials of every
    # chunk and head
    _, (cb, ds, db_part, dc_part, el, da_part) = build.scratch(
        dev, b * g * nc * SSD_CHUNK ** 2, b * h * nc * n * p, b * (h // hb) * s * n,
        b * (h // hb) * s * n, b * h * nc, b * h * nc)
    LIB.launch("ssd_bwd", dev, *(t.data_ptr() for t in ins + (states, dy)), _ptr(d_fin),
               *(t.data_ptr() for t in outs), _ptr(d_init),
               cb, el, ds, da_part, db_part, dc_part, *args[:-1], g, hb, bf16)
    return tuple(g.to(t.dtype) for g, t in zip(outs, (x, dt, A, Bm, Cm))) + (d_init,)


@torch.library.custom_op("repro_torch::ssd_scan_fwd", mutates_args=())
def _fwd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, initial_state: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`ssd_scan_fwd` as one operator: a dispatch mode sees the call
    once (``OpCostModel`` prices it), and a fake tensor takes its shapes
    alone."""
    return ssd_scan_fwd(x, dt, A, Bm, Cm, initial_state)


@_fwd_op.register_fake
def _(x, dt, A, Bm, Cm, initial_state):
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    nc = -(-s // min(SSD_CHUNK, s))
    return (torch.empty_like(x),
            x.new_empty((b, h, nc, n, p), dtype=torch.float32),
            x.new_empty((b, h, n, p), dtype=torch.float32))


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=())
def _bwd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, states: torch.Tensor,
            dy: torch.Tensor, d_final: Optional[torch.Tensor], with_initial: bool
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor, torch.Tensor]:
    """:func:`ssd_scan_bwd` as one operator (as :func:`_fwd_op`); without
    ``with_initial`` its last output is empty."""
    *grads, d_init = ssd_scan_bwd(x, dt, A, Bm, Cm, states, dy, d_final,
                                  with_initial=with_initial)
    if d_init is None:
        d_init = x.new_empty((0,), dtype=torch.float32)
    return (*grads, d_init)


@_bwd_op.register_fake
def _(x, dt, A, Bm, Cm, states, dy, d_final, with_initial):
    b, _, h, p = x.shape
    shape = (b, h, Bm.shape[-1], p) if with_initial else (0,)
    return tuple(torch.empty_like(t) for t in (x, dt, A, Bm, Cm)) + (
        x.new_empty(shape, dtype=torch.float32),)


class _SsdScan(torch.autograd.Function):
    """Saves the inputs and the chunk states, nothing larger. A gradient
    that does not reach y or the final state is zeros (none of the final
    state's: S2 starts from zeros)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, initial_state):
        build.route("SSD", x, dt, A, Bm, Cm)   # raises for a device without a route
        y, states, final = _fwd_op(x, dt, A, Bm, Cm, initial_state)
        ctx.save_for_backward(x, dt, A, Bm, Cm, states)
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


def ssd_scan(x, dt, A, Bm, Cm, initial_state=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan of x ``(B, S, H, P)``, dt ``(B, S, H)``, A ``(H,)`` and
    Bm, Cm ``(B, S, N)`` or ``(B, S, G, N)`` from ``initial_state`` ``(B, H, N, P)`` (zeros if
    None): ``(y, final_state)``, y in x's dtype, the final state f32,
    differentiable in all six inputs (the reference's ``ssd_chunked`` at
    the kernels' chunk). Replaces ``ssd_scan_pallas``, with a backward of its
    own. Forward and backward are each one operator (``repro_torch::
    ssd_scan_fwd``, ``ssd_scan_bwd``), so that the GSPMD path runs them on
    each device's shards and its dry run on fake tensors."""
    return _SsdScan.apply(x, dt, A, Bm, Cm, initial_state)
