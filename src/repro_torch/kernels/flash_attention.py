"""Flash attention, forward and backward (the counterpart of
``repro.kernels.flash_attention``).

Causal, sliding-window and GQA attention over ``(B, S, H, D)`` tensors, as
``flash_attention_pallas`` computes it: scores ``(f32(q) * scale) .
f32(k)``, ``scale`` the caller's or ``1/sqrt(D)`` (B4's; Zamba2's shared
attention takes ``1/sqrt(D/2)``), masked to ``NEG_INF = -1e30`` (keys past ``Skv``, above the
diagonal when causal, ``qpos - kpos >= window``; query row ``i`` at
position ``qpos = i + q_offset``, the reference's ``attention(q_offset=)``),
an online softmax over kv
blocks with f32 ``m``, ``l`` and ``acc``, and ``O = acc / max(l, 1e-30)`` in
``q``'s dtype. The forward also gives the row log-sum-exp ``lse = m + log l``
(f32, ``(B, Hq, Sq)``), from which the backward recomputes the
probabilities.

:func:`flash_attention` is a ``torch.autograd.Function`` over four
hand-written CUDA kernels in ``csrc/flash_attention.cu``:

  * ``flash_attention_fwd`` (F1) — ``O`` and ``lse``;
  * ``flash_attention_bwd_preprocess`` (F2) — ``delta = rowsum(dO * O)``;
  * ``flash_attention_bwd_dkdv`` (F3) — ``dK`` and ``dV``, GQA summed over
    each kv head's group inside one thread block (no atomics);
  * ``flash_attention_bwd_dq`` (F4) — ``dQ``.

F1, F3 and F4 run their products on the tensor cores in split TF32: each
f32 operand is split into a TF32 ``hi`` and a TF32 ``lo = x - hi``, and
three products (``lo.hi + hi.lo``, then ``hi.hi``) keep the f32 limits
(plain TF32 would miss them); the source's note gives the design and its
measurements. F2 uses f32 FMAs.

Their wrappers are :func:`flash_attention_fwd`, :func:`bwd_preprocess`,
:func:`bwd_dkdv` and :func:`bwd_dq`; :func:`flash_attention_bwd` runs the
last three in turn. :func:`blocks_per_sm` reports the occupancy of each on
the card.

Each has a plain PyTorch version beside it (``*_plain``): the same blocked
arithmetic in torch ops, B4's padding and masking included. A tensor on the
CPU takes the plain versions; a CUDA tensor launches the kernels or raises;
any other device raises. Every launch adds one to its kernel's entry in
:data:`LAUNCHES`. The kernels hold 64 rows a block and stream the other
side 16 rows a stage; the plain forward's kv block (``block_k``, B4's 128
by default) changes the rounding only, not the function.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

NEG_INF = -1e30
# what the CUDA kernels take
HEAD_DIMS = (32, 64, 80, 128, 224)
DTYPES = (torch.float32, torch.bfloat16)


def _scale(d: int, scale: Optional[float]) -> float:
    """The scores' scale: the caller's, or B4's ``1/sqrt(D)``."""
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def _work_dtype(x: torch.Tensor) -> torch.dtype:
    """f32, as in B4; f64 inputs stay f64 (``gradcheck`` of the plain path)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _dims(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, Sq, Hq, D) and k, v (B, Skv, Hkv, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, skv, hkv, dk = k.shape
    if k.shape[0] != b or dk != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: batch and "
                         "head_dim must agree and q_heads % kv_heads == 0")
    return b, sq, skv, hq, hkv, d


def query_offset(q_offset) -> int:
    """The query offset as an int: an int, or a 0-d integer tensor (the
    reference's ``int | jax.Array``), which is read once, on the host (a
    CUDA tensor's read waits for the device)."""
    if isinstance(q_offset, torch.Tensor):
        if q_offset.dim() != 0 or q_offset.is_floating_point() \
                or q_offset.is_complex():
            raise TypeError(f"q_offset must be an int or a 0-d integer tensor; "
                            f"got {q_offset.dtype} {tuple(q_offset.shape)}")
        return int(q_offset.item())
    return int(q_offset)


def _positions(sq: int, q_offset: int, device) -> torch.Tensor:
    """The query rows' positions, ``arange(Sq) + q_offset``."""
    return torch.arange(sq, device=device) + q_offset


def _visible(qpos: torch.Tensor, kpos: torch.Tensor, skv: int, causal: bool,
             window: Optional[int]) -> torch.Tensor:
    """B4's mask of (query, key) pairs, ``(len(qpos), len(kpos))``."""
    mask = (kpos < skv)[None, :].expand(qpos.shape[0], -1)
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if window is not None:
        mask = mask & (qpos[:, None] - kpos[None, :] < window)
    return mask


def _grouped(x: torch.Tensor, hkv: int, wt: torch.dtype) -> torch.Tensor:
    """``(B, S, Hq, D)`` as ``(B, Hkv, G, S, D)`` in ``wt``: the q heads of
    each kv head's group (head ``h`` reads kv head ``h // G``)."""
    b, s, hq, d = x.shape
    return x.to(wt).reshape(b, s, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4)


def _kv_blocks(k: torch.Tensor, block_k: int, wt: torch.dtype):
    """``(start, (B, Hkv, block_k, D) block)`` of ``k`` zero-padded to whole
    blocks, as B4 pads it."""
    skv = k.shape[1]
    kp = F.pad(k, (0, 0, 0, 0, 0, (-skv) % block_k)).to(wt)
    for start in range(0, kp.shape[1], block_k):
        yield start, kp[:, start:start + block_k].permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# plain PyTorch versions: the reference the kernels are held against
# ---------------------------------------------------------------------------

def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None, block_k: int = 128,
                          q_offset: int = 0, scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(O, lse)``: B4's online softmax over kv blocks of ``block_k``
    (capped at ``Skv``). Rows are independent, so B4's q blocking changes
    no row's arithmetic: all query rows go at once."""
    b, sq, skv, hq, hkv, d = _dims(q, k, v)
    wt = _work_dtype(q)
    block_k = min(block_k, skv)
    qg = _grouped(q, hkv, wt) * _scale(d, scale)
    qpos = _positions(sq, query_offset(q_offset), q.device)
    m = torch.full(qg.shape[:-1], NEG_INF, dtype=wt, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    for (start, kj), (_, vj) in zip(_kv_blocks(k, block_k, wt),
                                    _kv_blocks(v, block_k, wt)):
        kpos = torch.arange(start, start + block_k, device=q.device)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kj)
        s = torch.where(_visible(qpos, kpos, skv, causal, window), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vj)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
    return out, (m + torch.log(l)).reshape(b, hq, sq)


def bwd_preprocess_plain(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """F2's ``delta = rowsum(dO * O)``, ``(B, Hq, Sq)``."""
    wt = _work_dtype(o)
    return (do.to(wt) * o.to(wt)).sum(dim=-1).transpose(1, 2).contiguous()


def _block_grads(qg, dog, kj, vj, lse, delta, qpos, kpos, skv, causal, window):
    """``(P, dS)`` of one kv block for every query row: ``P = exp(S - lse)``
    (0 where masked, as ``exp(-1e30 - lse)``), ``dS = P * (dO V^T - delta)``."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kj)
    s = torch.where(_visible(qpos, kpos, skv, causal, window), s, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vj)
    return p, p * (dp - delta[..., None])


def _bwd_blocks(q, k, v, do, lse, delta, causal, window, q_offset, scale):
    """Shared set-up of F3's and F4's plain versions: per kv block of 128
    keys, its start, its k block and ``(P, dS)``; and the scaled grouped
    queries and dO."""
    b, sq, skv, hq, hkv, d = _dims(q, k, v)
    wt = _work_dtype(q)
    block_k = min(128, skv)
    qg = _grouped(q, hkv, wt) * _scale(d, scale)
    dog = _grouped(do, hkv, wt)
    g = hq // hkv
    lse_g = lse.to(wt).reshape(b, hkv, g, sq)
    delta_g = delta.to(wt).reshape(b, hkv, g, sq)
    qpos = _positions(sq, query_offset(q_offset), q.device)

    def blocks():
        for (start, kj), (_, vj) in zip(_kv_blocks(k, block_k, wt),
                                        _kv_blocks(v, block_k, wt)):
            kpos = torch.arange(start, start + block_k, device=q.device)
            yield start, kj, _block_grads(qg, dog, kj, vj, lse_g, delta_g, qpos,
                                          kpos, skv, causal, window)
    return qg, dog, blocks()


def bwd_dkdv_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                   window: Optional[int] = None, q_offset: int = 0,
                   scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """F3's ``dK = dS^T (scale * q)`` and ``dV = P^T dO``, kv block by kv
    block, summed over each kv head's group of q heads."""
    qg, dog, blocks = _bwd_blocks(q, k, v, do, lse, delta, causal, window,
                                  q_offset, scale)
    dks, dvs = [], []
    for _, _, (p, ds) in blocks:
        dvs.append(torch.einsum("bhgqk,bhgqd->bkhd", p, dog))
        dks.append(torch.einsum("bhgqk,bhgqd->bkhd", ds, qg))
    skv = k.shape[1]
    return (torch.cat(dks, 1)[:, :skv].to(k.dtype),
            torch.cat(dvs, 1)[:, :skv].to(v.dtype))


def bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                 window: Optional[int] = None, q_offset: int = 0,
                 scale: Optional[float] = None) -> torch.Tensor:
    """F4's ``dQ = scale * dS K``, accumulated over kv blocks."""
    qg, _, blocks = _bwd_blocks(q, k, v, do, lse, delta, causal, window,
                                q_offset, scale)
    dq = torch.zeros_like(qg)
    for _, kj, (_, ds) in blocks:
        dq = dq + torch.einsum("bhgqk,bhkd->bhgqd", ds, kj)
    b, sq, hq, d = q.shape
    dq = dq * _scale(d, scale)
    return dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: Optional[int] = None, q_offset: int = 0,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dQ, dK, dV)`` from the explicit formulas (not autograd), as F2-F4
    compute them."""
    opts = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
    delta = bwd_preprocess_plain(o, do)
    dk, dv = bwd_dkdv_plain(q, k, v, do, lse, delta, **opts)
    dq = bwd_dq_plain(q, k, v, do, lse, delta, **opts)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------

_PTR, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# batch, sq, skv, hq, hkv, head_dim, causal, window; scale; bf16, q_offset
_DIMS = [_INT] * 8 + [_F32, _INT, _INT]
_SIGNATURES = {
    "flash_attention_fwd": [_PTR] * 5 + _DIMS,
    "flash_attention_bwd_preprocess": [_PTR] * 3 + [_INT] * 5,
    "flash_attention_bwd_dkdv": [_PTR] * 8 + _DIMS,
    "flash_attention_bwd_dq": [_PTR] * 7 + _DIMS,
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
    lib = build.load("flash_attention")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes + [_PTR]   # then the stream
        fn.restype = ctypes.c_int
    lib.flash_attention_launch_config.argtypes = [_INT, _INT, _INT, _PTR]
    lib.flash_attention_launch_config.restype = ctypes.c_int
    return lib


def blocks_per_sm(kernel: str, head_dim: int, dtype: torch.dtype) -> int:
    """Blocks of F1, F2, F3 or F4 (by kernel name) that fit on one SM of
    the current card at ``head_dim`` and ``dtype``, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` reports: the last of
    the seven ints of the ``flash_attention_launch_config`` query."""
    which = list(_SIGNATURES).index(kernel)   # the query's F1-F4 order
    out = (ctypes.c_int * 7)()
    err = _lib().flash_attention_launch_config(
        which, head_dim, int(dtype == torch.bfloat16), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"occupancy of {kernel} failed: cudaError {err}")
    return out[6]


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
    raise ValueError(f"no flash attention kernel for device {device}")


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


def _kernel_args(q, k, v, causal: bool, window: Optional[int], q_offset: int = 0,
                 scale: Optional[float] = None):
    """Check what the CUDA kernels take and return their dimension
    arguments but the query offset, which the kernels take last; raise on
    anything else."""
    b, sq, skv, hq, hkv, d = _dims(q, k, v)
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the kernels take f32 or bf16 q, k, v of one dtype; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported; the kernels take {HEAD_DIMS}")
    if sq < 1 or skv < 1 or max(b, hq) > 65535:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}: need Sq, Skv >= 1 "
                         "and batch, heads <= 65535")
    if window is not None and not 1 <= window < 2 ** 31:
        raise ValueError(f"window must be a positive int, got {window}")
    # a query row that would see no key: the kernels skip masked tiles,
    # which matches B4 only where every row sees one
    if not (-2 ** 31 < q_offset and q_offset + sq < 2 ** 31):
        raise ValueError(f"q_offset {q_offset} out of the kernels' range")
    if window is not None and q_offset + sq > skv + window - 1:
        raise ValueError(f"q_offset {q_offset} + Sq {sq} > Skv {skv} + window "
                         f"{window} - 1: rows that see no key")
    if causal and q_offset < 0:
        raise ValueError(f"causal with q_offset {q_offset} < 0: rows that see "
                         "no key")
    if max(q.numel(), k.numel()) >= 2 ** 62:
        raise ValueError("tensor too large")
    return [b, sq, skv, hq, hkv, d, int(causal), window or 0,
            _scale(d, scale), int(q.dtype == torch.bfloat16)]


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(O, lse)`` through F1 on a CUDA tensor, the plain version on the CPU."""
    q_offset = query_offset(q_offset)
    if not _route(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale)
    args = _kernel_args(q, k, v, causal, window, q_offset, scale)
    q, k, v = build.on_16_bytes(q, k, v)
    o = torch.empty_like(q)
    b, sq, hq = q.shape[0], q.shape[1], q.shape[2]
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr(), *args, q_offset)
    return o, lse


def bwd_preprocess(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)``, f32 ``(B, Hq, Sq)``, through F2 on a CUDA
    tensor, the plain version on the CPU."""
    if not _route(o, do):
        return bwd_preprocess_plain(o, do)
    if o.dim() != 4 or do.shape != o.shape or do.dtype != o.dtype \
            or o.dtype not in DTYPES or o.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"O and dO must be one (B, Sq, Hq, D) shape and f32 or "
                         f"bf16 dtype with D in {HEAD_DIMS}; got {tuple(o.shape)} "
                         f"{o.dtype}, {tuple(do.shape)} {do.dtype}")
    o, do = o.contiguous(), do.contiguous()
    b, sq, hq, d = o.shape
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=o.device)
    if delta.numel():
        _launch("flash_attention_bwd_preprocess", o.device, o.data_ptr(),
                do.data_ptr(), delta.data_ptr(), b, sq, hq, d,
                int(o.dtype == torch.bfloat16))
    return delta


def _bwd_inputs(q, k, v, do, lse, delta, causal, window, q_offset=0, scale=None):
    """Check the backward kernels' inputs; their dimension arguments and
    the inputs made contiguous."""
    args = _kernel_args(q, k, v, causal, window, q_offset, scale)
    b, sq, hq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO must be {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, hq, sq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 {(b, hq, sq)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    return args, build.on_16_bytes(q, k, v, do, lse, delta)


def bwd_dkdv(q, k, v, do, lse, delta, *, causal: bool = True,
             window: Optional[int] = None, q_offset: int = 0,
             scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` through F3 on a CUDA tensor, the plain version on the
    CPU."""
    q_offset = query_offset(q_offset)
    if not _route(q, k, v, do, lse, delta):
        return bwd_dkdv_plain(q, k, v, do, lse, delta, causal=causal,
                              window=window, q_offset=q_offset, scale=scale)
    args, ins = _bwd_inputs(q, k, v, do, lse, delta, causal, window, q_offset,
                            scale)
    dk, dv = torch.empty_like(ins[1]), torch.empty_like(ins[2])
    _launch("flash_attention_bwd_dkdv", q.device, *(t.data_ptr() for t in ins),
            dk.data_ptr(), dv.data_ptr(), *args, q_offset)
    return dk, dv


def bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
           window: Optional[int] = None, q_offset: int = 0,
           scale: Optional[float] = None) -> torch.Tensor:
    """``dQ`` through F4 on a CUDA tensor, the plain version on the CPU."""
    q_offset = query_offset(q_offset)
    if not _route(q, k, v, do, lse, delta):
        return bwd_dq_plain(q, k, v, do, lse, delta, causal=causal,
                            window=window, q_offset=q_offset, scale=scale)
    args, ins = _bwd_inputs(q, k, v, do, lse, delta, causal, window, q_offset,
                            scale)
    dq = torch.empty_like(ins[0])
    _launch("flash_attention_bwd_dq", q.device, *(t.data_ptr() for t in ins),
            dq.data_ptr(), *args, q_offset)
    return dq


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dQ, dK, dV)`` through F2, F3 and F4 on a CUDA tensor, the plain
    versions on the CPU."""
    opts = dict(causal=causal, window=window, q_offset=query_offset(q_offset),
                scale=scale)
    if not _route(q, k, v, o, lse, do):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, **opts)
    if o.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"O must be {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(o.shape)} {o.dtype}")
    delta = bwd_preprocess(o, do)
    dk, dv = bwd_dkdv(q, k, v, do, lse, delta, **opts)
    dq = bwd_dq(q, k, v, do, lse, delta, **opts)
    return dq, dk, dv


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int], q_offset: int, scale: Optional[float] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_fwd` as one operator: a dispatch mode sees the
    call once (``OpCostModel`` prices it), and a fake tensor takes its
    shapes alone."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, scale=scale)


@_fwd_op.register_fake
def _(q, k, v, causal, window, q_offset, scale=None):
    b, sq, hq = q.shape[0], q.shape[1], q.shape[2]
    return torch.empty_like(q), q.new_empty((b, hq, sq), dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
            lse: torch.Tensor, do: torch.Tensor, causal: bool,
            window: Optional[int], q_offset: int, scale: Optional[float] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_bwd` as one operator (as :func:`_fwd_op`)."""
    return flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window,
                               q_offset=q_offset, scale=scale)


@_bwd_op.register_fake
def _(q, k, v, o, lse, do, causal, window, q_offset, scale=None):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


class _FlashAttention(torch.autograd.Function):
    """Saves ``q, k, v, O`` and ``lse``, nothing larger."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale=None):
        _route(q, k, v)     # raises for a device without a route (meta too)
        o, lse = _fwd_op(q, k, v, causal, window, q_offset, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (causal, window, q_offset, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd_op(q, k, v, o, lse, do, *ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset=0,
                    placements=None, scale: Optional[float] = None) -> torch.Tensor:
    """Attention of ``q (B, Sq, Hq, D)`` over ``k, v (B, Skv, Hkv, D)``, in
    ``q``'s dtype, differentiable in ``q``, ``k`` and ``v``, query row ``i``
    at position ``i + q_offset``. Replaces ``flash_attention_pallas``, with a
    backward of its own. ``q_offset`` is an int or a 0-d integer tensor (the
    reference's ``int | jax.Array``), read once, on the host: a CUDA tensor
    is synchronized with. ``scale`` multiplies the scores (``1/sqrt(D)``
    if None). DTensors run shard by shard: q, k and v
    redistributed to ``placements`` (one a mesh dim, which the caller
    chooses: the sequence whole on every device), then each shard's local
    tensors through :class:`_FlashAttention`."""
    q_offset = query_offset(q_offset)
    if placements is None:
        return _FlashAttention.apply(q, k, v, causal, window, q_offset, scale)
    from torch.distributed.tensor.experimental import local_map

    return local_map(
        lambda q, k, v: _FlashAttention.apply(q, k, v, causal, window, q_offset,
                                              scale),
        out_placements=placements,
        in_placements=(placements, placements, placements),
        device_mesh=q.device_mesh, redistribute_inputs=True)(q, k, v)
