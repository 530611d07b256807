"""The fused int8 ring's hop kernels (the counterpart of
``repro.kernels.quant_ring``).

Three functions on ``(n_blocks, block)`` arrays, one scale per sub-block
row:

  * :func:`quantize_pack` — per row ``amax``, ``scale = amax / 127`` (1.0
    for an all-zero row) and ``q = clip(round(x / scale), +-127)`` in int8;
  * :func:`dequant_add_quantize` — the steady Share-Reduce hop
    ``Q(acc + q * scale)`` in one pass;
  * :func:`dequant_accumulate` — the receive side ``acc + q * scale`` in
    f32, or the plain ``q * scale`` with ``acc=None``.

Each is a wrapper over a hand-written CUDA kernel in
``csrc/quant_ring.cu``. A tensor on the CPU takes the function's plain
PyTorch version (``*_plain`` below, the same arithmetic in separate torch
ops); a CUDA tensor launches the kernel or raises, and any other device
raises. Every launch adds one to its kernel's entry in :data:`LAUNCHES`.
The kernels and the plain versions agree bit for bit: both divide with
correct rounding, round half to even and never fuse a multiply and an add.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

QMAX = 127.0      # symmetric int8 range
FP8_MAX = 448.0   # float8_e4m3fn finfo max (no inf: overflow saturates here)
FP8_DTYPE = torch.float8_e4m3fn


def wire_qmax(wire_dtype) -> float:
    """Symmetric clip range of a quantized wire dtype (scale denominator)."""
    if wire_dtype == torch.int8:
        return QMAX
    if wire_dtype == FP8_DTYPE:
        return FP8_MAX
    raise ValueError(f"unsupported quantized wire dtype {wire_dtype}; "
                     "expected int8 or float8_e4m3fn")


# bytes each f32 scale occupies after the bitcast into the message trailer;
# the kernels own this constant (the trailer is *their* output layout) and
# repro_torch.dist.compression re-exports it for the wire accounting
SCALE_BYTES = 4


@dataclasses.dataclass(frozen=True)
class HopMessageLayout:
    """The fused ring's wire-message layout for one hop chunk.

    A hop message is ``[int8 payload: n_blocks * block][trailer: n_blocks
    scales, each bitcast to scale_bytes int8 bytes]`` — the layout
    ``pack_hop_message`` emits and ``unpack_hop_message`` inverts, and the
    one source the wire accounting derives message sizes from.
    """

    n_blocks: int
    block: int
    scale_bytes: int = SCALE_BYTES

    @property
    def payload_bytes(self) -> int:
        return self.n_blocks * self.block

    @property
    def trailer_bytes(self) -> int:
        return self.n_blocks * self.scale_bytes

    @property
    def message_bytes(self) -> int:
        return self.payload_bytes + self.trailer_bytes


def hop_message_layout(chunk_elems: int, *, block: int) -> HopMessageLayout:
    """Layout of one hop message for a ``chunk_elems``-element ring chunk.

    The chunk is padded up to whole ``block``-sized sub-blocks; the
    effective block never exceeds the chunk itself (tiny chunks quantize as
    one sub-block).
    """
    c = max(int(chunk_elems), 1)
    b = max(1, min(int(block), c))
    c_pad = -(-c // b) * b
    return HopMessageLayout(n_blocks=c_pad // b, block=b)


# ---------------------------------------------------------------------------
# plain PyTorch versions: the reference the kernels are held against
# ---------------------------------------------------------------------------

def quantize_pack_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row amax scale + int8 payload of a 2-D f32 tensor."""
    amax = x.abs().amax(dim=1)
    # divide by a tensor: CUDA torch turns a division by a Python scalar
    # into a multiply by its reciprocal, whose bits differ
    qmax = torch.full_like(amax, QMAX)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.round(x / scale[:, None]).clamp_(-QMAX, QMAX)
    return q.to(torch.int8), scale


def dequant_add_quantize_plain(q: torch.Tensor, scales: torch.Tensor,
                               acc: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    return quantize_pack_plain(acc + q.float() * scales[:, None])


def dequant_accumulate_plain(q: torch.Tensor, scales: torch.Tensor,
                             acc: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    out = q.float() * scales[:, None]
    return out if acc is None else acc + out


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------

# launches of each CUDA kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {"quantize_pack": 0, "dequant_add_quantize": 0,
                            "dequant_accumulate": 0, "dequant": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("quant_ring")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    signatures = {
        "quant_ring_quantize_pack": [ptr, ptr, ptr, i64, i64, ptr],
        "quant_ring_dequant_add_quantize": [ptr, ptr, ptr, ptr, ptr, i64, i64, ptr],
        "quant_ring_dequant_accumulate": [ptr, ptr, ptr, ptr, i64, i64, ptr],
        "quant_ring_dequant": [ptr, ptr, ptr, i64, i64, ptr],
    }
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: Tuple[int, ...], device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _route(device: torch.device) -> bool:
    """True for the CUDA kernel, False for the plain version on the CPU."""
    if device.type == "cpu":
        return False
    if device.type == "cuda":
        return True
    raise ValueError(f"no quant-ring kernel for device {device}")


def _launch(kernel: str, device: torch.device, *args) -> None:
    """Launch ``kernel`` on ``device``'s current stream; raise on error."""
    fn = getattr(_lib(), f"quant_ring_{kernel}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[kernel] += 1


def _rows(x: torch.Tensor, name: str) -> Tuple[int, int]:
    if x.dim() != 2:
        raise ValueError(f"{name} must be 2-D (n_blocks, block), got {tuple(x.shape)}")
    nb, block = x.shape
    if nb >= 2 ** 31:
        raise ValueError(f"{name} has {nb} rows; the kernels take < 2**31")
    return nb, block


def quantize_pack(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise int8 quantization of a ``(n_blocks, block)`` f32 tensor.

    Returns ``(q, scales)``: int8 ``q`` of ``x``'s shape and f32 ``scales``
    of shape ``(n_blocks,)``, ``scales[i] = max|x[i]| / 127`` (1.0 for an
    all-zero row). Replaces ``quantize_pack_pallas``.
    """
    nb, block = _rows(x, "x")
    _check(x, "x", torch.float32, (nb, block), x.device)
    if not _route(x.device):
        return quantize_pack_plain(x)
    q = torch.empty((nb, block), dtype=torch.int8, device=x.device)
    scales = torch.empty((nb,), dtype=torch.float32, device=x.device)
    if x.numel():
        _launch("quantize_pack", x.device, x.data_ptr(), q.data_ptr(),
                scales.data_ptr(), nb, block)
    return q, scales


def dequant_add_quantize(q: torch.Tensor, scales: torch.Tensor,
                         acc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Share-Reduce hop ``Q(acc + q * scales)`` in one pass: int8
    ``q`` and f32 ``acc`` of shape ``(n_blocks, block)``, f32 ``scales`` of
    shape ``(n_blocks,)``. Returns ``(q', scales')`` for the next hop.
    Replaces ``dequant_add_quantize_pallas``."""
    nb, block = _rows(q, "q")
    _check(q, "q", torch.int8, (nb, block), q.device)
    _check(scales, "scales", torch.float32, (nb,), q.device)
    _check(acc, "acc", torch.float32, (nb, block), q.device)
    if not _route(q.device):
        return dequant_add_quantize_plain(q, scales, acc)
    q_out = torch.empty((nb, block), dtype=torch.int8, device=q.device)
    s_out = torch.empty((nb,), dtype=torch.float32, device=q.device)
    if q.numel():
        _launch("dequant_add_quantize", q.device, q.data_ptr(),
                scales.data_ptr(), acc.data_ptr(), q_out.data_ptr(),
                s_out.data_ptr(), nb, block)
    return q_out, s_out


def dequant_accumulate(q: torch.Tensor, scales: torch.Tensor,
                       acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``acc + q * scales`` in f32 for an int8 ``(n_blocks, block)`` payload;
    with ``acc=None`` the plain dequantization ``q * scales``. Replaces
    ``dequant_accumulate_pallas`` (two CUDA kernels, one per form)."""
    nb, block = _rows(q, "q")
    _check(q, "q", torch.int8, (nb, block), q.device)
    _check(scales, "scales", torch.float32, (nb,), q.device)
    if acc is not None:
        _check(acc, "acc", torch.float32, (nb, block), q.device)
    if not _route(q.device):
        return dequant_accumulate_plain(q, scales, acc)
    out = torch.empty((nb, block), dtype=torch.float32, device=q.device)
    if not q.numel():
        return out
    if acc is None:
        _launch("dequant", q.device, q.data_ptr(), scales.data_ptr(),
                out.data_ptr(), nb, block)
    else:
        _launch("dequant_accumulate", q.device, q.data_ptr(),
                scales.data_ptr(), acc.data_ptr(), out.data_ptr(), nb, block)
    return out
