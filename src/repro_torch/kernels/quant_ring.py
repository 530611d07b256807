"""The fused ring's hop kernels (the counterpart of
``repro.kernels.quant_ring``).

Quantized wires (int8, and fp8 e4m3 in ``torch.float8_e4m3fn``), three
functions on ``(n_blocks, block)`` arrays, one f32 scale per sub-block row:

  * :func:`quantize_pack` — per row ``amax``, ``scale = amax / qmax`` (1.0
    for an all-zero row) and the payload ``clip(x / scale, +-qmax)``: int8
    rounds half to even first (qmax 127), fp8 lets the cast round (qmax
    448);
  * :func:`dequant_add_quantize` — the steady Share-Reduce hop
    ``Q(acc + q * scale)`` in one pass, in the wire dtype of ``q``;
  * :func:`dequant_accumulate` — the receive side ``acc + q * scale`` in
    f32, or the plain ``q * scale`` with ``acc=None``;
  * :func:`dequant_gather` — the Share-Only gather's ``q * scale`` over w
    messages where they lie, each written to its chunk's place.

The two quantizing functions take ``out=(payload, scales)``, the tensors to
write, so that the ring hands them the two parts of one wire message.

The bf16 wire carries no scales (bf16 keeps f32's exponent):

  * :func:`cast_pack_bf16` — ``bf16(x)``, rounding to nearest even;
  * :func:`bf16_add_cast` — the Share-Reduce hop ``bf16(acc + f32(recv))``;
  * :func:`bf16_accumulate` — ``acc + f32(recv)``, or the upcast alone.

Each is a wrapper over a hand-written CUDA kernel in
``csrc/quant_ring.cu``. A tensor on the CPU takes the function's plain
PyTorch version (``*_plain`` below, the same arithmetic in separate torch
ops); a CUDA tensor launches the kernel or raises, and any other device
raises. Every launch adds one to its kernel's entry in :data:`LAUNCHES`;
the fp8 instantiations count under names of their own (``*_fp8``). The
kernels and the plain versions agree bit for bit: both divide with
correct rounding, round to nearest even and never fuse a multiply and an
add.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

QMAX = 127.0      # symmetric int8 range
FP8_MAX = 448.0   # float8_e4m3fn finfo max (no inf: overflow saturates here)
FP8_DTYPE = torch.float8_e4m3fn
# the quantized wire payload dtypes the kernels take
WIRE_DTYPES = (torch.int8, FP8_DTYPE)


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

    A hop message is ``[1-byte payload: n_blocks * block][trailer: n_blocks
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

def quantize_pack_plain(x: torch.Tensor, wire_dtype=torch.int8
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row amax scale + quantized payload of a 2-D f32 tensor."""
    qmax = wire_qmax(wire_dtype)
    amax = x.abs().amax(dim=1)
    # divide by a tensor: CUDA torch turns a division by a Python scalar
    # into a multiply by its reciprocal, whose bits differ
    scale = torch.where(amax > 0, amax / torch.full_like(amax, qmax),
                        torch.ones_like(amax))
    v = x / scale[:, None]
    if wire_dtype == torch.int8:
        v = torch.round(v)
    return v.clamp_(-qmax, qmax).to(wire_dtype), scale


def dequant_add_quantize_plain(q: torch.Tensor, scales: torch.Tensor,
                               acc: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    return quantize_pack_plain(acc + q.float() * scales[:, None], q.dtype)


def dequant_accumulate_plain(q: torch.Tensor, scales: torch.Tensor,
                             acc: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    out = q.float() * scales[:, None]
    return out if acc is None else acc + out


def dequant_gather_plain(q: torch.Tensor, scales: torch.Tensor,
                         first: int) -> torch.Tensor:
    w = q.shape[0]
    return (q.float() * scales[:, :, None])[[(first - c) % w for c in range(w)]]


def cast_pack_bf16_plain(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def bf16_add_cast_plain(recv: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    return (acc + recv.float()).to(torch.bfloat16)


def bf16_accumulate_plain(recv: torch.Tensor,
                          acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    out = recv.float()
    return out if acc is None else acc + out


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------

# the C entry point of each kernel (``quant_ring_<name>``) and its pointer
# and size arguments before the stream
_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "quantize_pack": [_PTR, _PTR, _PTR, _I64, _I64],
    "dequant_add_quantize": [_PTR, _PTR, _PTR, _PTR, _PTR, _I64, _I64],
    "dequant_accumulate": [_PTR, _PTR, _PTR, _PTR, _I64, _I64],
    "dequant": [_PTR, _I64, _PTR, _I64, _PTR, _I64, _I64, _I64, _I64],
}
_SIGNATURES.update({f"{name}_fp8": args for name, args in _SIGNATURES.items()})
_SIGNATURES.update({
    "cast_pack_bf16": [_PTR, _PTR, _I64],
    "bf16_add_cast": [_PTR, _PTR, _PTR, _I64],
    "bf16_accumulate": [_PTR, _PTR, _PTR, _I64],
    "bf16_upcast": [_PTR, _PTR, _I64],
})

LIB = build.Library("quant_ring", _SIGNATURES, prefix="quant_ring_")
# launches of each CUDA kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = LIB.launches
reset_launches = LIB.reset


def _check(t: torch.Tensor, name: str, dtype, shape: Tuple[int, ...],
           device: torch.device) -> None:
    """Raise unless ``t`` has ``dtype`` (one dtype, or a tuple of the
    dtypes allowed), ``shape`` and ``device``, and is contiguous."""
    allowed = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in allowed:
        raise TypeError(f"{name} must be {' or '.join(map(str, allowed))}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _kernel_name(base: str, wire_dtype) -> str:
    """The launch-counter name of a quantized kernel's instantiation."""
    return base if wire_dtype == torch.int8 else f"{base}_fp8"


def _rows(x: torch.Tensor, name: str) -> Tuple[int, int]:
    if x.dim() != 2:
        raise ValueError(f"{name} must be 2-D (n_blocks, block), got {tuple(x.shape)}")
    nb, block = x.shape
    if nb >= 2 ** 31:
        raise ValueError(f"{name} has {nb} rows; the kernels take < 2**31")
    return nb, block


Parts = Tuple[torch.Tensor, torch.Tensor]


def _outputs(out: Optional[Parts], nb: int, block: int, wire_dtype,
             device: torch.device) -> Parts:
    """The ``(payload, scales)`` a quantizing kernel writes: ``out``, checked,
    or two new tensors."""
    if out is None:
        return (torch.empty((nb, block), dtype=wire_dtype, device=device),
                torch.empty((nb,), dtype=torch.float32, device=device))
    q, scales = out
    _check(q, "out payload", wire_dtype, (nb, block), device)
    _check(scales, "out scales", torch.float32, (nb,), device)
    return q, scales


def _filled(out: Parts, got: Parts) -> Parts:
    """A plain version's result, written into ``out``."""
    for o, g in zip(out, got):
        o.copy_(g)
    return out


def quantize_pack(x: torch.Tensor, wire_dtype=torch.int8, *,
                  out: Optional[Parts] = None) -> Parts:
    """Blockwise quantization of a ``(n_blocks, block)`` f32 tensor.

    Returns ``(q, scales)``: ``q`` of ``x``'s shape in ``wire_dtype`` (int8
    or float8_e4m3fn) and f32 ``scales`` of shape ``(n_blocks,)``,
    ``scales[i] = max|x[i]| / qmax`` (1.0 for an all-zero row), written into
    ``out`` where it is given (contiguous tensors of those dtypes and
    shapes). Replaces ``quantize_pack_pallas``.
    """
    wire_qmax(wire_dtype)
    nb, block = _rows(x, "x")
    _check(x, "x", torch.float32, (nb, block), x.device)
    q, scales = _outputs(out, nb, block, wire_dtype, x.device)
    if not build.route("quant-ring", x):
        return _filled((q, scales), quantize_pack_plain(x, wire_dtype))
    if x.numel():
        LIB.launch(_kernel_name("quantize_pack", wire_dtype), x.device,
                   x.data_ptr(), q.data_ptr(), scales.data_ptr(), nb, block)
    return q, scales


def dequant_add_quantize(q: torch.Tensor, scales: torch.Tensor,
                         acc: torch.Tensor, *,
                         out: Optional[Parts] = None) -> Parts:
    """The Share-Reduce hop ``Q(acc + q * scales)`` in one pass: ``q``
    (int8 or float8_e4m3fn; the output keeps its dtype) and f32 ``acc`` of
    shape ``(n_blocks, block)``, f32 ``scales`` of shape ``(n_blocks,)``.
    Returns ``(q', scales')`` for the next hop, written into ``out`` where
    it is given. Replaces ``dequant_add_quantize_pallas``."""
    nb, block = _rows(q, "q")
    _check(q, "q", WIRE_DTYPES, (nb, block), q.device)
    _check(scales, "scales", torch.float32, (nb,), q.device)
    _check(acc, "acc", torch.float32, (nb, block), q.device)
    q_out, s_out = _outputs(out, nb, block, q.dtype, q.device)
    if not build.route("quant-ring", q):
        return _filled((q_out, s_out), dequant_add_quantize_plain(q, scales, acc))
    if q.numel():
        LIB.launch(_kernel_name("dequant_add_quantize", q.dtype), q.device,
                   q.data_ptr(), scales.data_ptr(), acc.data_ptr(),
                   q_out.data_ptr(), s_out.data_ptr(), nb, block)
    return q_out, s_out


def dequant_accumulate(q: torch.Tensor, scales: torch.Tensor,
                       acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``acc + q * scales`` in f32 for an int8 or float8_e4m3fn
    ``(n_blocks, block)`` payload; with ``acc=None`` the plain
    dequantization ``q * scales``. Replaces ``dequant_accumulate_pallas``
    (two CUDA kernels per payload dtype, one per form)."""
    nb, block = _rows(q, "q")
    _check(q, "q", WIRE_DTYPES, (nb, block), q.device)
    _check(scales, "scales", torch.float32, (nb,), q.device)
    if acc is not None:
        _check(acc, "acc", torch.float32, (nb, block), q.device)
    if not build.route("quant-ring", q):
        return dequant_accumulate_plain(q, scales, acc)
    out = torch.empty((nb, block), dtype=torch.float32, device=q.device)
    if not q.numel():
        return out
    if acc is None:
        LIB.launch(_kernel_name("dequant", q.dtype), q.device, q.data_ptr(),
                   nb * block, scales.data_ptr(), nb, out.data_ptr(), 1, nb,
                   block, 0)
    else:
        LIB.launch(_kernel_name("dequant_accumulate", q.dtype), q.device,
                   q.data_ptr(), scales.data_ptr(), acc.data_ptr(),
                   out.data_ptr(), nb, block)
    return out


def dequant_gather(q: torch.Tensor, scales: torch.Tensor,
                   first: int) -> torch.Tensor:
    """The Share-Only gather's dequantization, one launch for all its
    messages where they landed: ``q`` a ``(w, n_blocks, block)`` int8 or
    float8_e4m3fn payload and ``scales`` its ``(w, n_blocks)`` f32 scales,
    each contiguous within a message and any number of elements from one
    message to the next (the rows of one gather buffer, each message's
    scales its own trailer). Message r holds chunk ``(first - r) mod w``;
    returns the f32 ``(w, n_blocks, block)`` sum in chunk order, ``out[(first
    - r) % w] = q[r] * scales[r]``. The kernel is ``dequant_accumulate``'s
    with ``acc=None``, which is w = 1."""
    if q.dim() != 3:
        raise ValueError(f"q must be 3-D (w, n_blocks, block), got {tuple(q.shape)}")
    w, nb, block = q.shape
    if w * nb >= 2 ** 31:
        raise ValueError(f"q has {w * nb} sub-blocks; the kernel takes < 2**31")
    if not 0 <= first < w:
        raise ValueError(f"first must lie in [0, {w}), got {first}")
    if q.dtype not in WIRE_DTYPES:
        raise TypeError(f"q must be int8 or {FP8_DTYPE}, got {q.dtype}")
    if scales.dtype != torch.float32 or tuple(scales.shape) != (w, nb):
        raise ValueError(f"scales must be f32 of shape {(w, nb)}, got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if scales.device != q.device:
        raise ValueError(f"scales is on {scales.device}, expected {q.device}")
    if w and not (q[0].is_contiguous() and scales[0].is_contiguous()):
        raise ValueError("each message of q and scales must be contiguous")
    if not build.route("quant-ring", q):
        return dequant_gather_plain(q, scales, first)
    out = torch.empty((w, nb, block), dtype=torch.float32, device=q.device)
    if q.numel():
        LIB.launch(_kernel_name("dequant", q.dtype), q.device, q.data_ptr(),
                   q.stride(0), scales.data_ptr(), scales.stride(0),
                   out.data_ptr(), w, nb, block, first)
    return out


def cast_pack_bf16(x: torch.Tensor) -> torch.Tensor:
    """bf16 wire payload of a ``(n_blocks, block)`` f32 tensor, rounding to
    nearest even. Replaces ``cast_pack_bf16_pallas``."""
    nb, block = _rows(x, "x")
    _check(x, "x", torch.float32, (nb, block), x.device)
    if not build.route("quant-ring", x):
        return cast_pack_bf16_plain(x)
    out = torch.empty((nb, block), dtype=torch.bfloat16, device=x.device)
    if x.numel():
        LIB.launch("cast_pack_bf16", x.device, x.data_ptr(), out.data_ptr(),
                   x.numel())
    return out


def bf16_add_cast(recv: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """The bf16 ring's Share-Reduce hop ``bf16(acc + f32(recv))``: bf16
    ``recv`` and f32 ``acc`` of shape ``(n_blocks, block)``. Replaces
    ``bf16_add_cast_pallas``."""
    nb, block = _rows(recv, "recv")
    _check(recv, "recv", torch.bfloat16, (nb, block), recv.device)
    _check(acc, "acc", torch.float32, (nb, block), recv.device)
    if not build.route("quant-ring", recv):
        return bf16_add_cast_plain(recv, acc)
    out = torch.empty((nb, block), dtype=torch.bfloat16, device=recv.device)
    if recv.numel():
        LIB.launch("bf16_add_cast", recv.device, recv.data_ptr(), acc.data_ptr(),
                   out.data_ptr(), recv.numel())
    return out


def bf16_accumulate(recv: torch.Tensor,
                    acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``acc + f32(recv)`` for a bf16 ``(n_blocks, block)`` payload; with
    ``acc=None`` the upcast alone. Replaces ``bf16_accumulate_pallas`` (two
    CUDA kernels, one per form)."""
    nb, block = _rows(recv, "recv")
    _check(recv, "recv", torch.bfloat16, (nb, block), recv.device)
    if acc is not None:
        _check(acc, "acc", torch.float32, (nb, block), recv.device)
    if not build.route("quant-ring", recv):
        return bf16_accumulate_plain(recv, acc)
    out = torch.empty((nb, block), dtype=torch.float32, device=recv.device)
    if not recv.numel():
        return out
    if acc is None:
        LIB.launch("bf16_upcast", recv.device, recv.data_ptr(), out.data_ptr(),
                   recv.numel())
    else:
        LIB.launch("bf16_accumulate", recv.device, recv.data_ptr(),
                   acc.data_ptr(), out.data_ptr(), recv.numel())
    return out
