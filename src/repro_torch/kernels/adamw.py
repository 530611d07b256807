"""AdamW's update of one leaf in one pass (no counterpart in the JAX
package, whose AdamW is array arithmetic that XLA fuses).

For a parameter p, its gradient g and the f32 moments m, v, with the bias
corrections ``bc1 = 1 - b1^t`` and ``bc2 = 1 - b2^t`` (0-d f32 tensors)::

    m' = b1 m + (1 - b1) g
    v' = b2 v + (1 - b2) g g
    p' = p - lr ((m' / bc1) / (sqrt(v' / bc2) + eps) + wd p)

:func:`adamw_leaf_plain` is the plain PyTorch version, sixteen elementwise
ops (152 bytes a parameter through device memory at f32); ``csrc/adamw.cu``
reads p, g, m and v once and writes p', m' and v' once (28 bytes at f32, 22
with bf16 p and g), with the same roundings in the same order, so the two
agree bit for bit.

:func:`adamw_leaf` checks its inputs: p and g f32 or bf16, m and v f32, all
four one shape, contiguous and on one device with the 0-d f32 bc1 and bc2.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises; any other device raises. It is one operator,
``repro_torch::adamw_leaf``, so that a profiler records its shapes and a
fake tensor takes its shapes alone; a DTensor leaf goes shard by shard
(``local_map``). Every launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.dist.sharding import is_dtensor, like, on_shards
from repro_torch.kernels import build

# what the kernel takes for p and g (m and v are f32)
DTYPES = (torch.float32, torch.bfloat16)

# p, g, m, v, bc1, bc2, p', m', v'; n; p bf16, g bf16; lr, b1, 1 - b1, b2,
# 1 - b2, eps, weight decay
_SIGNATURES = {"adamw_leaf": [ctypes.c_void_p] * 9 + [ctypes.c_int64]
               + [ctypes.c_int] * 2 + [ctypes.c_float] * 7}
LIB = build.Library("adamw", _SIGNATURES)
# launches of the CUDA kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = LIB.launches
reset_launches = LIB.reset


def adamw_leaf_plain(p, g, m, v, bc1, bc2, *, lr: float, b1: float,
                     b2: float, eps: float, weight_decay: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(p', m', v')`` in separate torch ops, p' in p's dtype."""
    g = g.float()
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mh = m / bc1
    vh = v / bc2
    delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), m, v


def _check(p, g, m, v, bc1, bc2) -> None:
    """Raise on anything the kernel does not take."""
    ts = (p, g, m, v, bc1, bc2)
    if any(t.device != p.device for t in ts):
        raise ValueError(f"tensors on several devices: "
                         f"{sorted({str(t.device) for t in ts})}")
    if p.dtype not in DTYPES or g.dtype not in DTYPES:
        raise TypeError(f"p and g must be f32 or bf16; got {p.dtype}, {g.dtype}")
    if any(t.dtype != torch.float32 for t in (m, v, bc1, bc2)):
        raise TypeError(f"m, v, bc1 and bc2 must be f32; got "
                        f"{[t.dtype for t in (m, v, bc1, bc2)]}")
    if any(t.shape != p.shape for t in (g, m, v)):
        raise ValueError(f"p, g, m and v must be one shape; got "
                         f"{[tuple(t.shape) for t in (p, g, m, v)]}")
    if bc1.dim() or bc2.dim():
        raise ValueError(f"bc1 and bc2 must be 0-d; got {tuple(bc1.shape)}, "
                         f"{tuple(bc2.shape)}")
    if not all(t.is_contiguous() for t in (p, g, m, v)):
        raise ValueError("p, g, m and v must be contiguous")


def _kernel(p, g, m, v, bc1, bc2, *, lr, b1, b2, eps, weight_decay):
    """``(p', m', v')`` through ``csrc/adamw.cu``, on p's current stream. The
    scalars pass as f32, rounded as torch rounds a Python scalar operand."""
    outs = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in (p, m, v))
    if p.numel() == 0:
        return outs
    LIB.launch("adamw_leaf", p.device,
               *(t.data_ptr() for t in (p, g, m, v, bc1, bc2) + outs), p.numel(),
               int(p.dtype == torch.bfloat16), int(g.dtype == torch.bfloat16),
               lr, b1, 1 - b1, b2, 1 - b2, eps, weight_decay)
    return outs


@torch.library.custom_op("repro_torch::adamw_leaf", mutates_args=())
def _leaf_op(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
             v: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor, lr: float,
             b1: float, b2: float, eps: float, weight_decay: float
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One leaf's update as one operator: the plain version on the CPU, the
    kernel on a CUDA tensor."""
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if build.route("AdamW", p):
        return _kernel(p, g, m, v, bc1, bc2, **hyper)
    return adamw_leaf_plain(p, g, m, v, bc1, bc2, **hyper)


@_leaf_op.register_fake
def _(p, g, m, v, bc1, bc2, lr, b1, b2, eps, weight_decay):
    return torch.empty_like(p), torch.empty_like(m), torch.empty_like(v)


def adamw_leaf(p, g, m, v, bc1, bc2, *, lr: float, b1: float, b2: float,
               eps: float, weight_decay: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(p', m', v')`` of one leaf; new tensors, the inputs unchanged. A
    DTensor leaf is updated shard by shard, each shard laid out as p (bc1
    and bc2 replicated)."""
    if not is_dtensor(p):
        _check(p, g, m, v, bc1, bc2)
        return _leaf_op(p, g, m, v, bc1, bc2, lr, b1, b2, eps, weight_decay)
    from torch.distributed.tensor import Replicate

    def local(*ts):
        ts = [t.contiguous() for t in ts]
        _check(*ts)
        return _leaf_op(*ts, lr, b1, b2, eps, weight_decay)

    mesh, pp = p.device_mesh, list(p.placements)
    whole = [Replicate()] * mesh.ndim
    return on_shards(local, mesh, (pp, pp, pp), (pp, pp, pp, pp, whole, whole))(
        p, g, m, v, *(b if is_dtensor(b) else like(p, b) for b in (bc1, bc2)))
