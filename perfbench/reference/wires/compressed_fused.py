"""The fused int8 wire (the ring mode ``compressed-fused``): every partial
sum sent as int8 with one f32 scale a sub-block of 4096 elements, each
received message added to the local chunk and requantized for the next
hop, and the finished chunk sent quantized once more."""

from typing import Sequence, Tuple

import torch

from perfbench.reference import common

WIRE = "int8"
BLOCK = 4096


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 of each row of a 2-D f32 tensor: ``scale = max|x| /
    127`` (1 for a row of zeros), the payload ``x / scale`` rounded half to
    even and clipped to +-127."""
    amax = x.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    return torch.round(x / scale[:, None]).clamp_(-127.0, 127.0), scale


def dequantize(q: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    return q[0] * q[1][:, None]


def all_reduce(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    return common.ring_walk(grads, quantize, dequantize, BLOCK)
