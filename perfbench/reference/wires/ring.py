"""The paper's f32 ring: every partial sum sent exactly, so each chunk's
sum is added in ring order."""

from typing import Sequence

import torch

from perfbench.reference import common

WIRE = "f32"


def all_reduce(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    return common.ring_walk(grads, lambda x: x, lambda m: m)
