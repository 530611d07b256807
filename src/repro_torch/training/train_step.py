"""The explicit data-parallel ring train step (the counterpart of
``repro.training.train_step.make_ring_train_step``).

The reference runs one ``shard_map`` program over w devices. Here one
process drives the w ranks of a :class:`~repro_torch.dist.collectives.LocalRing`:

  1. the global batch splits into w contiguous row blocks, as ``P("data")``
     shards it;
  2. each rank takes its loss and gradients with ``torch.autograd.grad``;
  3. each gradient leaf is reduced across the ranks by the mode's ring and
     divided by w; the loss is the mean of the rank losses, as ``pmean``;
  4. the optimizer runs once per distinct device of the ring, on that
     device's replica (once on one card).

Parameters and optimizer state are *replicated*: a dict mapping each
distinct device of the ring to its own tree.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.dist.collectives import LocalRing, ring_all_reduce
from repro_torch.dist.compression import compressed_ring_all_reduce
from repro_torch.models.module import _flatten, _unflatten
from repro_torch.training.optimizer import Optimizer

Replicas = Dict[torch.device, dict]

# mode -> gradient collective; every mode make_ring_train_step accepts
RING_STEP_MODES: Dict[str, Callable] = {
    "ring": ring_all_reduce,
    "compressed-fused": partial(compressed_ring_all_reduce, fused=True),
}
# wire payload dtype of each mode (part of the ring-program cache key)
WIRE_DTYPES = {"ring": "float32", "compressed-fused": "int8"}


def check_mode(mode: str) -> None:
    if mode not in RING_STEP_MODES:
        raise NotImplementedError(
            f"ring mode {mode!r} is not ported yet; ported modes: "
            f"{tuple(RING_STEP_MODES)}")


def distinct_devices(devices: Sequence[torch.device]) -> List[torch.device]:
    """The ring's devices, each once, in rank order."""
    return list(dict.fromkeys(devices))


def shard_batch(batch: Dict[str, torch.Tensor], devices: Sequence[torch.device]
                ) -> List[Dict[str, torch.Tensor]]:
    """Split a global batch into ``len(devices)`` contiguous row blocks,
    block r on ``devices[r]``."""
    w = len(devices)
    rows = next(iter(batch.values())).shape[0]
    if rows % w:
        raise ValueError(f"global batch {rows} does not split over {w} ranks")
    per = rows // w
    return [{k: torch.as_tensor(v)[r * per:(r + 1) * per].to(devices[r])
             for k, v in batch.items()} for r in range(w)]


def rank_grads(model, params: Replicas, shards, devices
               ) -> Tuple[List[torch.Tensor], List[Dict[str, torch.Tensor]]]:
    """Each rank's loss and flat ``{path: grad}`` on its own batch shard."""
    leaves = {}
    for d in distinct_devices(devices):
        leaves[d] = {p: v.detach().requires_grad_(True)
                     for p, v in _flatten(params[d])}
    losses, grads = [], []
    for shard, d in zip(shards, devices):
        tree = _unflatten(leaves[d])
        loss = model.loss(tree, shard)
        g = torch.autograd.grad(loss, list(leaves[d].values()))
        losses.append(loss.detach())
        grads.append(dict(zip(leaves[d], g)))
    return losses, grads


def reduce_grads(grads: List[Dict[str, torch.Tensor]], ring: LocalRing,
                 mode: str) -> List[Dict[str, torch.Tensor]]:
    """Reduce every leaf across the ranks with the mode's ring, divided by
    w. Each rank's input leaf is dropped once reduced."""
    check_mode(mode)
    collective = RING_STEP_MODES[mode]
    w = ring.size
    out: List[Dict[str, torch.Tensor]] = [{} for _ in range(w)]
    for path in list(grads[0]):
        reduced = collective([g.pop(path) for g in grads], ring)
        for r in range(w):
            out[r][path] = reduced[r] / w
    return out


def make_ring_train_step(model, optimizer: Optimizer, ring: LocalRing, *,
                         lr: float = 3e-4, mode: str = "ring") -> Callable:
    """Build ``step(params, opt_state, shards) -> (params, opt_state,
    metrics)`` over ``ring``. ``params``/``opt_state`` are replicas (one
    tree per distinct device), ``shards`` the per-rank batch blocks of
    :func:`shard_batch`. Modes: ``"ring"`` (the paper's f32 ring) and
    ``"compressed-fused"`` (the fused int8 ring)."""
    check_mode(mode)
    devices = ring.devices

    def step(params: Replicas, opt_state: Replicas, shards):
        losses, grads = rank_grads(model, params, shards, devices)
        reduced = reduce_grads(grads, ring, mode)
        home = devices[0]
        loss = torch.stack([l.to(home) for l in losses]).mean()
        new_params, new_opt = {}, {}
        for d in distinct_devices(devices):
            g = _unflatten(reduced[devices.index(d)])
            new_params[d], new_opt[d] = optimizer.update(
                g, opt_state[d], params[d], lr=lr)
        return new_params, new_opt, {"loss": loss}

    return step
