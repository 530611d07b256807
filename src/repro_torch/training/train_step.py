"""Train and serve step factories (the counterpart of
``repro.training.train_step``), in the reference's two distribution
flavours:

  * :func:`make_train_step`, the GSPMD path (the dry run's): the step runs
    on DTensors over a ``DeviceMesh`` and ``constrain`` hints steer their
    placements; gradients reduce through the collectives DTensor inserts;
  * :func:`make_ring_train_step`, the explicit data-parallel path: the
    reference runs one ``shard_map`` program over w devices. Here one
process drives the w ranks of a :class:`~repro_torch.dist.collectives.LocalRing`:

  1. the global batch splits into w contiguous row blocks, as ``P("data")``
     shards it;
  2. each rank takes its loss and gradients with ``torch.autograd.grad``;
  3. the gradients are reduced across the ranks by the mode's collective —
     leaf by leaf, or bucket by bucket in the overlap mode — and divided
     by w; the loss is the mean of the rank losses, as ``pmean``;
  4. the optimizer runs once per distinct device of the ring, on that
     device's replica (once on one card).

Parameters and optimizer state are *replicated*: a dict mapping each
distinct device of the ring to its own tree. The error-feedback residual
is per rank: a list with one flat ``{path: residual}`` dict per rank.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.dist import collectives
from repro_torch.dist.collectives import LocalRing
from repro_torch.dist.compression import (
    compressed_ring_all_reduce,
    ef_compressed_all_reduce,
    fused_wire_all_reduce,
)
from repro_torch.dist.overlap import (
    bucketed_ring_reduce,
    microbatch_grads,
    tree_leaves,
    value_and_grad,
)
from repro_torch.dist.registry import STEP_MODES
from repro_torch.dist.sharding import is_dtensor
from repro_torch.models.module import _flatten, _unflatten
from repro_torch.training.optimizer import Optimizer

Replicas = Dict[torch.device, dict]
Grads = List[Dict[str, torch.Tensor]]     # one flat {path: tensor} per rank

# the f32 collectives of the ring modes, by mode
RING_MODES = {
    "ring": collectives.ring_all_reduce,
    "bidir": collectives.bidirectional_ring_all_reduce,
    "psum": collectives.psum_all_reduce,
}

# every mode make_ring_train_step accepts, in registry order
RING_STEP_MODES = tuple(STEP_MODES)

# mode -> per-leaf collective of the modes that reduce leaf by leaf
LEAF_COLLECTIVES: Dict[str, Callable] = {
    **RING_MODES,
    "compressed": partial(compressed_ring_all_reduce, fused=False),
    "compressed-fused": partial(compressed_ring_all_reduce, fused=True),
    "bf16-fused": partial(fused_wire_all_reduce, wire="bf16"),
    "fp8-fused": partial(fused_wire_all_reduce, wire="fp8"),
}
OVERLAP_MODE = "compressed-fused-overlap"
EF_MODES = ("compressed", "compressed-fused")


def check_mode(mode: str) -> None:
    if mode not in RING_STEP_MODES:
        raise ValueError(f"unknown ring mode {mode!r}; registered modes: "
                         f"{RING_STEP_MODES}")


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
               ) -> Tuple[List[torch.Tensor], Grads]:
    """Each rank's loss and flat ``{path: grad}`` on its own batch shard."""
    losses, grads = [], []
    for shard, d in zip(shards, devices):
        loss, g = value_and_grad(model.loss, params[d], shard)
        losses.append(loss)
        grads.append(dict(_flatten(g)))
    return losses, grads


def reduce_grads(grads: Grads, ring: LocalRing, mode: str, *,
                 n_buckets: Optional[int] = None) -> Grads:
    """Reduce every rank's gradients with the mode's collective, divided by
    w: leaf by leaf (each rank's input leaf dropped once reduced), or for
    the overlap mode bucket by bucket over ``n_buckets`` (the registry's
    count by default)."""
    check_mode(mode)
    w = ring.size
    if mode == OVERLAP_MODE:
        n = STEP_MODES[mode].n_buckets if n_buckets is None else int(n_buckets)
        summed = bucketed_ring_reduce([_unflatten(g) for g in grads], ring,
                                      variant="int8-fused", n_buckets=n)
        return [{p: s[p] / w for p in g} for g, s in zip(grads, summed)]
    collective = LEAF_COLLECTIVES[mode]
    out: Grads = [{} for _ in range(w)]
    for path in list(grads[0]):
        reduced = collective([g.pop(path) for g in grads], ring)
        for r in range(w):
            out[r][path] = reduced[r] / w
    return out


def ef_reduce_grads(grads: Grads, ef_state: Grads, ring: LocalRing, *,
                    fused: bool) -> Tuple[Grads, Grads]:
    """Error-feedback reduction of every leaf (divided by w) with each
    rank's residual; returns the reduced gradients and the new residuals."""
    w = ring.size
    out: Grads = [{} for _ in range(w)]
    new_ef: Grads = [{} for _ in range(w)]
    for path in list(grads[0]):
        reduced, residual = ef_compressed_all_reduce(
            [g.pop(path) for g in grads], [e[path] for e in ef_state], ring,
            fused=fused)
        for r in range(w):
            out[r][path] = reduced[r] / w
            new_ef[r][path] = residual[r]
    return out, new_ef


def init_ef_state(params: dict, devices: Sequence[torch.device]) -> Grads:
    """Zero error-feedback residuals: one flat f32 ``{path: zeros}`` per
    rank, on the rank's device."""
    return [{p: torch.zeros(v.shape, dtype=torch.float32, device=d)
             for p, v in _flatten(params)} for d in devices]


def make_train_step(model, optimizer: Optimizer, *, lr: float = 3e-4,
                    n_microbatches: int = 1) -> Callable:
    """GSPMD train step: ``(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``, on plain tensors or on DTensors alike.
    ``grad_norm`` is the f32 norm of all the gradients, summed leaf by leaf
    in the reference's tree order. A DTensor gradient is laid out as its
    parameter before the update (a partial sum reduce-scattered, FSDP's
    reduction), so that the optimizer's arithmetic is each device's own."""

    def step(params, opt_state, batch):
        loss, grads = microbatch_grads(model.loss, params, batch,
                                       n_microbatches)
        layout = dict(_flatten(params))
        grads = _unflatten({
            path: g.redistribute(g.device_mesh, layout[path].placements)
            if is_dtensor(g) else g for path, g in _flatten(grads)})
        new_params, new_opt = optimizer.update(grads, opt_state, params, lr=lr)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for _, g in tree_leaves(grads)))
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return step


def make_ring_train_step(model, optimizer: Optimizer, ring: LocalRing, *,
                         lr: float = 3e-4, mode: str = "ring",
                         error_feedback: bool = False,
                         n_buckets: Optional[int] = None) -> Callable:
    """Build ``step(params, opt_state, shards[, ef_state]) -> (params,
    opt_state, metrics[, ef_state])`` over ``ring``. ``params``/``opt_state``
    are replicas (one tree per distinct device), ``shards`` the per-rank
    batch blocks of :func:`shard_batch`, ``ef_state`` the per-rank residuals
    of :func:`init_ef_state`.

    ``mode`` is any of :data:`RING_STEP_MODES`: ``"ring"`` (the paper's f32
    ring), ``"bidir"`` (counter-rotating half-rings), ``"psum"`` (no
    explicit ring), ``"compressed"`` (int8, two messages per hop),
    ``"compressed-fused"`` (the fused int8 ring), ``"bf16-fused"`` /
    ``"fp8-fused"`` (the fused ring with a bf16 / fp8 e4m3 payload) and
    ``"compressed-fused-overlap"`` (the fused int8 ring per bucket of the
    reverse-autodiff plan; ``n_buckets`` overrides the registry default).
    Both int8 per-leaf modes pair with ``error_feedback``; the bf16, fp8 and
    overlap modes raise ``ValueError`` with it, and the f32 modes ignore
    it, as in the reference.
    """
    check_mode(mode)
    wire = mode in ("bf16-fused", "fp8-fused")
    overlap = mode == OVERLAP_MODE
    if error_feedback and (wire or overlap):
        raise ValueError(
            f"mode {mode!r} does not support error_feedback: residual "
            "tracking is only wired for the per-leaf int8 rings "
            "(\"compressed\" / \"compressed-fused\")")
    if n_buckets is not None and not overlap:
        raise ValueError(f"n_buckets is only meaningful for "
                         f"\"compressed-fused-overlap\", got mode {mode!r}")
    devices = ring.devices

    def step(params: Replicas, opt_state: Replicas, shards,
             ef_state: Optional[Grads] = None):
        losses, grads = rank_grads(model, params, shards, devices)
        new_ef = ef_state
        if error_feedback and ef_state is not None and mode in EF_MODES:
            reduced, new_ef = ef_reduce_grads(
                grads, ef_state, ring, fused=mode == "compressed-fused")
        else:
            reduced = reduce_grads(grads, ring, mode, n_buckets=n_buckets)
        home = devices[0]
        loss = torch.stack([l.to(home) for l in losses]).mean()
        new_params, new_opt = {}, {}
        for d in distinct_devices(devices):
            g = _unflatten(reduced[devices.index(d)])
            new_params[d], new_opt[d] = optimizer.update(
                g, opt_state[d], params[d], lr=lr)
        metrics = {"loss": loss}
        if ef_state is not None:
            return new_params, new_opt, metrics, new_ef
        return new_params, new_opt, metrics

    return step


def make_serve_step(model) -> Callable:
    """(params, cache, tokens, cur_index) -> (next_token_logits, cache)."""

    def step(params, cache, tokens, cur_index):
        return model.decode_step(params, cache, tokens, cur_index)

    return step
