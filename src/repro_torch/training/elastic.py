"""Elastic data-parallel training — the consumer of GADGET's per-slot worker
counts (the counterpart of ``repro.training.elastic``).

GADGET reallocates workers between slots. The trainer maps a worker count
w to a ring of w ranks, moves the replicated params/optimizer state onto
the ring's devices, and continues from the exact step. A slot with w=0
parks the job (checkpoint only).

As in the reference, every rank of a ring is driven by this one process:
rank r runs on ``devices[r]``. The group's rank slots are a ``devices``
list; on one card it is that card eight times, mirroring the reference's
8 host devices, so worker counts clamp to the same feasible ring sizes. A
hop is then a copy into the receiving rank's buffer, with the reference's
hop schedule and wire bytes.

  * :class:`RingWorkerGroup` — the ring substrate: a ring-program cache
    keyed by ``(workers, mode, n_buckets, wire_dtype)`` and
    :meth:`RingWorkerGroup.re_ring`, which reforms the ring over the
    surviving workers mid-slot (the survivors hold full replicas, so no
    checkpoint restore is involved).
  * :class:`ElasticTrainer` — per-job state (params, optimizer, step,
    losses) driven slot by slot through the group.

Worker counts clamp to the largest divisor of ``global_batch`` that fits
the rank slots (:func:`largest_feasible_ring`), so every rank gets an equal
row block. The data pipeline is step-indexed, so token order does not
depend on the ring size.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.dist.collectives import LocalRing
from repro_torch.dist.registry import STEP_MODES
from repro_torch.models.module import params_from_reference, tree_map
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.optimizer import Optimizer
from repro_torch.training.train_step import (
    OVERLAP_MODE,
    Replicas,
    check_mode,
    distinct_devices,
    make_ring_train_step,
    shard_batch,
)

# rank slots of a group on one device: the reference's 8 host devices
RANK_SLOTS = 8


def ring_devices(device="cuda") -> List[torch.device]:
    """The default rank slots: ``device`` (with its index resolved) eight
    times."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return [dev] * RANK_SLOTS


def largest_feasible_ring(requested: int, *, global_batch: int,
                          n_devices: int) -> int:
    """Largest ring size <= ``requested`` that divides ``global_batch`` and
    fits on ``n_devices`` rank slots (0 when ``requested`` <= 0)."""
    w = min(int(requested), int(n_devices), int(global_batch))
    if w <= 0:
        return 0
    while global_batch % w:
        w -= 1
    return w


@dataclasses.dataclass
class SlotPlan:
    """One scheduler decision: train for ``steps`` with ``workers`` workers.

    ``leave=(after, n)`` scripts a mid-slot membership change: after ``after``
    completed steps, ``n`` workers depart and the slot finishes on the
    survivors via :meth:`RingWorkerGroup.re_ring` (same global batch, no
    checkpoint restore).
    """

    workers: int
    steps: int
    leave: Optional[Tuple[int, int]] = None


@dataclasses.dataclass
class _RingProgram:
    """One ring configuration: its transport and its train step."""

    ring: LocalRing
    step_fn: Callable


class RingWorkerGroup:
    """Rank slots + ring-program cache for one job's elastic ring.

    ``compile_count`` counts cache misses, so equal-sized back-to-back
    slots can be shown to reuse their ring program. ``mode`` is any of the
    eight ``STEP_MODES``; ``n_buckets`` overrides the overlap mode's bucket
    count (the registry's by default).
    """

    # attributes the ring program closes over when it is built: part of its
    # semantics but not of the cache key, so nothing after __init__ may
    # assign them
    STATIC_CLOSURE_ATTRS = ("model", "optimizer", "global_batch", "lr",
                            "n_buckets", "wire_dtype")

    def __init__(self, model, optimizer: Optimizer, *, global_batch: int,
                 lr: float, mode: str = "ring",
                 n_buckets: Optional[int] = None,
                 devices: Optional[Sequence] = None):
        check_mode(mode)
        self.model = model
        self.optimizer = optimizer
        self.global_batch = global_batch
        self.lr = lr
        self.mode = mode
        self.devices = [torch.device(d) for d in (devices or ring_devices())]
        spec = STEP_MODES[mode]
        # resolved bucket count (None for the modes without buckets) and
        # wire payload dtype: both change the ring program, so both sit in
        # the cache key beside the mode
        self.n_buckets = spec.n_buckets if n_buckets is None else int(n_buckets)
        self.wire_dtype = spec.wire_dtype
        self.workers = 0                 # current ring size (0 = unformed)
        self.compile_count = 0           # ring-program cache misses
        self._programs: Dict[Tuple[int, str, Optional[int], str],
                             _RingProgram] = {}
        self._warm: set = set()          # keys whose step_fn has run >= once

    def cache_key(self, workers: int) -> Tuple[int, str, Optional[int], str]:
        """The ring-program cache key for a (clamped) ring size; the first
        element stays the worker count."""
        return (int(workers), self.mode, self.n_buckets, self.wire_dtype)

    # -- ring formation -----------------------------------------------------
    def resolve_workers(self, requested: int) -> int:
        """Clamp a requested worker count to a feasible ring size."""
        return largest_feasible_ring(requested,
                                     global_batch=self.global_batch,
                                     n_devices=len(self.devices))

    def form(self, workers: int) -> int:
        """Form (or re-form) the ring at the clamped size; returns it."""
        w = self.resolve_workers(workers)
        if w <= 0:
            raise ValueError(f"cannot form a ring for workers={workers}")
        self._program(w)
        self.workers = w
        return w

    def re_ring(self, survivors: int) -> int:
        """Reform the ring over ``survivors`` workers mid-slot: the new ring
        spans the first ``survivors`` rank slots, and since params/opt state
        are replicated, moving onto it needs no checkpoint restore."""
        return self.form(max(1, survivors))

    def _program(self, w: int) -> _RingProgram:
        key = self.cache_key(w)
        prog = self._programs.get(key)
        if prog is None:
            ring = LocalRing(self.devices[:w])
            prog = _RingProgram(
                ring=ring,
                step_fn=make_ring_train_step(
                    self.model, self.optimizer, ring, lr=self.lr,
                    mode=self.mode,
                    n_buckets=self.n_buckets if self.mode == OVERLAP_MODE
                    else None))
            self._programs[key] = prog
            self.compile_count += 1
        return prog

    # -- execution over the current ring ------------------------------------
    @property
    def current(self) -> _RingProgram:
        if self.workers <= 0:
            raise RuntimeError("ring not formed; call form() first")
        return self._programs[self.cache_key(self.workers)]

    def reshard(self, replicas: Replicas) -> Replicas:
        """Replicate state over the current ring's devices (elastic reshard:
        same values, new device set). A device that already holds a
        replica keeps it; a new one gets a copy."""
        source = next(iter(replicas.values()))
        out = {}
        for d in distinct_devices(self.current.ring.devices):
            out[d] = replicas[d] if d in replicas else tree_map(
                lambda t, d=d: t.to(d, copy=True), source)
        return out

    def shard_batch(self, batch) -> List[Dict[str, torch.Tensor]]:
        """Split a global batch across the current ring's ranks."""
        return shard_batch({k: torch.as_tensor(v) for k, v in batch.items()},
                           self.current.ring.devices)

    @property
    def warm(self) -> bool:
        """True once the current ring's step has executed at least once."""
        return self.cache_key(self.workers) in self._warm

    def step(self, params, opt_state, shards):
        """Run one train step over the current ring."""
        out = self.current.step_fn(params, opt_state, shards)
        self._warm.add(self.cache_key(self.workers))
        return out


class ElasticTrainer:
    """Runs a job across slots with varying ring size.

    ``params``/``opt_state`` are replicas: one tree per distinct device of
    the current ring. ``params=`` (a tree on ``devices[0]``) starts from
    given weights instead of ``model.init(0)``; ``n_buckets`` goes to the
    :class:`RingWorkerGroup`. Matrix products run in full
    f32: the constructor turns TF32 off for matmuls and cuDNN, process-wide,
    as the reference trains in f32.
    """

    def __init__(self, model, optimizer: Optimizer, data, *,
                 global_batch: int, base_lr: float = 1e-3,
                 mode: str = "ring", checkpoint_dir: Optional[str] = None,
                 n_buckets: Optional[int] = None, device="cuda",
                 devices: Optional[Sequence] = None, params=None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = model
        self.optimizer = optimizer
        self.data = data
        self.global_batch = global_batch
        self.base_lr = base_lr
        self.mode = mode
        self.checkpoint_dir = checkpoint_dir
        self.group = RingWorkerGroup(model, optimizer,
                                     global_batch=global_batch,
                                     lr=base_lr,  # fixed global batch =>
                                     mode=mode,   # fixed LR (w splits only)
                                     n_buckets=n_buckets,
                                     devices=devices or ring_devices(device))
        home = self.group.devices[0]
        if params is None:
            params = model.init(0, device=home, dtype=torch.float32)
        self.params: Replicas = {home: params}
        self.opt_state: Replicas = {home: optimizer.init(params)}
        self.step = 0
        self.losses: List[float] = []
        self.resharding_events = 0   # slot-boundary ring changes
        self.re_ring_events = 0      # mid-slot re-rings (no ckpt restore)
        self.restores = 0            # checkpoint restores (failure recovery)

    def _reshard_state(self) -> None:
        self.params = self.group.reshard(self.params)
        self.opt_state = self.group.reshard(self.opt_state)

    def _save(self) -> None:
        save_checkpoint(self.checkpoint_dir,
                        params=next(iter(self.params.values())),
                        opt_state=next(iter(self.opt_state.values())),
                        step=self.step)

    def run_slot(self, plan: SlotPlan) -> Dict[str, float]:
        """Execute one slot; returns measured outcomes.

        Keys: ``steps`` (executed), ``loss`` (last), ``workers`` (initial
        clamped ring size), ``worker_steps`` (sum of ring size over executed
        steps), ``timings`` (ring size -> best warm wall seconds/step),
        ``re_rings`` (mid-slot re-rings).
        """
        if plan.workers <= 0:
            if self.checkpoint_dir:
                self._save()
            return {"steps": 0, "loss": float("nan")}
        w = self.group.form(plan.workers)
        self._reshard_state()
        self.resharding_events += 1

        segments: List[Tuple[int, int]] = [(w, plan.steps)]
        if plan.leave is not None:
            after, n_leave = plan.leave
            after = max(0, min(int(after), plan.steps))
            survivors = self.group.resolve_workers(max(1, w - int(n_leave)))
            segments = [(w, after), (survivors, plan.steps - after)]

        loss = float("nan")
        worker_steps = 0
        re_rings = 0
        timings: Dict[int, float] = {}
        for idx, (seg_w, seg_steps) in enumerate(segments):
            if idx > 0:
                seg_w = self.group.re_ring(seg_w)
                self._reshard_state()
                self.re_ring_events += 1
                re_rings += 1
            for _ in range(seg_steps):
                shards = self.group.shard_batch(self.data.batch(self.step))
                was_warm = self.group.warm
                t0 = time.perf_counter()
                self.params, self.opt_state, metrics = self.group.step(
                    self.params, self.opt_state, shards)
                loss = float(metrics["loss"])  # sync: timing covers the step
                dt = time.perf_counter() - t0
                if was_warm:  # a cold step times first-use set-up, not the ring
                    timings[seg_w] = min(timings.get(seg_w, float("inf")), dt)
                self.losses.append(loss)
                self.step += 1
                worker_steps += seg_w
        if self.checkpoint_dir:
            self._save()
        return {"steps": plan.steps, "loss": loss, "workers": w,
                "worker_steps": worker_steps, "timings": timings,
                "re_rings": re_rings}

    def restore(self) -> bool:
        if not self.checkpoint_dir:
            return False
        try:
            params, opt, step, _ = load_checkpoint(self.checkpoint_dir)
        except FileNotFoundError:
            return False
        home = self.group.devices[0]
        self.params = {home: params_from_reference(params, home)}
        self.opt_state = {home: params_from_reference(opt, home)}
        self.step = step
        self.restores += 1
        return True
