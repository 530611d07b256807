"""Typed cluster events + seeded, replayable event streams.

Every quantity the paper's online setting (§V-B) reacts to is an explicit
event rather than a hardcoded branch of a slot loop:

  * :class:`SlotTick`        — the slot boundary t of the accumulators z_{i,t}
    (constraint (5): allocations are committed once per slot).
  * :class:`JobArrival`      — job i becomes visible at a_i (constraint (6):
    no allocation before arrival; the scheduler never looks ahead).
  * :class:`JobCompletion`   — z_{i,t} reached the worker-time budget
    min_r F_i^r / l_i^r (Eq. (11)); the job leaves the active set I[t].
  * :class:`ServerFailure` / :class:`ServerRecovery` — server s drops out of
    / returns to the substrate capacity C_s^r. Failures emitted *mid-slot*
    void that slot's progress for every ring touching the server (the
    preemptive-job assumption: resume from last checkpoint).
  * :class:`StragglerOnset` / :class:`StragglerEnd` — server s runs at
    ``factor`` speed; a synchronous ring runs at its slowest member (Eq. (1)
    with reduced effective G).
  * :class:`WorkerJoin` / :class:`WorkerLeave` — mid-slot ring membership
    changes (the ROADMAP's elastic re-ring channel): a leave mid-slot shrinks
    the ring and only the surviving fraction of the slot's worker-time is
    credited; joins take effect at the next slot boundary (rings reshape
    between slots).
  * :class:`EmbeddingCommitted` — one ring placement (x, y, r) committed for
    a job this slot; the event log therefore fully determines per-job
    first-scheduling slots (queueing delay) and completion (makespan).
  * :class:`RequestArrival` — one inference request for a serve job:
    pre-slot, so the scheduler prices the backlog before placing
    rings; consumed by the serving backend, which enqueues it on the job's
    continuous-batching engine.
  * :class:`RequestFirstToken` / :class:`RequestCompletion` — emitted by the
    serving backend *from execution* (they ride back on the slot outcome and
    the driver appends them to the log), so TTFT/TPOT and SLO attainment are
    recomputable from the event log alone — the runtime sanitizer's
    serving-accounting check re-derives attainment from these events and
    compares it with the backend's reported per-slot value.

Streams are *seeded and replayable*: ``reset()`` rewinds to the initial RNG
state, so the same stream replayed against the same scheduler reproduces the
exact same run (the event-replay determinism contract).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClusterEvent:
    """Base event: ``t`` is the slot index the event belongs to."""

    t: int


@dataclasses.dataclass(frozen=True)
class SlotTick(ClusterEvent):
    """Slot boundary — emitted by the driver at the start of every slot."""


@dataclasses.dataclass(frozen=True)
class JobArrival(ClusterEvent):
    job_id: int


@dataclasses.dataclass(frozen=True)
class JobCompletion(ClusterEvent):
    job_id: int


@dataclasses.dataclass(frozen=True)
class ServerFailure(ClusterEvent):
    server_id: int


@dataclasses.dataclass(frozen=True)
class ServerRecovery(ClusterEvent):
    server_id: int


@dataclasses.dataclass(frozen=True)
class StragglerOnset(ClusterEvent):
    server_id: int
    factor: float = 0.4  # relative speed while straggling


@dataclasses.dataclass(frozen=True)
class StragglerEnd(ClusterEvent):
    server_id: int


@dataclasses.dataclass(frozen=True)
class WorkerJoin(ClusterEvent):
    job_id: int
    n: int = 1


@dataclasses.dataclass(frozen=True)
class WorkerLeave(ClusterEvent):
    job_id: int
    n: int = 1


@dataclasses.dataclass(frozen=True)
class EmbeddingCommitted(ClusterEvent):
    """A ring of ``n_workers`` committed for ``job_id`` at slot ``t``."""

    job_id: int
    n_workers: int


@dataclasses.dataclass(frozen=True)
class RequestArrival(ClusterEvent):
    """One inference request for serve job ``job_id`` arrives at slot ``t``.

    ``prompt_len``/``max_new`` are in tokens; ``request_id`` is unique per
    job (the serving backend synthesizes the deterministic prompt content
    from ``(job_id, request_id)``, so a replayed stream reproduces the
    byte-identical workload).
    """

    job_id: int
    request_id: int
    prompt_len: int = 8
    max_new: int = 16


@dataclasses.dataclass(frozen=True)
class RequestFirstToken(ClusterEvent):
    """Request ``request_id`` produced its first token at slot ``t``
    (``ttft_slots`` = t - arrival slot, the time-to-first-token)."""

    job_id: int
    request_id: int
    ttft_slots: int


@dataclasses.dataclass(frozen=True)
class RequestCompletion(ClusterEvent):
    """Request ``request_id`` finished at slot ``t`` having generated
    ``n_tokens`` over ``decode_slots`` slots since its first token (so
    TPOT = decode_slots / max(n_tokens - 1, 1) slots per token)."""

    job_id: int
    request_id: int
    n_tokens: int
    ttft_slots: int
    decode_slots: int


@dataclasses.dataclass
class FaultConfig:
    """Stochastic fault/straggler dynamics (drives :class:`FaultEventStream`)."""

    server_fail_prob: float = 0.0      # per-server per-slot failure prob
    repair_prob: float = 0.5           # per-slot repair prob once failed
    straggler_prob: float = 0.0        # per-server per-slot straggle prob
    straggler_factor: float = 0.4      # relative speed when straggling
    seed: int = 0


class EventStream:
    """Replayable source of cluster events, split into two phases per slot.

    ``pre_slot(t)`` events are visible to the scheduler *before* it decides
    (repairs, straggler onset, scripted membership changes); ``mid_slot(t)``
    events strike *after* placement (the failure wave — rings already placed
    on a newly failed server lose the slot). ``reset()`` rewinds the stream
    so a run can be replayed bit-for-bit.
    """

    def reset(self) -> None:
        """Rewind to the initial state (re-seed any RNG)."""

    def pre_slot(self, t: int) -> List[ClusterEvent]:
        return []

    def mid_slot(self, t: int) -> List[ClusterEvent]:
        return []


class FaultEventStream(EventStream):
    """Geometric failure/repair + Bernoulli straggler dynamics as events.

    Reproduces the legacy ``ClusterSimulator`` draw order exactly (one RNG,
    per-server: repair draw only while failed, straggler draw only while
    healthy, failure draw only while up — short-circuits and all), so a
    driver consuming this stream is bit-identical to the retired loop for
    any seed. One deliberate divergence from the retired loop: a server that
    fails *while straggling* drops its straggler state at the failure (no
    stray ``StragglerEnd`` later, a fresh ``StragglerOnset`` if it straggles
    again after recovery), matching the driver's accounting.
    """

    def __init__(self, server_ids: Sequence[int], cfg: FaultConfig):
        self.server_ids = list(server_ids)
        self.cfg = cfg
        self.reset()

    def reset(self) -> None:
        self.rng = np.random.default_rng(self.cfg.seed)
        self._failed: Dict[int, bool] = {s: False for s in self.server_ids}
        self._straggling: Dict[int, bool] = {s: False for s in self.server_ids}

    def pre_slot(self, t: int) -> List[ClusterEvent]:
        cfg = self.cfg
        out: List[ClusterEvent] = []
        for sid in self._failed:
            if self._failed[sid] and self.rng.random() < cfg.repair_prob:
                self._failed[sid] = False
                out.append(ServerRecovery(t, sid))
            # no straggler draw while failed (matches the legacy short-circuit)
            now = (not self._failed[sid]
                   and self.rng.random() < cfg.straggler_prob)
            if now and not self._straggling[sid]:
                out.append(StragglerOnset(t, sid, cfg.straggler_factor))
            elif self._straggling[sid] and not now:
                out.append(StragglerEnd(t, sid))
            self._straggling[sid] = now
        return out

    def mid_slot(self, t: int) -> List[ClusterEvent]:
        out: List[ClusterEvent] = []
        for sid in self._failed:
            if not self._failed[sid] \
                    and self.rng.random() < self.cfg.server_fail_prob:
                self._failed[sid] = True
                # a downed server stops straggling, matching the driver's
                # accounting (which drops the straggler factor on a mid-slot
                # failure) — after recovery a fresh draw emits a fresh
                # StragglerOnset instead of silently resuming the old one
                self._straggling[sid] = False
                out.append(ServerFailure(t, sid))
        return out


class ScriptedEventStream(EventStream):
    """Fixed event script for tests and what-if scenarios.

    ``pre`` / ``mid`` hold the events for their phase; each call returns the
    subset with matching slot ``t``. Deterministic, trivially replayable.
    """

    def __init__(self, pre: Iterable[ClusterEvent] = (),
                 mid: Iterable[ClusterEvent] = ()):
        self.pre = list(pre)
        self.mid = list(mid)

    def pre_slot(self, t: int) -> List[ClusterEvent]:
        return [e for e in self.pre if e.t == t]

    def mid_slot(self, t: int) -> List[ClusterEvent]:
        return [e for e in self.mid if e.t == t]


class CompositeEventStream(EventStream):
    """Concatenate several streams (e.g. stochastic faults + a scripted
    membership-change scenario) preserving per-stream order."""

    def __init__(self, streams: Sequence[EventStream]):
        self.streams = list(streams)

    def reset(self) -> None:
        for s in self.streams:
            s.reset()

    def pre_slot(self, t: int) -> List[ClusterEvent]:
        return [e for s in self.streams for e in s.pre_slot(t)]

    def mid_slot(self, t: int) -> List[ClusterEvent]:
        return [e for s in self.streams for e in s.mid_slot(t)]


@dataclasses.dataclass
class RequestStreamConfig:
    """Diurnal-bursty request arrivals for one serve job.

    Per slot inside ``[start, end)`` the request count is Poisson at a rate
    modulated by a sinusoidal diurnal cycle,
    ``base_rate * (1 + amplitude * sin(2*pi*(t - start)/period))``, plus a
    Bernoulli burst of ``burst_size`` extra requests with probability
    ``burst_prob`` (the flash crowd). Prompt and generation lengths are
    drawn uniformly from the inclusive ranges. Everything is drawn from one
    seeded generator in a fixed per-slot order, so ``reset()`` replays the
    identical trace.
    """

    job_id: int
    start: int = 0
    end: Optional[int] = None           # exclusive; None = no end
    base_rate: float = 2.0              # mean requests per slot
    amplitude: float = 0.5              # diurnal modulation in [0, 1]
    period: int = 24                    # slots per diurnal cycle
    burst_prob: float = 0.1
    burst_size: int = 6
    prompt_len: tuple = (4, 12)         # inclusive range, tokens
    max_new: tuple = (4, 24)            # inclusive range, tokens
    seed: int = 0


class DiurnalRequestStream(EventStream):
    """Seeded, replayable diurnal/bursty :class:`RequestArrival` source.

    All arrivals are *pre-slot*: the scheduler sees the backlog grow before
    it places rings, so a burst slot can reclaim workers from training jobs
    through the ordinary utility pricing, and the serving backend admits
    the new requests onto free cache lanes in the same slot.
    """

    def __init__(self, cfg: RequestStreamConfig):
        self.cfg = cfg
        self.reset()

    def reset(self) -> None:
        self.rng = np.random.default_rng(self.cfg.seed)
        self._next_id = 0

    def pre_slot(self, t: int) -> List[ClusterEvent]:
        cfg = self.cfg
        if t < cfg.start or (cfg.end is not None and t >= cfg.end):
            return []
        rate = cfg.base_rate * (
            1.0 + cfg.amplitude
            * np.sin(2.0 * np.pi * (t - cfg.start) / max(cfg.period, 1)))
        n = int(self.rng.poisson(max(rate, 0.0)))
        if self.rng.random() < cfg.burst_prob:
            n += int(cfg.burst_size)
        out: List[ClusterEvent] = []
        for _ in range(n):
            p = int(self.rng.integers(cfg.prompt_len[0],
                                      cfg.prompt_len[1] + 1))
            m = int(self.rng.integers(cfg.max_new[0], cfg.max_new[1] + 1))
            out.append(RequestArrival(t, cfg.job_id, self._next_id,
                                      prompt_len=p, max_new=m))
            self._next_id += 1
        return out
