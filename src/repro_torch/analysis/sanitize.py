"""Opt-in runtime sanitizer — per-slot domain-invariant assertions (a copy
of ``repro.analysis.sanitize``).

The domain analogue of ASan/TSan wiring: ``OnlineDriver(sanitize=True)`` (or
``REPRO_SANITIZE=1`` in the environment) attaches a :class:`SlotSanitizer`
that re-derives, from scratch, the invariants the hot path maintains
incrementally, and raises :class:`SanitizerError` on the first divergence:

  * **capacity conservation** — per healthy server and resource type,
    ``free + sum(committed demands) == capacity`` (zero for servers that
    were down at scheduling time), and per edge, the tracked reservation
    equals the sum over committed rings and stays within
    ``oversubscription * capacity``;
  * **worker-time budgets** — every z accumulator is non-negative and the
    cached bottleneck budget ``min_r F_i^r / l_i^r`` matches a fresh
    evaluation (Eq. (11));
  * **utility-cache coherence** — the per-job utilities behind the cached
    ``total_utility`` equal a from-scratch re-evaluation at the current z
    (*exact* float equality: ``commit_slot`` computes the identical
    expression, so any difference is drift). Re-summed on sampled slots
    (every slot for small instances, strided deterministically for large
    ones — no RNG, so a sanitized run stays bit-identical);
  * **execution factors** — per-ring progress factors in [0, 1] and
    contention factors in (0, 1] (tau(b_i)/tau(b_eff) can only slow a ring
    down);
  * **wire-formula agreement** — for every scheduled job priced with a
    compressed ring, ``repro_torch.core.rar_model``'s byte/message formulas must
    equal ``repro_torch.dist.compression``'s executable accounting (checked once
    per distinct profile);
  * **serving accounting** — every ``slo_attainment`` a backend reports in
    ``outcome.measured`` must *exactly* equal the attainment re-derived from
    the run's event log (``RequestCompletion`` events vs the job's SLO).

The sanitizer only *reads* driver state — it never draws RNG, never mutates
the caches it checks — so a sanitized run produces a bit-identical
``SimResult`` to the default path (pinned in tests/test_analysis.py and the
CI ``lint-and-sanitize`` job, which runs the whole fast tier under
``REPRO_SANITIZE=1``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["SanitizerError", "SanitizerConfig", "SlotSanitizer",
           "sanitize_enabled"]


class SanitizerError(AssertionError):
    """A domain invariant the hot path is supposed to maintain was violated."""


def sanitize_enabled(explicit: Optional[bool] = None) -> bool:
    """Resolve the sanitizer switch: an explicit argument wins; otherwise
    the ``REPRO_SANITIZE`` environment variable ("" / "0" = off)."""
    if explicit is not None:
        return bool(explicit)
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


@dataclasses.dataclass(frozen=True)
class SanitizerConfig:
    """Tolerances and sampling for :class:`SlotSanitizer`.

    ``tol`` absorbs float re-association only (conservation sums re-derived
    in a different order); the utility-cache check is exact by design.
    ``utility_stride`` of None picks a deterministic stride from the job
    count (1 while <= ``stride_threshold`` jobs, then ~jobs/threshold).
    """

    tol: float = 1e-6
    utility_stride: Optional[int] = None
    stride_threshold: int = 256


class SlotSanitizer:
    """Per-slot invariant checker. One instance per driver run.

    ``check_slot`` is called by :class:`~repro_torch.sched.driver.OnlineDriver`
    after the slot's ``commit_slot`` accounting, with the slot's context,
    the committed embeddings, and the backend's
    :class:`~repro_torch.sched.backend.SlotOutcome`.
    """

    def __init__(self, cfg: Optional[SanitizerConfig] = None):
        self.cfg = cfg or SanitizerConfig()
        self._wire_checked: Set[Tuple[float, str]] = set()

    # -- entry point --------------------------------------------------------
    def check_slot(self, *, ctx, committed, outcome, events=None) -> None:
        self._check_outcome(ctx, committed, outcome)
        self._check_resource_conservation(ctx)
        self._check_budgets(ctx)
        if self._sample_utilities(ctx):
            self._check_utility_cache(ctx)
        for emb in committed:
            self._check_wire_formulas(ctx.state.inst.job(emb.job_id))
        if events is not None:
            self._check_serving(ctx, outcome, events)

    # -- execution factors ---------------------------------------------------
    def _check_outcome(self, ctx, committed, outcome) -> None:
        tol = self.cfg.tol
        for k, f in enumerate(outcome.factors):
            if not math.isfinite(f) or f < -tol or f > 1.0 + tol:
                self._fail(ctx, f"progress factor {f!r} of embedding {k} "
                                "outside [0, 1] — a ring cannot deliver "
                                "more than one slot of worker-time")
        for k, cf in enumerate(outcome.contention_factors):
            if not math.isfinite(cf) or cf <= 0.0 or cf > 1.0 + tol:
                self._fail(ctx, f"contention factor {cf!r} (ring {k}) "
                                "outside (0, 1] — fair-share re-pricing can "
                                "only slow a ring down")
        if outcome.lost < 0 or outcome.lost > len(committed):
            self._fail(ctx, f"lost={outcome.lost} rings out of "
                            f"{len(committed)} committed")

    # -- capacity conservation ----------------------------------------------
    def _check_resource_conservation(self, ctx) -> None:
        res, tol = ctx.res, self.cfg.tol
        used_node: Dict[int, Dict[str, float]] = {}
        used_edge: Dict[Tuple[str, str], float] = {}
        for emb in res.committed.values():
            demands = ctx.state.inst.job(emb.job_id).demands
            for s, need in emb.node_demand(demands).items():
                acc = used_node.setdefault(s, {})
                for r, v in need.items():
                    acc[r] = acc.get(r, 0.0) + v
            for e, v in emb.edge_demand().items():
                used_edge[e] = used_edge.get(e, 0.0) + v
        for server in res.graph.servers:
            caps = {} if server.id in ctx.failed else server.caps
            for r in res.graph.resource_types:
                cap = caps.get(r, 0.0)
                free = res.free_node[server.id].get(r, 0.0)
                used = used_node.get(server.id, {}).get(r, 0.0)
                scale = max(abs(cap), 1.0)
                if free < -tol * scale:
                    self._fail(ctx, f"negative free {r}={free!r} on server "
                                    f"{server.id}")
                if abs(cap - free - used) > tol * scale:
                    self._fail(
                        ctx, f"server {server.id} {r} conservation broken: "
                             f"capacity {cap!r} != free {free!r} + "
                             f"committed {used!r}")
        for e, cap in res.graph.links.items():
            reserved = res.reserved_edge(e)
            expected = used_edge.get(e, 0.0)
            scale = max(abs(cap), 1.0)
            if abs(reserved - expected) > tol * scale:
                self._fail(ctx, f"edge {e} reservation {reserved!r} != sum "
                                f"of committed ring demands {expected!r}")
            if reserved > res.oversubscription * cap + tol * scale:
                self._fail(ctx, f"edge {e} reservation {reserved!r} exceeds "
                                f"oversubscription bound "
                                f"{res.oversubscription} * {cap!r}")

    # -- worker-time budgets -------------------------------------------------
    def _check_budgets(self, ctx) -> None:
        state, tol = ctx.state, self.cfg.tol
        for job in state.inst.jobs:
            z = state.z.get(job.id)
            if z is None:
                continue  # appended job not yet admitted into the accounting
            if not math.isfinite(z) or z < -tol:
                self._fail(ctx, f"job {job.id} worker-time accumulator "
                                f"z={z!r} is negative")
            cached = state._wtb.get(job.id)
            if cached is not None and cached != job.worker_time_budget():
                self._fail(
                    ctx, f"job {job.id} cached worker-time budget {cached!r}"
                         f" != fresh min_r F_i^r/l_i^r = "
                         f"{job.worker_time_budget()!r} (Eq. (11) drift)")

    # -- utility cache --------------------------------------------------------
    def _sample_utilities(self, ctx) -> bool:
        stride = self.cfg.utility_stride
        if stride is None:
            n = len(ctx.state.inst.jobs)
            stride = 1 if n <= self.cfg.stride_threshold else (
                n // self.cfg.stride_threshold + 1)
        return ctx.t % max(1, stride) == 0

    def _check_utility_cache(self, ctx) -> None:
        state = ctx.state
        for job in state.inst.jobs:
            cached = state._util.get(job.id)
            if cached is None:
                continue
            fresh = job.utility(job.zeta * state.z[job.id])
            # exact: commit_slot evaluates this very expression, so the
            # tiniest difference means the cache was bypassed or z mutated
            # outside commit_slot
            if fresh != cached:
                self._fail(
                    ctx, f"job {job.id} cached utility {cached!r} != "
                         f"from-scratch re-evaluation {fresh!r} at "
                         f"z={state.z[job.id]!r} — total_utility is stale "
                         "(z mutated outside commit_slot, or the cache "
                         "refresh was skipped)")

    # -- wire-byte formula agreement ------------------------------------------
    def _check_wire_formulas(self, job) -> None:
        prof = getattr(job, "profile", None)
        if prof is None or prof.compression is None:
            return
        key = (float(prof.d), str(prof.compression))
        if key in self._wire_checked:
            return
        self._wire_checked.add(key)
        # lazy: pulls torch via repro_torch.dist — only jobs actually priced
        # with a compressed ring pay the import
        from repro_torch.core.rar_model import wire_formula
        from repro_torch.dist.compression import (
            compressed_ring_ppermutes,
            compressed_wire_bytes,
            fused_wire_bytes,
        )
        formula = wire_formula(prof.compression)
        fused = prof.compression != "int8"
        wire_name = {"bf16-fused": "bf16", "fp8-fused": "fp8"}.get(
            prof.compression)
        d = int(prof.d)
        for w in (2, 3, 8):
            model = float(formula.bytes_per_worker(float(d), w))
            if wire_name is None:
                wire = float(compressed_wire_bytes(d, w, fused=fused))
            else:
                wire = float(fused_wire_bytes(d, w, wire=wire_name))
            if abs(model - wire) > 1e-6 * max(wire, 1.0):
                raise SanitizerError(
                    f"wire-byte drift for job {job.id} "
                    f"(d={d}, w={w}, compression={prof.compression!r}): "
                    f"rar_model prices {model!r} bytes but the ring sends "
                    f"{wire!r} — Eq. (1) no longer prices what the "
                    "collective transmits")
            if int(formula.messages(w)) != \
                    compressed_ring_ppermutes(w, fused=fused):
                raise SanitizerError(
                    f"message-count drift (w={w}, "
                    f"compression={prof.compression!r}): rar_model and "
                    "repro_torch.dist.compression disagree on ppermutes per "
                    "all-reduce")

    # -- serving accounting ---------------------------------------------------
    def _check_serving(self, ctx, outcome, events) -> None:
        """Reported SLO attainment must be re-derivable from the event log.

        ``events`` is the driver's event log *including this slot's
        execution-generated events*. For every job whose measured row
        reports ``slo_attainment``, re-derive the cumulative attainment
        from the logged ``RequestCompletion`` events and the job's SLO.
        Exact float equality: both sides are one division of the same
        integer counts, so any difference means the backend's internal
        request records and the event log it emitted have diverged."""
        for job_id in sorted(outcome.measured):
            row = outcome.measured[job_id]
            reported = row.get("slo_attainment") if isinstance(row, dict) \
                else None
            if reported is None:
                continue
            job = ctx.state.inst.job(job_id)
            slo = getattr(job, "slo", None)
            if slo is None:
                self._fail(ctx, f"job {job_id} reports slo_attainment="
                                f"{reported!r} but carries no SLO — only "
                                "ServeJobs are scored against latency "
                                "targets")
            from repro_torch.sched.serving import slo_attainment_from_events

            derived = slo_attainment_from_events(events, job_id, slo)
            if derived != reported:
                self._fail(
                    ctx, f"job {job_id} reported slo_attainment={reported!r}"
                         f" but the event log re-derives {derived!r} — the "
                         "backend's request accounting and the logged "
                         "RequestFirstToken/RequestCompletion events have "
                         "diverged (served requests that were never logged, "
                         "or vice versa)")

    # -- helpers --------------------------------------------------------------
    def _fail(self, ctx, message: str) -> None:
        raise SanitizerError(f"slot t={ctx.t}: {message}")
