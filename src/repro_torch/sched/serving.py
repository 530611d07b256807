"""Serving as a first-class job class: SLO utilities + the serving backend
(the counterpart of ``repro.sched.serving``).

The GADGET model (§III) admits *arbitrary* per-job utilities over
accumulated worker-time, so inference needs no new scheduler theory — only
a mapping from latency SLOs onto the existing utility shapes and a backend
that turns committed worker-time into real decode steps:

  * :class:`ServeSLO` / :class:`ServeJob` / :func:`make_serve_job` — a serve
    job's ``zeta`` is tokens per worker-slot, its budget is the offered
    token load, and its utility is the paper's own sigmoid (§VI) with the
    knee at the offered load and the steepness set by the TTFT target (see
    :func:`make_serve_job`). A bursty serve job therefore outbids training
    jobs for workers exactly while its backlog is unserved, and the
    training rings it displaces are re-priced through the Eq. (1)
    fair-share contention discount — co-scheduling falls out of the
    existing machinery.
  * :class:`ServingBackend` — the :class:`~repro_torch.sched.backend.
    ExecutionBackend` that binds committed serve embeddings to
    :class:`~repro_torch.launch.serve.ServingEngine` instances (continuous
    batching over cache lanes). Per slot it enqueues the slot's
    :class:`~repro_torch.sched.events.RequestArrival` events, spends the ring's
    worker-time capacity ``tokens_per_worker_slot * n_workers`` (throttled
    by the same straggler/contention conditions as training) on prefill
    chunks and decode steps, credits the consumed fraction back as the
    progress factor, and emits :class:`RequestFirstToken` /
    :class:`RequestCompletion` events so TTFT/TPOT/SLO attainment are
    recomputable from the event log alone (the sanitizer's
    serving-accounting check relies on this). Non-serve embeddings are
    delegated to an inner backend (analytic by default, or a
    :class:`~repro_torch.sched.backend.LiveBackend` for mixed fleets).

TTFT/TPOT are measured in *slots*: first-token slot minus arrival slot, and
decode slots per generated token. Integer slot arithmetic keeps attainment
exactly recomputable from the log (no wall-clock in any decision path).
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.problem import Job
from repro_torch.core.utility import sigmoid_utility
from repro_torch.sched.api import SlotDecision
from repro_torch.sched.backend import (
    AnalyticBackend,
    SlotExecution,
    SlotOutcome,
    _slot_conditions,
)
from repro_torch.sched.events import (
    ClusterEvent,
    RequestArrival,
    RequestCompletion,
    RequestFirstToken,
)

if TYPE_CHECKING:  # annotation-only: keeps torch out of the sched import path
    from repro_torch.launch.serve import ServingEngine

__all__ = [
    "ServeSLO",
    "ServeJob",
    "ServingBackend",
    "make_serve_job",
    "slo_attainment_from_events",
    "synth_prompt",
]


@dataclasses.dataclass(frozen=True)
class ServeSLO:
    """Latency targets in slot units.

    ``ttft_slots`` — a request must produce its first token within this
    many slots of arrival; ``tpot_slots`` — once generating, it must
    average at most this many slots per subsequent token; ``weight`` — the
    sigmoid priority lambda1 the SLO maps onto (paper §VI: [1, 100]).
    """

    ttft_slots: int = 1
    tpot_slots: float = 1.0
    weight: float = 50.0

    def met_by(self, ttft_slots: int, n_tokens: int,
               decode_slots: int) -> bool:
        """The single attainment predicate — shared by the backend's
        reported value and the sanitizer's from-the-log recomputation, so
        the two can only diverge if the *event log* diverges from what the
        backend actually did."""
        if ttft_slots > self.ttft_slots:
            return False
        return decode_slots / max(n_tokens - 1, 1) <= self.tpot_slots


@dataclasses.dataclass
class ServeJob(Job):
    """A serve job: worker-time buys tokens, utility prices the SLO.

    ``zeta`` is tokens per worker-slot, so ``zeta * z`` is served tokens —
    the x-axis the sigmoid utility is expressed in. ``slo`` carries the
    latency targets the backend scores requests against.
    """

    slo: ServeSLO = dataclasses.field(default_factory=ServeSLO)


def make_serve_job(job_id: int, *, arrival: int, offered_tokens: float,
                   slo: ServeSLO, tokens_per_worker_slot: float = 32.0,
                   max_workers: int = 4, bandwidth: float = 10e9,
                   demands: Optional[Dict[str, float]] = None) -> ServeJob:
    """Map (offered load, SLO) onto the paper's sigmoid utility shape.

    The scheduler scores a serve job by ``mu(zeta(z+kappa)) - mu(zeta z)``
    like any other job, so the SLO must live in the *shape* of mu over
    served tokens ``k = zeta z``:

      * lambda3 (knee) = 0: a latency SLO puts the value up front — every
        served token pays from the first one (a knee at the offered load
        would make the marginal utility ~0 until the job is nearly done,
        i.e. a throughput objective, and the slot LP would never grant a
        burst a single worker);
      * lambda2 (steepness) = ``(6 / offered) * (1 + 1/ttft_slots)``
        (clamped to the paper's (0, 1)): the sigmoid's upper half decays
        over ~``6/lambda2`` tokens, so marginal utility stays high until
        roughly the offered load is served and collapses after — workers
        flow back to training once the burst clears. A tighter TTFT
        front-loads the decay (steeper lambda2), concentrating utility in
        the *earliest* tokens — exactly the pressure that reclaims workers
        through the slot LP the moment a burst lands;
      * lambda1 (priority) = ``slo.weight``.

    The budget is the offered token load expressed in worker-time
    (``offered / zeta``), so Eq. (11) completes the job once the backlog
    has been served.
    """
    zeta = float(tokens_per_worker_slot)
    steep = min(0.99, max(1e-4, (6.0 / max(offered_tokens, 1.0))
                          * (1.0 + 1.0 / max(slo.ttft_slots, 1))))
    demands = dict(demands) if demands else {"gpus": 1.0, "mem": 1.0}
    return ServeJob(
        id=job_id, arrival=arrival, max_workers=max_workers,
        demands=demands,
        budgets={"gpus": (offered_tokens / zeta) * demands["gpus"]},
        bandwidth=bandwidth, zeta=zeta,
        utility=sigmoid_utility(slo.weight, steep, 0.0),
        slo=slo,
    )


def synth_prompt(job_id: int, request_id: int, prompt_len: int,
                 vocab: int) -> np.ndarray:
    """Deterministic prompt content from the request identity, so a
    replayed :class:`RequestArrival` stream reproduces the byte-identical
    workload without shipping token arrays through the event log."""
    rng = np.random.default_rng((job_id, request_id))
    return rng.integers(0, vocab, size=prompt_len, dtype=np.int32)


def slo_attainment_from_events(events, job_id: int, slo: ServeSLO) -> float:
    """Cumulative SLO attainment of ``job_id`` implied by the event log:
    the fraction of logged :class:`RequestCompletion` events meeting both
    targets (vacuously 1.0 before any completion). Integer event fields in,
    one float division out — bit-comparable with any other evaluation of
    the same completions."""
    met = total = 0
    for ev in events:
        if isinstance(ev, RequestCompletion) and ev.job_id == job_id:
            total += 1
            met += bool(slo.met_by(ev.ttft_slots, ev.n_tokens,
                                   ev.decode_slots))
    return met / total if total else 1.0


class ServingBackend:
    """Execute serve-job slots on continuous-batching engines.

    ``engines`` maps serve job id -> :class:`~repro_torch.launch.serve.
    ServingEngine`; embeddings of jobs without an engine are delegated to
    ``inner`` (default :class:`AnalyticBackend`), so mixed
    training+serving fleets run through one backend.

    Per committed serve ring, the slot's token capacity is
    ``tokens_per_worker_slot * n_workers``, throttled by the shared
    straggler/contention conditions (``_slot_conditions`` — the same
    pricing training rings get) and the surviving fraction under a mid-slot
    ``WorkerLeave``. Capacity is spent on admissions (a prefill chunk call
    costs ``prefill_chunk`` tokens of capacity) and decode steps (one token
    per active lane); the credited progress factor is the consumed
    fraction, so ``zeta * z`` counts the work the engine actually did.

    ``audit`` (default: the ``REPRO_SANITIZE`` switch) runs
    :func:`~repro_torch.launch.serve.audit_serving_engine` after every executed
    serve ring — the compiled-step/lane-invariant audit; read-only.
    """

    name = "serving"

    def __init__(self, engines: Mapping[int, "ServingEngine"], *,
                 inner=None, tokens_per_worker_slot: float = 32.0,
                 audit: Optional[bool] = None):
        from repro_torch.analysis.sanitize import sanitize_enabled

        self.engines = dict(engines)
        self.inner = inner if inner is not None else AnalyticBackend()
        self.tokens_per_worker_slot = float(tokens_per_worker_slot)
        self.audit = sanitize_enabled(audit)
        # request lifecycle records: job -> request_id -> stamps; the
        # backend's own attainment is computed from these (the sanitizer
        # recomputes it from the *event log* — two independent paths)
        self.requests: Dict[int, Dict[int, Dict[str, int]]] = {}
        self._finished_seen: Dict[int, int] = {}
        self.reports: List[Dict[str, object]] = []

    # -- helpers -------------------------------------------------------------
    def _attainment(self, job_id: int, slo: ServeSLO) -> float:
        recs = self.requests.get(job_id, {})
        met = total = 0
        for rid in sorted(recs):
            r = recs[rid]
            if "done" not in r:
                continue
            total += 1
            met += bool(slo.met_by(r["first"] - r["arrival"], r["n_tokens"],
                                   r["done"] - r["first"]))
        return met / total if total else 1.0

    def _enqueue_arrivals(self, execution: SlotExecution) -> None:
        from repro_torch.launch.serve import Request

        for ev in execution.pre_events:
            if not isinstance(ev, RequestArrival):
                continue
            engine = self.engines.get(ev.job_id)
            if engine is None:
                continue
            recs = self.requests.setdefault(ev.job_id, {})
            if ev.request_id in recs:
                continue  # replayed duplicate
            recs[ev.request_id] = {"arrival": ev.t}
            engine.submit(Request(
                id=ev.request_id,
                prompt=synth_prompt(ev.job_id, ev.request_id, ev.prompt_len,
                                    engine.model.cfg.vocab),
                max_new=ev.max_new))

    def _serve_ring(self, emb, execution: SlotExecution,
                    events: List[ClusterEvent],
                    ) -> Tuple[float, Optional[float], Dict[str, object]]:
        """Spend one ring's slot capacity on the engine; returns
        (factor, contention factor or None if voided, measured row)."""
        t = execution.t
        engine = self.engines[emb.job_id]
        job = execution.ctx.job(emb.job_id)
        recs = self.requests.setdefault(emb.job_id, {})
        voided, slow, cf = _slot_conditions(emb, execution)
        if voided:
            return 0.0, None, {"t": t, "voided": True, "served_tokens": 0}
        capacity = self.tokens_per_worker_slot * emb.n_workers * slow * cf
        if emb.job_id in execution.left and emb.n_workers > 0:
            capacity *= max(0.0, (emb.n_workers
                                  - execution.left[emb.job_id])
                            / emb.n_workers)
        budget = int(round(capacity))
        work = 0
        new_tokens = 0
        chunk = engine.prefill_chunk
        first_seen = len(engine.finished)
        while work < budget:
            if engine.queue and engine.free_lanes() > 0:
                req = engine.admit(limit=1)[0]
                work += chunk * math.ceil(len(req.prompt) / chunk)
                new_tokens += 1  # prefill emits the first generated token
                recs[req.id]["first"] = t
            elif engine.active.any():
                n_act = int(engine.active.sum())
                if work + n_act > budget:
                    break  # next step would overdraw the slot's capacity
                engine.step()
                work += n_act
                new_tokens += n_act
            else:
                break  # queue empty and no lane active: idle capacity
        for req in engine.finished[first_seen:]:
            recs[req.id]["done"] = t
            recs[req.id]["n_tokens"] = len(req.tokens)
        # emit the lifecycle events in deterministic request-id order
        for rid in sorted(r for r, rec in recs.items()
                          if rec.get("first") == t):
            events.append(RequestFirstToken(
                t, emb.job_id, rid, ttft_slots=t - recs[rid]["arrival"]))
        for rid in sorted(r for r, rec in recs.items()
                          if rec.get("done") == t):
            rec = recs[rid]
            events.append(RequestCompletion(
                t, emb.job_id, rid, n_tokens=rec["n_tokens"],
                ttft_slots=rec["first"] - rec["arrival"],
                decode_slots=rec["done"] - rec["first"]))
        if self.audit:
            from repro_torch.analysis.sanitize import SanitizerError
            from repro_torch.launch.serve import audit_serving_engine

            problems = audit_serving_engine(engine)
            if problems:
                raise SanitizerError(
                    f"serving engine audit failed for job {emb.job_id}: "
                    + "; ".join(problems))
        nominal = self.tokens_per_worker_slot * max(emb.n_workers, 1)
        factor = min(1.0, work / nominal)
        slo = getattr(job, "slo", None) or ServeSLO()
        row = {
            "t": t, "job_id": emb.job_id, "workers": emb.n_workers,
            "served_tokens": new_tokens, "work": work, "factor": factor,
            "backlog": len(engine.queue),
            "active_lanes": int(engine.active.sum()),
            "slo_attainment": self._attainment(emb.job_id, slo),
            "compile_count": engine.compile_count,
        }
        return factor, cf, row

    # -- the backend contract ------------------------------------------------
    def execute_slot(self, decision: SlotDecision,
                     execution: SlotExecution) -> SlotOutcome:
        self._enqueue_arrivals(execution)
        events: List[ClusterEvent] = []
        factors: Dict[int, float] = {}
        contention: List[float] = []
        measured: Dict[int, Dict[str, object]] = {}
        lost = 0
        train_idx: List[int] = []
        train_embs: List = []
        for k, emb in enumerate(decision.embeddings):
            if emb.job_id in self.engines:
                factor, cf, row = self._serve_ring(emb, execution, events)
                factors[k] = factor
                if cf is None:
                    lost += 1
                else:
                    contention.append(cf)
                measured[emb.job_id] = row
                self.reports.append(row)
            else:
                train_idx.append(k)
                train_embs.append(emb)
        if train_embs:
            sub = dataclasses.replace(decision,
                                      embeddings=tuple(train_embs))
            inner = self.inner.execute_slot(sub, execution)
            for k, f in zip(train_idx, inner.factors):
                factors[k] = f
            contention.extend(inner.contention_factors)
            lost += inner.lost
            measured.update(inner.measured)
        return SlotOutcome(
            factors=[factors[k] for k in range(len(decision.embeddings))],
            contention_factors=contention, lost=lost, measured=measured,
            events=events)
