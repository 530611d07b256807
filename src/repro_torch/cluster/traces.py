"""Job-trace replay: a documented schema, CSV/JSONL I/O, and a large-scale
synthesizer (the counterpart of ``repro.cluster.traces``, numpy only and
bit-identical to it on the same seeds).

The paper's §VI evaluation is ~60 synthetic jobs; production DDL schedulers
are operated against traces of thousands (Alibaba PAI 2020, Philly). This
module defines the in-repo trace schema those workloads are replayed
through — the external schema docs this repo once pointed at are gone, so
the schema lives here and is pinned by ``tests/test_traces.py`` (and the port by
``tests/test_torch_traces.py``).

Schema (one record per job, Alibaba-PAI-2020-like columns)
----------------------------------------------------------
``job_id``          int     unique id (becomes ``Job.id``)
``submit_slot``     int     submission time in scheduler slots (``a_i``)
``gpu_count``       int     requested GPUs = max concurrent workers (``N_i``)
``duration_slots``  float   worker-slots of GPU work per worker; the job's
                            worker-time budget is
                            ``gpu_count * duration_slots`` (paper Eq. (11):
                            min_r F_i^r / l_i^r with l_i^gpus = 1)
``bandwidth_class`` str     ``"low" | "medium" | "high"`` — reserved ring
                            bandwidth b_i (100 Mbps / 1 Gbps / 5 Gbps),
                            PAI's NVLink/RDMA/TCP tiering collapsed to three
                            classes
``priority``        float   utility scale lambda1 (PAI priority groups)

File formats: CSV with a header row in the exact column order above, or
JSONL with one object per line keyed by the column names. ``load_trace``
dispatches on the extension; both round-trip through ``save_trace``.

Replay: ``jobs_from_trace(records, seed=...)`` maps records onto
:class:`~repro_torch.core.problem.Job` — the schema fields verbatim, plus the
per-worker efficiency zeta_i and sigmoid-utility shape parameters the schema
does not carry, drawn from the paper's §VI ranges by a seeded RNG (same
seed, same jobs). ``synthesize_pai_like(n_jobs=10_000, ...)`` generates a
PAI-shaped record set directly (heavy-tailed GPU counts dominated by 1-GPU
jobs, lognormal durations, bursty arrivals) — the workload behind
``benchmarks/run.py --trace --scale-sweep``.
"""

from __future__ import annotations

import csv
import dataclasses
import json
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.problem import Job
from repro_torch.core.utility import sigmoid_utility, sqrt_utility

TRACE_COLUMNS = (
    "job_id",
    "submit_slot",
    "gpu_count",
    "duration_slots",
    "bandwidth_class",
    "priority",
)

BANDWIDTH_CLASSES = {
    "low": 100e6,     # 100 Mbps — congested TCP tier
    "medium": 1e9,    # 1 Gbps   — datacenter Ethernet
    "high": 5e9,      # 5 Gbps   — RDMA/NVLink-ish tier (paper's upper b_i)
}


@dataclasses.dataclass(frozen=True)
class TraceJobRecord:
    """One job row in the trace schema (see module docstring)."""

    job_id: int
    submit_slot: int
    gpu_count: int
    duration_slots: float
    bandwidth_class: str
    priority: float

    def __post_init__(self):
        if self.bandwidth_class not in BANDWIDTH_CLASSES:
            raise ValueError(
                f"bandwidth_class {self.bandwidth_class!r} not in "
                f"{sorted(BANDWIDTH_CLASSES)}"
            )
        if self.gpu_count < 1:
            raise ValueError(f"gpu_count must be >= 1, got {self.gpu_count}")
        if self.submit_slot < 0:
            raise ValueError(
                f"submit_slot must be >= 0, got {self.submit_slot}")
        if self.duration_slots <= 0:
            raise ValueError(
                f"duration_slots must be > 0, got {self.duration_slots}")

    @property
    def bandwidth(self) -> float:
        return BANDWIDTH_CLASSES[self.bandwidth_class]


# ---------------------------------------------------------------------------
# I/O
# ---------------------------------------------------------------------------

def _record_from_row(row: dict) -> TraceJobRecord:
    return TraceJobRecord(
        job_id=int(row["job_id"]),
        submit_slot=int(row["submit_slot"]),
        gpu_count=int(row["gpu_count"]),
        duration_slots=float(row["duration_slots"]),
        bandwidth_class=str(row["bandwidth_class"]),
        priority=float(row["priority"]),
    )


def load_trace_csv(path: Union[str, Path]) -> List[TraceJobRecord]:
    with open(path, newline="") as fh:
        reader = csv.DictReader(fh)
        missing = set(TRACE_COLUMNS) - set(reader.fieldnames or ())
        if missing:
            raise ValueError(
                f"{path}: missing trace columns {sorted(missing)}")
        return [_record_from_row(row) for row in reader]


def load_trace_jsonl(path: Union[str, Path]) -> List[TraceJobRecord]:
    out: List[TraceJobRecord] = []
    with open(path) as fh:
        for line_no, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError as exc:
                raise ValueError(f"{path}:{line_no}: invalid JSON") from exc
            out.append(_record_from_row(row))
    return out


def load_trace(path: Union[str, Path]) -> List[TraceJobRecord]:
    """Dispatch on extension: ``.csv`` or ``.jsonl``/``.json``."""
    suffix = Path(path).suffix.lower()
    if suffix == ".csv":
        return load_trace_csv(path)
    if suffix in (".jsonl", ".json"):
        return load_trace_jsonl(path)
    raise ValueError(f"unsupported trace extension {suffix!r} "
                     f"(want .csv or .jsonl)")


def save_trace(records: Sequence[TraceJobRecord],
               path: Union[str, Path]) -> None:
    """Write records in the format matching the extension (round-trips
    through the matching loader)."""
    suffix = Path(path).suffix.lower()
    if suffix == ".csv":
        with open(path, "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=TRACE_COLUMNS)
            writer.writeheader()
            for r in records:
                writer.writerow(dataclasses.asdict(r))
    elif suffix in (".jsonl", ".json"):
        with open(path, "w") as fh:
            for r in records:
                fh.write(json.dumps(dataclasses.asdict(r)) + "\n")
    else:
        raise ValueError(f"unsupported trace extension {suffix!r} "
                         f"(want .csv or .jsonl)")


# ---------------------------------------------------------------------------
# Replay: records -> Jobs
# ---------------------------------------------------------------------------

def jobs_from_trace(
    records: Iterable[TraceJobRecord],
    seed: int = 0,
    utility: str = "sigmoid",
    mem_per_worker: float = 1.0,
    zeta_range: tuple = (50.0, 500.0),
    sensitivity_range: tuple = (0.001, 0.01),
    expected_iters_range: tuple = (300.0, 3000.0),
) -> List[Job]:
    """Map trace records onto :class:`Job`s.

    Schema fields map verbatim: ``submit_slot`` -> arrival, ``gpu_count`` ->
    N_i, ``gpu_count * duration_slots`` -> GPU budget F_i (so the per-worker
    demand l_i^gpus = 1 makes the worker-time budget exactly
    gpu_count * duration_slots), ``bandwidth_class`` -> b_i, ``priority`` ->
    lambda1. zeta_i and the remaining utility shape parameters are not part
    of the schema and are drawn from the paper's §VI ranges by a seeded RNG
    — one draw sequence over the record list, so the same (records, seed)
    always yields the same jobs.
    """
    rng = np.random.default_rng(seed)
    jobs: List[Job] = []
    for rec in records:
        zeta = float(rng.uniform(*zeta_range))
        if utility == "sigmoid":
            util = sigmoid_utility(
                priority=rec.priority,
                sensitivity=float(rng.uniform(*sensitivity_range)),
                expected_iters=float(rng.uniform(*expected_iters_range)),
            )
        else:
            util = sqrt_utility(scale=rec.priority)
        jobs.append(Job(
            id=rec.job_id,
            arrival=rec.submit_slot,
            max_workers=rec.gpu_count,
            demands={"gpus": 1.0, "mem": mem_per_worker},
            budgets={"gpus": float(rec.gpu_count * rec.duration_slots)},
            bandwidth=rec.bandwidth,
            zeta=zeta,
            utility=util,
        ))
    return jobs


# ---------------------------------------------------------------------------
# Synthesis: a PAI-shaped workload at arbitrary scale
# ---------------------------------------------------------------------------

def synthesize_pai_like(
    n_jobs: int = 10_000,
    horizon: int = 200,
    seed: int = 0,
    queued_fraction: Optional[float] = None,
) -> List[TraceJobRecord]:
    """Seeded PAI-2020-shaped trace at arbitrary scale.

    Distribution shape (Weng et al., NSDI'22 characterization, coarsened):

      * GPU counts are heavy-tailed and dominated by small jobs —
        ~55% 1-GPU, ~20% 2-GPU, then 4/8/16 with geometric decay;
      * durations are lognormal (median ~8 worker-slots, long tail),
        truncated to [1, 8 * horizon];
      * arrivals are uniform-with-bursts over the horizon — a
        ``queued_fraction`` (default 0 = pure online replay) lands at slot 0
        to model a backlogged queue, the scale-sweep's "10k queued jobs"
        regime is ``queued_fraction=1.0``;
      * bandwidth class correlates with job size (big rings reserve the
        fast tier, PAI's gpu_type tiering), priority is uniform in the
        paper's lambda1 range [1, 100].
    """
    rng = np.random.default_rng(seed)
    sizes = np.array([1, 2, 4, 8, 16])
    size_p = np.array([0.55, 0.20, 0.13, 0.08, 0.04])
    gpu_counts = rng.choice(sizes, size=n_jobs, p=size_p)
    durations = np.clip(
        rng.lognormal(mean=np.log(8.0), sigma=1.0, size=n_jobs),
        1.0, 8.0 * horizon,
    )
    q = 0.0 if queued_fraction is None else float(queued_fraction)
    queued = rng.random(n_jobs) < q
    submits = rng.integers(0, max(horizon, 1), size=n_jobs)
    submits = np.where(queued, 0, submits)
    classes = np.array(["low", "medium", "high"])
    # class index drawn around the size tier: 1-2 GPU jobs mostly low/medium,
    # 8-16 GPU rings mostly high
    tier = np.digitize(gpu_counts, [2, 8])  # 0, 1, 2
    jitter = rng.integers(-1, 2, size=n_jobs)
    cls_idx = np.clip(tier + jitter, 0, 2)
    priorities = rng.uniform(1.0, 100.0, size=n_jobs)
    order = np.argsort(submits, kind="stable")
    return [
        TraceJobRecord(
            job_id=int(i),
            submit_slot=int(submits[k]),
            gpu_count=int(gpu_counts[k]),
            duration_slots=float(round(durations[k], 3)),
            bandwidth_class=str(classes[cls_idx[k]]),
            priority=float(round(priorities[k], 3)),
        )
        for i, k in enumerate(order)
    ]
