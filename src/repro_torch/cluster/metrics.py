"""Comparison metrics across schedulers (feeds the paper's Fig. 4-6), the
counterpart of ``repro.cluster.metrics``.

Consumes :class:`repro_torch.sched.api.SimResult`; the makespan and queueing-delay
columns are derived from the driver's typed event log (EmbeddingCommitted /
JobCompletion events), not from scheduler-internal state.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.sched.api import SimResult


def summarize(results: Sequence[SimResult]) -> List[Dict[str, float]]:
    rows = []
    for r in results:
        rows.append(
            {
                "scheduler": r.scheduler,
                "total_utility": round(r.total_utility, 3),
                "embedded_ratio": round(r.embedded_ratio(), 4),
                "avg_jct_slots": round(r.avg_jct(), 2),
                # event-log-derived: slots until the last job completes (nan
                # while any job is unfinished at the horizon)
                "makespan": round(r.makespan(), 1),
                # event-log-derived: mean first-embedding slot minus arrival
                "mean_queue_delay": round(r.avg_queueing_delay(), 2),
                "mean_gpu_util": round(
                    float(np.mean([rec.gpu_utilization for rec in r.records])), 4
                ),
                "worker_time_total": round(
                    float(sum(rec.effective_worker_time for rec in r.records)), 1
                ),
                # contention accounting (reserved/capacity > 1 ⇒ fair-sharing)
                "peak_edge_contention": round(
                    float(max((rec.max_edge_contention for rec in r.records),
                              default=0.0)), 4
                ),
                "mean_contention_factor": round(
                    float(np.mean([rec.mean_contention_factor
                                   for rec in r.records])), 4
                ),
                "slots_lost_to_failures": int(
                    sum(rec.lost_embeddings for rec in r.records)
                ),
            }
        )
    return rows


def csv_lines(rows: List[Dict[str, float]]) -> List[str]:
    if not rows:
        return []
    keys = list(rows[0])
    out = [",".join(keys)]
    for row in rows:
        out.append(",".join(str(row[k]) for k in keys))
    return out
