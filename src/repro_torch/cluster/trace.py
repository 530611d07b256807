"""Job trace generation — paper §VI-1 settings.

Arrival pattern follows the Google cluster trace's bursty character
(Reiss et al., SoCC'12): exponential inter-arrivals modulated by a diurnal
rate profile with occasional bursts. Job parameters are drawn uniformly from
the paper's ranges:

  N_i in [1,5], F_i in [1000,6000] (GPU-iteration budget), zeta_i in [50,500],
  b_i in [100 Mbps, 5 Gbps]; sigmoid utility lambda1 in [1,100],
  lambda2 in (0,1), lambda3 in [300,3000].
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional

import numpy as np

from repro_torch.core.problem import Job
from repro_torch.core.rar_model import RarJobProfile, profile_from_arch
from repro_torch.core.utility import sigmoid_utility, sqrt_utility


@dataclasses.dataclass
class JobTraceConfig:
    n_jobs: int = 60
    horizon: int = 200
    mean_interarrival: float = 2.0     # slots; modulated by diurnal profile
    burst_prob: float = 0.08           # prob. a slot spawns an arrival burst
    burst_size: int = 4
    n_workers_range: tuple = (1, 5)    # N_i
    budget_range: tuple = (1000, 6000)  # F_i (gpu-iteration budget)
    zeta_range: tuple = (50, 500)      # iterations per worker-slot
    bandwidth_range: tuple = (100e6, 5e9)  # b_i
    mem_per_worker: float = 1.0
    utility: str = "sigmoid"           # "sigmoid" | "sqrt"
    priority_range: tuple = (1, 100)   # lambda1
    sensitivity_range: tuple = (0.001, 0.01)  # lambda2 (scaled for iter counts)
    expected_iters_range: tuple = (300, 3000)  # lambda3
    seed: int = 0


def generate_jobs(cfg: JobTraceConfig) -> List[Job]:
    rng = np.random.default_rng(cfg.seed)
    # --- arrival times: bursty modulated Poisson (Google-trace-like) -------
    # the process runs unclamped: once t crossed the horizon, the old code
    # froze it at horizon-1 and every remaining arrival (plus its bursts)
    # piled onto the final slot — large n_jobs traces ended in a spike of
    # unrunnable jobs. Overflow is instead rescaled affinely onto the
    # horizon below, preserving the monotone inter-arrival structure; runs
    # that never overflow are bit-identical to the pre-fix generator.
    raw: List[float] = []
    t = 0.0
    while len(raw) < cfg.n_jobs:
        diurnal = 1.0 + 0.6 * np.sin(2 * np.pi * (t / max(cfg.horizon, 1)))
        gap = rng.exponential(cfg.mean_interarrival / max(diurnal, 0.2))
        t += gap
        raw.append(t)
        if rng.random() < cfg.burst_prob:
            for _ in range(cfg.burst_size):
                if len(raw) >= cfg.n_jobs:
                    break
                raw.append(t + float(rng.integers(0, 2)))
    raw = raw[: cfg.n_jobs]
    peak = max(raw)
    if peak >= cfg.horizon:
        scale = (cfg.horizon - 1) / peak
        warnings.warn(
            f"arrival process overran the horizon (last arrival at slot "
            f"{peak:.1f} >= {cfg.horizon}); rescaling inter-arrival times "
            f"by {scale:.3f} — lower n_jobs, raise horizon, or raise "
            f"mean_interarrival to avoid the compression",
            stacklevel=2,
        )
        raw = [x * scale for x in raw]
    arrivals = sorted(int(x) for x in raw)

    jobs: List[Job] = []
    for i, a in enumerate(arrivals):
        zeta = float(rng.uniform(*cfg.zeta_range))
        budget = float(rng.integers(cfg.budget_range[0], cfg.budget_range[1] + 1))
        if cfg.utility == "sigmoid":
            util = sigmoid_utility(
                priority=float(rng.uniform(*cfg.priority_range)),
                sensitivity=float(rng.uniform(*cfg.sensitivity_range)),
                expected_iters=float(rng.uniform(*cfg.expected_iters_range)),
            )
        else:
            util = sqrt_utility(scale=float(rng.uniform(*cfg.priority_range)))
        jobs.append(
            Job(
                id=i,
                arrival=int(a),
                max_workers=int(rng.integers(cfg.n_workers_range[0],
                                             cfg.n_workers_range[1] + 1)),
                demands={"gpus": 1.0, "mem": cfg.mem_per_worker},
                budgets={"gpus": budget},
                bandwidth=float(rng.uniform(*cfg.bandwidth_range)),
                zeta=zeta,
                utility=util,
            )
        )
    return jobs


def jobs_from_archs(
    arch_params: dict,
    cfg: JobTraceConfig,
    slot_seconds: float = 60.0,
) -> List[Job]:
    """Trace whose jobs are the assigned architectures: zeta_i derived from
    Eq. (1) profiles built from the real configs (DESIGN.md §2 coupling)."""
    rng = np.random.default_rng(cfg.seed + 1)
    base = generate_jobs(cfg)
    names = list(arch_params)
    for j in base:
        name = names[int(rng.integers(0, len(names)))]
        n_params, tokens = arch_params[name]
        prof = profile_from_arch(n_params=n_params, tokens_per_batch=tokens)
        j.profile = prof
        j.arch = name
        # zeta: iterations per worker-slot at the job's max ring size
        w = max(1, j.max_workers)
        iters = float(prof.iterations_per_slot(w, slot_seconds))
        j.zeta = max(iters / w, 1e-3)
    return base
