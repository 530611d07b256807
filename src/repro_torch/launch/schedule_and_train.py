"""End-to-end: GADGET schedules real training jobs (the paper's loop), the
counterpart of ``examples/schedule_and_train.py``.

GADGET's per-slot decisions (ring size w per job) drive elastic
ring-all-reduce data-parallel training of three reduced-config models
(qwen3-0.6b, granite-3-2b, rwkv6-7b) through the execution-backend API: one
``OnlineDriver`` slot loop, a ``LiveBackend`` that binds each committed ring
to its job's ``ElasticTrainer``, a scripted mid-slot ``WorkerLeave`` that
shrinks job 0's slot-3 ring in place (re-ring, no checkpoint restore), and
measured step timings fed back through ``repro_torch.cluster.calibrate`` so
each job's Eq. (1) bandwidth tracks what the hardware delivers. Every rank
of every ring runs in this process, on one card by default.

Usage:  python -m repro_torch.launch.schedule_and_train            (the card)
        python -m repro_torch.launch.schedule_and_train --device cpu
"""

from __future__ import annotations

import argparse
import math
import tempfile
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.cluster import make_fat_tree
from repro_torch.configs import get_arch
from repro_torch.core.problem import DDLJSInstance, Job
from repro_torch.core.rar_model import profile_from_arch
from repro_torch.core.utility import sqrt_utility
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models.model import build_model
from repro_torch.sched import (
    ContentionConfig,
    LiveBackend,
    OnlineDriver,
    ScriptedEventStream,
    WorkerLeave,
    registry,
)
from repro_torch.training.elastic import ElasticTrainer
from repro_torch.training.optimizer import make_optimizer

ARCHS = ["qwen3-0.6b", "granite-3-2b", "rwkv6-7b"]
SLOTS = 6
STEPS_PER_SLOT = 4
OVERSUBSCRIPTION = 1.5  # admit rings beyond edge capacity; fair-share the link
SEQ_LEN = 32
GLOBAL_BATCH = 8
# a batch index no step reaches: every job's loss on it, before and after
# the loop, says whether training improved without the batch-to-batch noise
HELDOUT_STEP = 10 ** 6
# the trainer runs whatever ring the job's profile prices
MODE_OF_COMPRESSION = {"int8": "compressed", "int8-fused": "compressed-fused",
                       "bf16-fused": "bf16-fused", "fp8-fused": "fp8-fused"}


def make_jobs() -> List[Job]:
    jobs = []
    for i, arch in enumerate(ARCHS):
        cfg = get_arch(arch)
        # job 1 trains over the fused int8 ring (the trainer mode below is
        # derived from this field), so its Eq. (1) profile prices the
        # compressed wire bytes and the single-hop message; the uniform
        # per-message latency makes the halved message count visible
        prof = profile_from_arch(n_params=float(cfg.n_params()),
                                 tokens_per_batch=4096.0 * 8,
                                 compression="int8-fused" if i == 1 else None,
                                 message_overhead=5e-6)
        jobs.append(Job(
            id=i, arrival=i % 2, max_workers=4,
            demands={"gpus": 1.0, "mem": 1.0},
            budgets={"gpus": 40.0},
            bandwidth=30e9,  # heavy enough that rings contend on uplinks
            zeta=float(prof.iterations_per_slot(4, 60.0)) / 4.0,
            utility=sqrt_utility(10.0),
            profile=prof, arch=arch,
        ))
    return jobs


def make_trainers(jobs: Sequence[Job], device: str,
                  checkpoint_root: str) -> Dict[int, ElasticTrainer]:
    trainers = {}
    for job in jobs:
        cfg = get_arch(job.arch).reduced()
        data = SyntheticTokens(cfg.vocab, seq_len=SEQ_LEN,
                               global_batch=GLOBAL_BATCH, seed=job.id)
        mode = MODE_OF_COMPRESSION.get(job.profile.compression, "ring")
        trainers[job.id] = ElasticTrainer(
            build_model(cfg), make_optimizer("adamw"), data,
            global_batch=GLOBAL_BATCH, base_lr=3e-3, mode=mode,
            checkpoint_dir=tempfile.mkdtemp(prefix=f"job{job.id}_",
                                            dir=checkpoint_root),
            device=device)
    return trainers


@torch.no_grad()
def heldout_losses(trainers: Dict[int, ElasticTrainer]) -> Dict[int, float]:
    """Each job's loss on its held-out batch at its current parameters."""
    out = {}
    for job_id, tr in trainers.items():
        home, params = next(iter(tr.params.items()))
        batch = {k: torch.as_tensor(v).to(home)
                 for k, v in tr.data.batch(HELDOUT_STEP).items()}
        out[job_id] = float(tr.model.loss(params, batch))
    return out


def run_loop(jobs: Sequence[Job], trainers: Dict[int, ElasticTrainer]):
    """Run the loop over ``jobs`` with their trainers; returns ``(backend,
    result)``. Calibration refits the jobs' profiles in place."""
    # 1-2 GPUs per server: rings must span servers and share uplinks, so the
    # contention re-pricing actually engages (colocated rings never contend)
    graph = make_fat_tree(n_servers=4, n_racks=2, n_core=1,
                          gpus_choices=(1, 2), seed=0)
    inst = DDLJSInstance(graph=graph, jobs=list(jobs), horizon=SLOTS)
    backend = LiveBackend(trainers, steps_per_slot=STEPS_PER_SLOT)
    driver = OnlineDriver(
        inst,
        contention=ContentionConfig(oversubscription=OVERSUBSCRIPTION),
        # a scripted mid-slot departure: one of job 0's workers leaves in
        # slot 3 and the ring re-forms around the survivors (no restore)
        events=ScriptedEventStream(mid=[WorkerLeave(3, job_id=0, n=1)]),
        backend=backend,
    )
    result = driver.run(registry.create("gadget", seed=0))
    return backend, result


def slot_table(jobs, backend) -> List[str]:
    """One line per slot: each job's ring size and loss, its re-rings and a
    measured slowdown, or why it did not run."""
    by_slot: Dict[int, Dict[int, dict]] = {}
    for row in backend.reports:
        by_slot.setdefault(row["t"], {})[row["job_id"]] = row
    lines = []
    for t in range(SLOTS):
        line = []
        for job in jobs:
            if t < job.arrival:
                line.append(f"{job.arch}: not-arrived")
                continue
            row = by_slot.get(t, {}).get(job.id)
            if row is None:
                line.append(f"{job.arch}: preempted(ckpt)")
                continue
            tag = f"w={row['workers']} loss={row['loss']:.3f}"
            if row.get("re_rings"):
                tag += f" re-ring(x{row['re_rings']})"
            if row["factor"] < 0.999:
                tag += f" measured(x{row['factor']:.2f})"
            line.append(f"{job.arch}: {tag}")
        lines.append(f" slot {t}: " + " | ".join(line))
    return lines


def check_outcome(jobs, trainers, backend, result, bandwidths, heldout
                  ) -> List[str]:
    """The example's summary lines, with each job's held-out loss before
    and after (``heldout``: job id -> pair); raises where the example's
    asserts fail: a job that trained must have improved, on its held-out
    batch, and job 0's slot-3 ring must have re-rung.

    The example compares a job's first step loss with its last, two
    different batches: for reduced rwkv6-7b, whose loss stays within about
    0.15 over its eight steps here, that comparison is a coin flip of the
    initial draws, so the improvement is held on one batch instead."""
    lines = []
    for job in jobs:
        tr = trainers[job.id]
        first = tr.losses[0] if tr.losses else float("nan")
        last = tr.losses[-1] if tr.losses else float("nan")
        cal = backend.calibrated.get(job.id)
        cal_tag = (f", calibrated b {bandwidths[job.id]:.2e}->{cal:.2e} "
                   "elem/s" if cal is not None else "")
        h0, h1 = heldout[job.id]
        lines.append(f"  {job.arch}: steps={tr.step} loss {first:.3f} -> "
                     f"{last:.3f} (held-out {h0:.3f} -> {h1:.3f}, "
                     f"reshards={tr.resharding_events}, "
                     f"re-rings={tr.re_ring_events}, "
                     f"worker-time={result.state.z[job.id]:.1f}{cal_tag})")
        if not all(map(math.isfinite, tr.losses + [h0, h1])):
            raise AssertionError(f"{job.arch}: a loss is not finite")
        if tr.losses and not h1 < h0:
            raise AssertionError(f"{job.arch}: training should improve "
                                 f"(held-out {h0} -> {h1})")
    slot3 = any(r["t"] == 3 and r["job_id"] == 0 for r in backend.reports)
    if slot3 and not trainers[0].re_ring_events:
        raise AssertionError("the scripted WorkerLeave should have re-rung "
                             "job 0's slot-3 ring")
    return lines


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="device every rank runs on (default: cuda)")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="schedule_and_train_") as root:
        print(f"== GADGET driving elastic RAR training of {ARCHS} ==")
        jobs = make_jobs()
        bandwidths = {j.id: j.profile.bandwidth for j in jobs}
        trainers = make_trainers(jobs, args.device, root)
        before = heldout_losses(trainers)
        backend, result = run_loop(jobs, trainers)
        after = heldout_losses(trainers)
        for line in slot_table(jobs, backend):
            print(line)
        print("\n== outcome ==")
        heldout = {j: (before[j], after[j]) for j in before}
        for line in check_outcome(jobs, trainers, backend, result, bandwidths,
                                  heldout):
            print(line)
    return jobs, trainers, backend, result


if __name__ == "__main__":
    main()
