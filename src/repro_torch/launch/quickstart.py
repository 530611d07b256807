"""Quickstart: schedule ring-all-reduce DDL jobs with GADGET (the port of
``examples/quickstart.py``).

Runs the full paper pipeline on a small cluster in a few seconds:
fat-tree substrate -> Google-trace-style arrivals -> online temporally greedy
(Algorithm 1) with per-slot G-VNE embedding (Algorithm 2) -> comparison
against FIFO / DRF / LAS, all resolved by name from the scheduler registry
and driven by the event-driven ``repro_torch.sched.OnlineDriver``.

The scheduler half is numpy on the host and uses no device, so this script
takes no ``--device``: it prints the same lines as the reference's example.

Usage:  PYTHONPATH=src python -m repro_torch.launch.quickstart
"""

from repro_torch.cluster import make_fat_tree
from repro_torch.cluster.metrics import csv_lines, summarize
from repro_torch.cluster.trace import JobTraceConfig, generate_jobs
from repro_torch.core.problem import DDLJSInstance
from repro_torch.core.rar_model import optimal_worker_count, profile_from_arch
from repro_torch.sched import FaultConfig, OnlineDriver, registry


def main() -> None:
    # 1) Eq. (1) in isolation: the per-iteration time model for a 1.2B job
    prof = profile_from_arch(n_params=1.2e9, tokens_per_batch=4096 * 8)
    print("== Eq. (1): RAR iteration time vs ring size ==")
    for w in (1, 2, 4, 8):
        print(f"  w={w}: tau = {float(prof.iteration_time(w)):.3f}s")
    print(f"  throughput-optimal ring size: {optimal_worker_count(prof, 16)}")

    # 2) the scheduling problem: 16 servers, 40 jobs, 40 slots
    graph = make_fat_tree(n_servers=16, seed=1)
    jobs = generate_jobs(JobTraceConfig(n_jobs=40, horizon=40,
                                        mean_interarrival=1.0, seed=2))
    inst = DDLJSInstance(graph=graph, jobs=jobs, horizon=40)

    print("\n== GADGET vs baselines (40 jobs / 16 servers / 40 slots) ==")
    print("  registered schedulers:", ", ".join(registry.available()))
    results = [OnlineDriver(inst).run(registry.create(name, seed=0))
               for name in ("gadget", "fifo", "drf", "las")]
    for line in csv_lines(summarize(results)):
        print(" ", line)

    # 3) with failures + stragglers (fault-tolerant scheduling): the same
    # driver, now fed a seeded fault event stream
    print("\n== GADGET under faults (5% server fail, 10% stragglers) ==")
    driver = OnlineDriver(inst, faults=FaultConfig(server_fail_prob=0.05,
                                                   straggler_prob=0.10,
                                                   seed=3))
    res = driver.run("gadget")
    print(f"  total_utility={res.total_utility:.2f} "
          f"embedded_ratio={res.embedded_ratio():.3f} "
          f"avg_queue_delay={res.avg_queueing_delay():.2f} slots "
          f"(failure slots: {sum(r.failed_servers for r in res.records)})")


if __name__ == "__main__":
    main()
