"""Continuous-batching serving across architecture families + co-scheduling
(the port of ``examples/serve_batched.py``).

Two demos:

  1. **Engine** — a :class:`~repro_torch.launch.serve.ServingEngine` per
     family (KV cache for attention archs, ring-buffer KV for SWA, recurrent
     state for Mamba2/RWKV6) serving a staggered burst of requests through
     one fixed-shape decode step: requests admit onto free cache lanes
     mid-run, retire on EOS/max_new without draining the batch, and the
     engine ends the run with each of its three steps captured once (built
     once on the CPU) whatever the batch composition looked like.
  2. **Co-scheduling** — the same engine driven *by the GADGET scheduler*
     (resolved through ``repro_torch.sched.registry``): a training job and
     a ``ServeJob`` share a scarce 4-GPU cluster, a scripted diurnal burst
     of inference requests lands mid-run, and the slot-by-slot worker split
     shows the serving burst reclaiming workers from the training ring
     through the utility/Eq. (1) pricing — then handing them back once the
     backlog clears. The driver runs under the sanitizer, which re-derives
     the SLO attainment from the event log every slot.

Reduced configs with f32 weights (as ``repro_torch.launch.serve``'s CLI;
the reference's example draws its weights in the specs' bf16). Each demo
raises if a check fails: an unclean audit, a request not served, a step
captured more than once, a burst that takes no workers or keeps them, an
attainment the backend reports apart from the log's. The last line of
stdout is a JSON summary.

Usage:  PYTHONPATH=src python -m repro_torch.launch.serve_batched
        [--device cpu]   (the card without the flag)
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.cluster.topology import Link, Server, SubstrateGraph
from repro_torch.configs import get_arch
from repro_torch.core.problem import DDLJSInstance, Job
from repro_torch.core.utility import sqrt_utility
from repro_torch.launch.serve import (
    Request,
    ServingEngine,
    audit_serving_engine,
    serve_requests,
)
from repro_torch.models.model import build_model
from repro_torch.sched import (
    DiurnalRequestStream,
    EmbeddingCommitted,
    OnlineDriver,
    RequestStreamConfig,
    ServeSLO,
    ServingBackend,
    make_serve_job,
    slo_attainment_from_events,
)

ARCHS = ["qwen3-0.6b", "h2o-danube-1.8b", "zamba2-1.2b", "rwkv6-7b"]
N_REQUESTS = 6
HORIZON, BURST_START = 16, 6

# (arch, model, device) -> parameters on ``device``
ParamsFactory = Callable[[str, object, str], dict]


def seeded_params(arch: str, model, device: str) -> dict:
    """The default weights: f32, drawn from seed 0 on ``device``."""
    return model.init(0, device=device, dtype=torch.float32)


def engine_captures(engine: ServingEngine) -> tuple:
    """(decode, prefill, zero-lane) captures on the card, builds on the CPU."""
    return (engine.compile_count, engine.prefill_compile_count,
            engine.aux_compile_count)


def engine_demo(device: str = "cuda",
                params: Optional[ParamsFactory] = None) -> Dict[str, dict]:
    """Each of ``ARCHS`` (reduced) serves 6 staggered requests on 3 lanes;
    returns per arch the served requests' tokens, the captures and the
    throughput."""
    params = params or seeded_params
    print("== continuous batching per family "
          f"({N_REQUESTS} staggered requests, 3 lanes) ==")
    out = {}
    for arch in ARCHS:
        cfg = get_arch(arch).reduced()
        model = build_model(cfg)
        engine = ServingEngine(model, params(arch, model, device), max_batch=3,
                               max_seq=32, prefill_chunk=4)
        rng = np.random.default_rng(5)
        reqs = [Request(id=i,
                        prompt=rng.integers(0, cfg.vocab, size=6,
                                            dtype=np.int32),
                        max_new=8, arrival=4 * i)
                for i in range(N_REQUESTS)]
        t0 = time.perf_counter()
        serve_requests(engine, reqs)
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        dt = time.perf_counter() - t0
        problems = audit_serving_engine(engine)
        captures = engine_captures(engine)
        served = len(engine.finished)
        if problems or captures != (1, 1, 1) or served != N_REQUESTS:
            raise RuntimeError(f"{arch}: audit {problems}, captures "
                               f"{captures}, served {served}/{N_REQUESTS}")
        toks = sum(len(r.tokens) for r in engine.finished)
        cache_kind = {
            "dense": "ring-buffer KV" if cfg.sliding_window else "KV",
            "hybrid": "SSM state + shared-attn KV",
            "rwkv": "WKV state",
        }.get(cfg.family, "KV")
        print(f"{arch:18s} cache={cache_kind:24s} {toks / dt:7.1f} tok/s  "
              f"decode_compiles={engine.compile_count}  "
              f"served={served}/{N_REQUESTS}")
        out[arch] = {"tokens": {r.id: list(r.tokens) for r in reqs},
                     "captures": list(captures), "served": served,
                     "tokens_per_s": toks / dt, "device": str(engine.device)}
    return out


def coschedule_demo(device: str = "cuda",
                    params: Optional[ParamsFactory] = None) -> dict:
    """GADGET with a training job and a serve job whose burst starts at
    slot 6; returns each job's workers a slot, the served tokens a slot and
    the SLO attainment (from the log and as the backend reports it)."""
    params = params or seeded_params
    print("\n== GADGET co-scheduling: burst reclaims workers from training ==")
    servers = [Server(i, 0, {"gpus": 2.0, "mem": 8.0}) for i in range(2)]
    links = []
    for s in servers:
        links += [Link(s.node, "r0", 100.0), Link("r0", s.node, 100.0)]
    graph = SubstrateGraph(servers, links, n_racks=1, n_core=0)
    horizon, burst_start = HORIZON, BURST_START

    train = Job(id=0, arrival=0, max_workers=4,
                demands={"gpus": 1.0, "mem": 1.0}, budgets={"gpus": 500.0},
                bandwidth=5.0, zeta=1.0, utility=sqrt_utility(4.0))
    slo = ServeSLO(ttft_slots=2, tpot_slots=1.0, weight=80.0)
    serve = make_serve_job(1, arrival=burst_start, offered_tokens=800.0,
                           slo=slo, tokens_per_worker_slot=64.0,
                           max_workers=3, bandwidth=5.0)
    inst = DDLJSInstance(graph=graph, jobs=[train, serve], horizon=horizon)

    arch = "qwen3-0.6b"
    model = build_model(get_arch(arch).reduced())
    engine = ServingEngine(model, params(arch, model, device), max_batch=4,
                           max_seq=32, prefill_chunk=4)
    stream = DiurnalRequestStream(RequestStreamConfig(
        job_id=1, start=burst_start, base_rate=2.0, burst_prob=0.6,
        burst_size=4, prompt_len=(4, 8), max_new=(3, 6), seed=7))
    backend = ServingBackend({1: engine}, tokens_per_worker_slot=64.0)

    # scheduler resolved by name through the registry, like any other run
    res = OnlineDriver(inst, events=stream, backend=backend,
                       sanitize=True).run("gadget")

    workers = {0: dict.fromkeys(range(horizon), 0),
               1: dict.fromkeys(range(horizon), 0)}
    for e in res.events:
        if isinstance(e, EmbeddingCommitted):
            workers[e.job_id][e.t] += e.n_workers
    served = {r["t"]: r["served_tokens"] for r in backend.reports
              if "served_tokens" in r}
    print("slot  train  serve  served_tokens")
    for t in range(horizon):
        marker = "  <- burst starts" if t == burst_start else ""
        print(f"{t:4d}  {workers[0][t]:5d}  {workers[1][t]:5d}  "
              f"{served.get(t, 0):13d}{marker}")
    attainment = slo_attainment_from_events(res.events, 1, slo)
    reported = backend.reports[-1]["slo_attainment"]
    print(f"SLO attainment (from event log): {attainment:.3f}   "
          f"decode_compiles={engine.compile_count}")
    burst = range(burst_start, horizon)
    if not (all(workers[0][t] == 4 and workers[1][t] == 0
                for t in range(burst_start))
            and min(workers[0][t] for t in burst) <= 2
            and max(workers[1][t] for t in burst) >= 2
            and workers[0][horizon - 1] == 4):
        raise RuntimeError(f"the burst did not take training workers and "
                           f"hand them back: {workers}")
    if reported != attainment or engine.compile_count != 1:
        raise RuntimeError(f"attainment reported {reported}, from the log "
                           f"{attainment}; decode captures "
                           f"{engine.compile_count}")
    return {"workers": {j: [w[t] for t in range(horizon)]
                        for j, w in workers.items()},
            "served_tokens": [served.get(t, 0) for t in range(horizon)],
            "slo_attainment": attainment, "reported_attainment": reported,
            "captures": list(engine_captures(engine)),
            "device": str(engine.device)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve_batched",
        description="Continuous batching per family, then GADGET "
                    "co-scheduling a serve job beside training (the card "
                    "by default).")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    summary = {"engines": engine_demo(args.device),
               "coschedule": coschedule_demo(args.device)}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
