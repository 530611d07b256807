#!/usr/bin/env python3
"""Where a serving step's device time goes, on one CUDA card.

Run from the root of a checkout: ``python3 tools/serve_profile.py``. It
builds ``chip_smoke.py``'s phase-9 engine (qwen3-0.6b at full width and
depth, f32 weights from seed 0, ``ServingEngine(max_batch=8,
max_seq=1024, prefill_chunk=8)``), admits a 128-token prompt on every lane
and runs one decode step, then traces with ``torch.profiler``:

  * replays of the captured decode graph;
  * the same decode step run eagerly (the kernels' names by call site);
  * replays of the captured prefill-chunk graph (8 tokens of one lane);

and prints, for each, the device time of one call (the summed durations of
its CUDA kernels), the number of kernels, and the kernels that take most
of it, grouped by name. The last line is JSON with the same numbers.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.serve import Request, ServingEngine  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

CALLS, TOP = 5, 12


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def traced(fn, calls: int = CALLS) -> dict:
    """Device ms of one call of ``fn`` and its kernels by name, from the
    CUDA kernels ``torch.profiler`` records over ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (us + ev.device_time_total, n + 1)
    total_us = sum(us for us, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {"device_ms": total_us / calls / 1e3,
            "kernels": sum(n for _, n in by_name.values()) // calls,
            "top": [{"kernel": name[:90], "ms": us / calls / 1e3,
                     "count": n // calls} for name, (us, n) in top]}


@torch.no_grad()
def main() -> int:
    if not torch.cuda.is_available():
        print("serve_profile: needs a CUDA card", file=sys.stderr)
        return 1
    cfg = get_arch("qwen3-0.6b")
    model = build_model(cfg)
    params = model.init(0, device="cuda", dtype=torch.float32)
    engine = ServingEngine(model, params, max_batch=8, max_seq=1024,
                           prefill_chunk=8)
    rng = np.random.default_rng(2)
    for i in range(8):
        engine.submit(Request(id=i, prompt=rng.integers(0, cfg.vocab, size=128),
                              max_new=64))
    engine.admit()
    engine.step()
    dev = engine.device
    tokens = torch.as_tensor(engine.last_token[:, None]).to(dev)
    positions = torch.as_tensor(engine.positions - 1).to(dev)
    active = torch.ones(8, dtype=torch.bool, device=dev)

    def eager():
        model.decode_step_lanes(params, engine.cache, tokens, positions, active)

    graphs = engine.graphs()
    out = {"card": card(),
           "decode_graph": traced(graphs["decode"].replay),
           "decode_eager": traced(eager),
           "prefill_graph": traced(graphs["prefill"].replay)}
    for what, res in out.items():
        if what == "card":
            continue
        print(f"{what}: {res['device_ms']:.4f} ms on the device, "
              f"{res['kernels']} kernels ({out['card']})")
        for row in res["top"]:
            print(f"  {row['ms']:.4f} ms  x{row['count']}  {row['kernel']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
