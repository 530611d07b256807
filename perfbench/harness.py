"""One run of one cell, found by its name in ``BENCHMARK.json``: the
cell's configuration (``perfbench/configs/<config>.json``), its traffic
mix (``perfbench/traffic/<traffic>.json``, whose ``kind`` names the module
``perfbench/kinds/<kind>.py`` that runs it), its limits
(``perfbench/limits/<cell>.json``, of the numbers that the kind
declares) and, in a traced run, each per-layer
metric that the cell reports, read by ``perfbench/metrics/<name>.py``.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

from perfbench import check, traffic

HERE = Path(__file__).resolve().parent
CONFIG_DIR = HERE / "configs"
# top-level module names that no process of the benchmark may load: the JAX
# package beside the program, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_config(name: str) -> Dict:
    return json.loads((CONFIG_DIR / f"{name}.json").read_text())


def cell_of(bench: Dict, name: str) -> Dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[c['name'] for c in bench['workloads']]}")


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(bench: Dict, cell: str) -> List[Dict]:
    return [m for m in bench["end_to_end"] if _applies(m, cell)]


def per_layer(bench: Dict, cell: str) -> List[Dict]:
    """The cell's per-layer metrics: those that list it, and those without a
    list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, whole, is one of FORBIDDEN."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reports it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(bench: Dict, name: str, *, seed: int, seconds: float, traced: bool,
             device, t0: float, conf: Optional[Dict] = None,
             mix: Optional[Dict] = None) -> Dict:
    """The result line's object for one run of cell ``name`` (``conf`` and
    ``mix`` override the cell's configuration and traffic files, for a run
    at a smaller size)."""
    import torch

    cell = cell_of(bench, name)
    conf = conf or load_config(cell["config"])
    mix = mix or traffic.load(cell["traffic"])
    kind = importlib.import_module(f"perfbench.kinds.{mix['kind']}")
    limits = check.load_limits(name, kind.NUMBERS)
    out = kind.run(name, conf, mix, seed=seed, seconds=seconds, traced=traced,
                   device=device, t0=t0)
    numbers = out["numbers"]
    correct = check.judge(numbers, limits) and out["failed"] == 0
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": cell["chips"], "memory_peak_bytes": out["peak_bytes"]}
    if dev.type == "cuda":
        info["power_limit"] = power_limit()
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": {}, "device": info}
    if traced:
        from perfbench import trace

        summary = out["summary"]
        info["busy_s"] = trace.busy_s(summary)
        info["window_s"] = summary["window_s"]
        for metric in per_layer(bench, name):
            reader = importlib.import_module(f"perfbench.metrics.{metric['name']}")
            value = reader.read(summary)
            if value is not None:
                result["metrics"][metric["name"]] = {"value": value,
                                                     "unit": metric["unit"]}
        result["breakdown"] = trace.breakdown(summary)
    else:
        for metric in end_to_end(bench, name):
            result["metrics"][metric["name"]] = {
                "value": out["values"][metric["name"]], "unit": metric["unit"]}
    result["phases"] = out["phases"]
    result["compared"] = {k: {"value": numbers[k], "limit": limits[k]}
                          for k in limits}
    return result
