"""One run of each cell, driven end to end on the CPU at a small size (the
look for a chip skipped): the result line as `run.py` documents it, and
``correct`` false with the timed path broken underneath in each way a
training cell can be broken."""

import io
import json
import os
import shutil
import subprocess
import sys
import time
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest
import torch

from perfbench import harness, run
from perfbench.tests import small

ROOT = Path(__file__).resolve().parents[2]
CELLS = [c["name"] for c in small.bench()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_small(cell: str, traced: bool = False) -> dict:
    torch.manual_seed(0)
    conf, mix = small.cell_inputs(cell)
    return harness.run_cell(small.bench(), cell, seed=2**31 + 99, seconds=0.5,
                            traced=traced, device="cpu", t0=time.perf_counter(),
                            conf=conf, mix=mix)


@pytest.mark.parametrize("cell", CELLS)
def test_small_run_prints_the_result_line(cell):
    result = run_small(cell)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        run.emit(result)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[:5] == KEYS and list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {m["name"] for m in harness.end_to_end(small.bench(), cell)}
    assert all(v["value"] > 0 for k, v in line["metrics"].items() if k != "peak_gib")
    tail = err.getvalue().strip().splitlines()[-3:]
    assert [t.split()[1] for t in tail] == list(line["compared"])


def test_small_traced_run_reads_the_trace():
    result = run_small(CELLS[0], traced=True)
    assert result["correct"] is True
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device activity: every reader finds nothing but the
    # whole step's share
    assert set(result["metrics"]) <= {"step_mfu"}


def _unchanged(monkeypatch):
    from repro_torch.training.elastic import RingWorkerGroup

    inner = RingWorkerGroup.step
    monkeypatch.setattr(RingWorkerGroup, "step", lambda self, params, opt, shards: (
        params, opt, inner(self, params, opt, shards)[2]))


def _half(monkeypatch):
    from repro_torch.training.elastic import RingWorkerGroup

    inner = RingWorkerGroup.shard_batch

    def half(self, batch):
        shards = inner(self, batch)
        return shards[:len(shards) // 2] * 2
    monkeypatch.setattr(RingWorkerGroup, "shard_batch", half)


def _exchange(monkeypatch):
    from repro_torch.training import train_step

    for mode in ("ring", "compressed-fused"):
        monkeypatch.setitem(train_step.LEAF_COLLECTIVES, mode,
                            lambda xs, ring: [x.clone() for x in xs])


def _token(monkeypatch):
    from repro_torch.training.elastic import RingWorkerGroup

    inner = RingWorkerGroup.shard_batch

    def altered(self, batch):
        shards = inner(self, batch)
        tokens = shards[0]["tokens"]
        tokens[0, tokens.shape[1] // 2] = (tokens[0, tokens.shape[1] // 2] + 1) % 7
        return shards
    monkeypatch.setattr(RingWorkerGroup, "shard_batch", altered)


FAULTS = {"state unchanged": _unchanged, "half the batch": _half,
          "no exchange": _exchange, "a token altered": _token}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = run_small(cell)
    assert result["correct"] is False, result["compared"]


def test_command_without_a_card_prints_no_result(tmp_path):
    cmd = [sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed",
           "3000000000", "--seconds", "1", "--trace", "0"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=env)
    assert done.returncode != 0 and "{" not in done.stdout
    # a checkout of the benchmark's files alone has no program to run
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bare = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert bare.returncode != 0 and "{" not in bare.stdout
