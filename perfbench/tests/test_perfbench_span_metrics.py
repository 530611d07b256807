"""The readers of the program's spans (``repro_torch::step.grads``,
``step.reduce``, ``ring.hop``, ``step.update``, ``step.batch``,
``slot.form``) on a summary made by hand, each value worked out beside it,
and each reader finding nothing without its spans; then every per-layer
reader on small summaries recorded on the card with the program's spans
(``data/spans_summary_<cell>.json``), and the span readers finding nothing in
those recorded from a program without them (``data/summary_<cell>.json``)."""

import importlib
import json
from pathlib import Path

import pytest

from perfbench import count, harness, trace
from perfbench.tests import small

DATA = Path(__file__).resolve().parent / "data"
CELLS = ("rwkv6-7b-l4.ring-f32.w4", "phi3.5-moe-42b-l1.ring-int8.w4")
SPAN_READERS = ("grads_device_ms", "update_device_ms", "ring_reduce_device_ms",
                "ring_hop_roofline", "boundary_idle_ms")


def made_by_hand():
    names = [trace.WINDOW, "repro_torch::step", "repro_torch::step.batch",
             "aten::copy_", "repro_torch::step.grads", "aten::mm",
             "autograd::engine::evaluate_function: MmBackward0",
             "repro_torch::step.reduce", "repro_torch::ring.hop",
             "repro_torch::step.update", "aten::add_",
             "Memcpy HtoD (Pageable -> Device)", "mm_kernel",
             "Memcpy DtoD (Device -> Device)", "add_kernel"]
    ops = [[0, -1, [], [], []],
           [1, 0, [[], []], ["Scalar", "Scalar"], [7, 4]],     # step 7, w=4
           [2, 1, [], [], []],                                  # step.batch
           [3, 2, [[2, 8], [2, 8]], ["long", "long"], [None, None]],
           [4, 1, [[]], ["Scalar"], [0]],                       # step.grads, rank 0
           [5, 4, [[8, 4], [4, 4]], ["float", "float"], [None, None]],
           # the backward, launched by the engine from a thread of its own
           [6, -1, [], [], []],
           [5, 6, [[8, 4], [4, 4]], ["float", "float"], [None, None]],
           [7, 1, [[], []], ["Scalar", "Scalar"], [4, 2]],      # step.reduce
           [8, 8, [[], []], ["Scalar", "Scalar"], [4_000, 4]],  # a hop
           [3, 9, [[250], [250]], ["float", "float"], [None, None]],
           [8, 8, [[], []], ["Scalar", "Scalar"], [6_000, 4]],  # a hop
           [3, 11, [[375], [375]], ["float", "float"], [None, None]],
           [9, 1, [[]], ["Scalar"], [1]],                       # step.update
           [10, 13, [[16], [16]], ["float", "float"], [None, None]]]
    kernels = [[0.10, 0.01, 11, 3],     # idle 0.10 before it: under step.batch
               [0.20, 0.30, 12, 5],     # idle 0.09: under step.grads
               [0.50, 0.20, 12, 7],     # the backward, no gap
               [0.72, 0.002, 13, 10],   # idle 0.02: under a hop
               [0.722, 0.003, 13, 12],
               [0.73, 0.05, 14, 14]]    # idle 0.005: under step.update
    return {"window_s": 1.0, "names": names, "ops": ops, "kernels": kernels,
            "steps": 2, "step_flops": 1e12,
            "ring": {"wire": "f32", "workers": 4, "leaf_sizes": [2_500]}}


def read(name, summary):
    return importlib.import_module(f"perfbench.metrics.{name}").read(summary)


def test_span_readers_by_hand():
    s = made_by_hand()
    # the forward under the span and the engine's backward, over 2 steps
    assert read("grads_device_ms", s) == pytest.approx(1000 * (0.30 + 0.20) / 2)
    assert read("update_device_ms", s) == pytest.approx(1000 * 0.05 / 2)
    assert read("ring_reduce_device_ms", s) == pytest.approx(1000 * 0.005 / 2)
    # 10,000 bytes sent, read and written once each, in 5 ms
    assert read("ring_hop_roofline", s) == pytest.approx(
        100 * (2 * 10_000 / count.PEAK_BYTES) / 0.005)
    # the gap ended under step.batch and the one after the last launch
    assert read("boundary_idle_ms", s) == pytest.approx(1000 * (0.10 + 0.22) / 2)


def test_boundary_counts_gaps_ended_between_steps():
    s = made_by_hand()
    # the first launch outside every step and every backward: a step boundary
    s["ops"][3][1] = 0
    s["ops"][2][1] = 0
    assert read("boundary_idle_ms", s) == pytest.approx(1000 * (0.10 + 0.22) / 2)
    # the same launch inside the step, outside its batch: not the boundary
    s["ops"][3][1] = 1
    assert read("boundary_idle_ms", s) == pytest.approx(1000 * 0.22 / 2)


def test_boundary_leaves_out_gaps_ended_by_unlinked_launches():
    s = made_by_hand()
    # the first launch linked to no host op, as a launch the profiler could
    # not link: it may lie inside a step, so its gap is not the boundary's
    s["kernels"][0][3] = -1
    assert read("boundary_idle_ms", s) == pytest.approx(1000 * 0.22 / 2)
    # nor is the gap an unlinked launch ends inside the step's grads
    s = made_by_hand()
    s["kernels"][1][3] = -1
    assert read("boundary_idle_ms", s) == pytest.approx(1000 * (0.10 + 0.22) / 2)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_find_nothing_without_their_spans(name):
    s = made_by_hand()
    s["names"] = [n.replace("repro_torch::", "other::") for n in s["names"]]
    assert read(name, s) is None
    assert read(name, dict(made_by_hand(), kernels=[])) is None


@pytest.mark.parametrize("cell", CELLS)
def test_readers_on_summaries_recorded_with_spans(cell):
    summary = json.loads((DATA / f"spans_summary_{cell}.json").read_text())
    for metric in harness.per_layer(small.bench(), cell):
        value = read(metric["name"], summary)
        assert value is not None and 0 < value <= 105, (metric["name"], value)
    assert 0 < trace.busy_s(summary) <= summary["window_s"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_leave_out_a_program_without_spans(cell, name):
    summary = json.loads((DATA / f"summary_{cell}.json").read_text())
    assert read(name, summary) is None
