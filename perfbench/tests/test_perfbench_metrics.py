"""Each per-layer metric reader on a summary made by hand (the value worked
out beside it), and on small summaries recorded from traced runs on the
card (``record_summaries.py``)."""

import importlib
import json
from pathlib import Path

import pytest

from perfbench import count, trace
from perfbench.count import ring
from perfbench.tests import small

DATA = Path(__file__).resolve().parent / "data"
READERS = [m["name"] for m in small.bench()["per_layer"]]
WKV = [[1, 64, 2, 64]] * 4 + [[2, 64], []]
FA = [[1, 64, 4, 32], [1, 64, 2, 32], [1, 64, 2, 32], [], [], []]


def made_by_hand():
    names = [trace.WINDOW, trace.RING, "aten::mm", "aten::copy_",
             "repro_torch::wkv6_fwd", "repro_torch::flash_attention_fwd",
             "mm_kernel", "copy_kernel",
             "void (anonymous namespace)::quantize_pack_kernel<Int8Wire>(float const*)",
             "wkv_kernel", "fa_kernel", "aten::to"]
    ops = [[0, -1, [], [], []],
           [2, 0, [[128, 64], [64, 32]], ["float", "float"], [None, None]],
           [1, 0, [], [], []],
           [3, 2, [[10], [10]], ["float", "float"], [None, None]],
           [4, 0, WKV, ["float"] * 6, [None] * 6],
           [11, 4, [[1]], ["float"], [None]],
           [5, 0, FA, ["float"] * 6, [None, None, None, True, None, 0]]]
    kernels = [[0.0, 0.1, 6, 1], [0.2, 0.05, 7, 3], [0.3, 0.01, 8, 2],
               [0.4, 0.015, 9, 4], [0.415, 0.005, 7, 5], [0.5, 0.03, 10, 6]]
    return {"window_s": 1.0, "names": names, "ops": ops, "kernels": kernels,
            "steps": 2, "step_flops": 1e12,
            "ring": {"wire": "int8", "workers": 4, "leaf_sizes": [10_000]}}


def read(name, summary):
    return importlib.import_module(f"perfbench.metrics.{name}").read(summary)


def test_readers_by_hand():
    s = made_by_hand()
    assert read("device_idle_share", s) == pytest.approx(100 * (1 - 0.21))
    assert read("step_mfu", s) == pytest.approx(100 * 2e12 / 495e12)
    mm = count.bound_s(2 * 128 * 32 * 64, 4 * (128 * 64 + 64 * 32 + 128 * 32))
    assert read("matmul_roofline", s) == pytest.approx(100 * mm / 0.1)
    assert read("ring_device_share", s) == pytest.approx(100 * 0.06)
    # B8's device time counts what ran inside its operator, copies too
    wkv = count.bound_s(*count.wkv6("fwd", WKV, ["float"] * 6))
    assert read("b8_roofline", s) == pytest.approx(100 * wkv / 0.02)
    fa = count.bound_s(*count.flash_attention("fwd", FA, ["float"] * 6))
    assert read("b4_roofline", s) == pytest.approx(100 * fa / 0.03)
    launches, nbytes = ring.all_reduce_calls(10_000, 4)["quantize_pack_kernel"]
    assert read("ring_kernel_roofline", s) == pytest.approx(
        100 * (nbytes / launches / count.PEAK_BYTES) / 0.01)


def test_readers_find_nothing_without_their_work():
    s = made_by_hand()
    s["kernels"] = [k for k in s["kernels"] if k[3] in (1, 3)]
    s["ring"]["wire"] = "f32"
    for name in ("b8_roofline", "b4_roofline", "ring_kernel_roofline"):
        assert read(name, s) is None
    assert read("device_idle_share", dict(s, kernels=[])) is None


def test_breakdown_by_hand():
    got = trace.breakdown(made_by_hand())
    assert got["device_ops"][0] == ["mm_kernel", 0.1]
    gaps = dict(got["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(0.1)
    assert gaps["(after the last launch)"] == pytest.approx(0.47)


def test_parents_link_by_interval():
    ops = [[0, -1, [], [], []] for _ in range(4)]
    trace._link_parents([(0, 100, 0), (10, 50, 1), (20, 30, 2), (60, 90, 3)], ops)
    assert [o[1] for o in ops] == [-1, 0, 1, 0]


@pytest.mark.parametrize("cell", ["rwkv6-7b-l4.ring-f32.w4",
                                  "phi3.5-moe-42b-l1.ring-int8.w4"])
def test_readers_on_recorded_summaries(cell):
    summary = json.loads((DATA / f"summary_{cell}.json").read_text())
    bench = small.bench()
    from perfbench import harness

    for metric in harness.per_layer(bench, cell):
        value = read(metric["name"], summary)
        assert value is not None and 0 < value <= 105, (metric["name"], value)
    assert 0 < trace.busy_s(summary) <= summary["window_s"]
