"""``update_roofline`` and ``count/adamw.py`` on summaries made by hand:
each value worked out beside it, and nothing read without the operator;
then every per-layer reader, ``update_roofline`` among them, on small
summaries recorded on the card from a program with the spans and AdamW's
operator (``record_summaries.py``, kept as ``data/adamw_summary_<cell>.json``:
the benchmark's older recordings predate the operator)."""

import importlib
import json
from pathlib import Path

import pytest

from perfbench import count, harness, trace
from perfbench.count import adamw
from perfbench.metrics import update_roofline
from perfbench.tests import small

DATA = Path(__file__).resolve().parent / "data"
CELLS = ("rwkv6-7b-l4.ring-f32.w4", "phi3.5-moe-42b-l1.ring-int8.w4")

F32, BF16 = "float", "c10::BFloat16"


def leaf(shape, p_dtype, g_dtype):
    """An ``adamw_leaf`` call's recorded shapes and dtypes: p, g, m, v, the
    two 0-d bias corrections, then the five scalars."""
    return [list(shape)] * 4 + [[]] * 7, [p_dtype, g_dtype] + [F32] * 4 + ["Scalar"] * 5


def made_by_hand():
    names = [trace.WINDOW, "repro_torch::step.update", "repro_torch::adamw_leaf",
             "aten::empty", "aten::add", "adamw_kernel", "add_kernel"]
    a_shapes, a_dtypes = leaf((1000, 400), F32, F32)
    b_shapes, b_dtypes = leaf((300,), BF16, BF16)
    ops = [[0, -1, [], [], []],
           [1, 0, [], [], []],                              # step.update
           [4, 1, [[], []], [F32, "Scalar"], [None, 1]],    # step + 1, outside
           [2, 1, a_shapes, a_dtypes, [None] * 6 + [3e-4, 0.9, 0.95, 1e-8, 0.1]],
           [3, 3, [], [], []],                              # its output's allocation
           [2, 1, b_shapes, b_dtypes, [None] * 6 + [3e-4, 0.9, 0.95, 1e-8, 0.1]]]
    kernels = [[0.001, 0.000002, 6, 2],   # the step's add: not the update's
               [0.002, 0.000010, 5, 3],   # the f32 leaf's kernel
               [0.003, 0.000001, 5, 4],   # launched from inside the f32 call
               [0.004, 0.000003, 5, 5]]   # the bf16 leaf's kernel
    return {"window_s": 1.0, "names": names, "ops": ops, "kernels": kernels,
            "steps": 1}


@pytest.mark.parametrize("p_dtype,g_dtype,per_element", [
    (F32, F32, 28), (BF16, BF16, 22), (F32, BF16, 26), (BF16, F32, 24)])
def test_leaf_bytes(p_dtype, g_dtype, per_element):
    shapes, dtypes = leaf((7, 3, 5), p_dtype, g_dtype)
    assert adamw.leaf_bytes(shapes, dtypes) == 7 * 3 * 5 * per_element


def test_update_roofline_by_hand():
    got = update_roofline.read(made_by_hand())
    nbytes = 1000 * 400 * 28 + 300 * 22
    assert got == pytest.approx(100 * (nbytes / count.PEAK_BYTES) / 14e-6)


def test_update_roofline_reads_nothing_without_the_operator():
    s = made_by_hand()
    s["names"] = [n.replace("adamw_leaf", "adamw_other") for n in s["names"]]
    assert update_roofline.read(s) is None
    assert update_roofline.read(dict(made_by_hand(), kernels=[])) is None


@pytest.mark.parametrize("cell", CELLS)
def test_readers_on_summaries_recorded_with_the_operator(cell):
    summary = json.loads((DATA / f"adamw_summary_{cell}.json").read_text())
    names = [m["name"] for m in harness.per_layer(small.bench(), cell)]
    assert "update_roofline" in names
    for name in names:
        value = importlib.import_module(f"perfbench.metrics.{name}").read(summary)
        assert value is not None and 0 < value <= 105, (name, value)
    assert 0 < trace.busy_s(summary) <= summary["window_s"]
