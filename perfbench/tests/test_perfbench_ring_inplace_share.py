"""``ring_inplace_share`` on summaries made by hand, each value worked out
beside it, and on small summaries recorded on the card from a program with
the ``ring.layout`` span (``record_ring_layout_summaries.py``, kept as
``data/ring_layout_summary_<cell>.json``); on the older recordings, made
before the span, it reads nothing."""

import importlib
import json
import math
from pathlib import Path

import pytest

from perfbench import harness, trace
from perfbench.kinds import train
from perfbench.metrics import ring_inplace_share
from perfbench.tests import record_ring_layout_summaries, small

DATA = Path(__file__).resolve().parent / "data"
CELLS = record_ring_layout_summaries.CELLS
OLDER = sorted(p.name for p in DATA.glob("*.json")
               if not p.name.startswith("ring_layout_summary_"))


def made_by_hand():
    names = [trace.WINDOW, "repro_torch::step.reduce", "repro_torch::ring.layout",
             "repro_torch::ring.hop", "aten::copy_", "copy_kernel"]
    ops = [[0, -1, [], [], []],
           [1, 0, [], [], []],                      # step.reduce
           [2, 1, [[], []], ["Scalar"] * 2, [4096, 0]],   # a leaf taken as views
           [3, 1, [[]], ["Scalar"], [3072]],        # its hop
           [4, 3, [], [], []],
           [2, 1, [[], []], ["Scalar"] * 2, [0, 1024]],   # a leaf copied
           [2, 1, [[]], ["Scalar"], [None]]]        # not a layout's two counts
    kernels = [[0.001, 0.000002, 5, 4]]             # under the hop
    return {"window_s": 1.0, "names": names, "ops": ops, "kernels": kernels,
            "steps": 1}


def test_ring_inplace_share_by_hand():
    assert ring_inplace_share.read(made_by_hand()) == pytest.approx(100 * 4096 / 5120)


def test_ring_inplace_share_reads_nothing_without_its_spans_or_hops():
    s = made_by_hand()
    s["names"] = [n.replace("ring.layout", "ring.other") for n in s["names"]]
    assert ring_inplace_share.read(s) is None
    assert ring_inplace_share.read(dict(made_by_hand(), kernels=[])) is None
    s = made_by_hand()
    for op in s["ops"]:
        if op[0] == 2 and len(op[4]) == 2:
            op[4] = [0, 0]                          # layouts of no bytes
    assert ring_inplace_share.read(s) is None


def copied_share(cell):
    """The share of a rank's gradient bytes the ring cannot take as views
    at the recording's small size: leaves whose size w does not divide, and
    zamba2's `embed`, whose gradient the tied head's product leaves
    transposed."""
    from repro_torch.models.model import build_model
    from repro_torch.models.module import _flatten

    conf, _ = record_ring_layout_summaries.small_inputs(cell)
    sizes = {p: math.prod(s.shape)
             for p, s in _flatten(build_model(train.port_config(conf)).param_specs())}
    tied = {"embed"} if conf["family"] == "zamba2" else set()
    copied = sum(n for p, n in sizes.items() if n % 4 or p in tied)
    return copied / sum(sizes.values())


@pytest.mark.parametrize("cell", CELLS)
def test_readers_on_summaries_recorded_with_the_layout_span(cell):
    summary = json.loads((DATA / f"ring_layout_summary_{cell}.json").read_text())
    got = ring_inplace_share.read(summary)
    assert got == pytest.approx(100 * (1 - copied_share(cell)), rel=1e-12)
    names = [m["name"] for m in harness.per_layer(small.bench(), cell)]
    assert "ring_inplace_share" in names
    for name in names:
        value = importlib.import_module(f"perfbench.metrics.{name}").read(summary)
        assert value is not None and 0 < value <= 105, (name, value)


@pytest.mark.parametrize("name", OLDER)
def test_ring_inplace_share_reads_nothing_before_the_span(name):
    assert ring_inplace_share.read(json.loads((DATA / name).read_text())) is None
