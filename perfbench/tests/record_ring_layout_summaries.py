"""Record the small traced-run summaries of the f32 ring's cells that
``test_perfbench_ring_inplace_share.py`` reads
(``perfbench/tests/data/ring_layout_summary_<cell>.json``), on the card:

    PYTHONPATH=src python3 perfbench/tests/record_ring_layout_summaries.py OUT_DIR

One traced slot of one step of each cell at the small sizes of
``record_summaries.py`` and ``record_zamba2_summary.py``. Beside the ops
that launched device work, each summary keeps every span of the program and
the ops it ran inside: a ``ring.layout`` span that took its chunks as views
launches nothing.
"""

import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import harness, traffic  # noqa: E402
from perfbench.kinds import train  # noqa: E402
from perfbench.tests import record_summaries, record_zamba2_summary  # noqa: E402

CELLS = ("rwkv6-7b-l4.ring-f32.w4", "phi3.5-moe-42b-l1.ring-f32.w4",
         "zamba2-7b-l12.ring-f32.w4")
PROGRAM = "repro_torch::"


def trimmed(summary: dict) -> dict:
    """The summary with only the ops that launched device work or are spans
    of the program, and the ops they ran inside, renumbered."""
    names, ops = summary["names"], summary["ops"]
    keep = set()
    starts = [k[3] for k in summary["kernels"]]
    starts += [i for i, op in enumerate(ops) if names[op[0]].startswith(PROGRAM)]
    for op in starts:
        while op >= 0 and op not in keep:
            keep.add(op)
            op = ops[op][1]
    order = sorted(keep)
    new = {old: i for i, old in enumerate(order)}
    out = dict(summary)
    out["ops"] = [[ops[o][0], new.get(ops[o][1], -1)] + ops[o][2:] for o in order]
    out["kernels"] = [k[:3] + [new.get(k[3], -1)] for k in summary["kernels"]]
    return out


def small_inputs(cell: str) -> tuple:
    """(configuration, traffic) of ``cell`` at the recorders' small size."""
    spec = harness.cell_of(json.loads((ROOT / "BENCHMARK.json").read_text()), cell)
    conf = copy.deepcopy(harness.load_config(spec["config"]))
    family = conf["family"]
    if family in record_summaries.CARD_SIZES:
        from perfbench.tests import small
        conf, mix = small.cell_inputs(cell, seq=128)
        conf["sizes"].update(record_summaries.CARD_SIZES[family])
        conf["port"]["fields"].update(record_summaries.CARD_FIELDS[family])
    else:
        conf["sizes"].update(record_zamba2_summary.SIZES)
        conf["port"]["fields"].update(record_zamba2_summary.FIELDS)
        mix = dict(traffic.load(spec["traffic"]), seq_len=128)
    mix["steps_per_slot"] = 1
    return conf, mix


def record(cell: str, out: Path, device: str = "cuda") -> dict:
    conf, mix = small_inputs(cell)
    got = train.run(cell, conf, mix, seed=1, seconds=0.0, traced=True,
                    device=device, t0=0.0)
    summary = trimmed(got["summary"])
    (out / f"ring_layout_summary_{cell}.json").write_text(json.dumps(summary))
    print(cell, len(got["summary"]["kernels"]), "kernels", got["numbers"])
    return summary


if __name__ == "__main__":
    out = Path(sys.argv[1])
    out.mkdir(parents=True, exist_ok=True)
    for name in CELLS:
        record(name, out)
    assert not harness.forbidden_modules()
