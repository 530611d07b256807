"""Record the small traced-run summaries that the metric readers' tests read
(``perfbench/tests/data/summary_<cell>.json``), on the card:

    PYTHONPATH=src python3 perfbench/tests/record_summaries.py OUT_DIR

Each is one traced slot of one step of a cell at a small size whose head
sizes the kernels take, so that every reader finds something to read.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import harness  # noqa: E402
from perfbench.kinds import train  # noqa: E402
from perfbench.tests import small  # noqa: E402

CARD_SIZES = {"rwkv": {"hidden_size": 128, "head_size": 64},
              "moe": {"hidden_size": 128, "head_dim": 32}}
CARD_FIELDS = {"rwkv": {"d_model": 128, "rwkv_head_dim": 64},
               "moe": {"d_model": 128, "head_dim": 32}}


def trimmed(summary: dict) -> dict:
    """The summary with only the ops that launched device work or enclose
    one that did, renumbered."""
    ops = summary["ops"]
    keep = set()
    for k in summary["kernels"]:
        op = k[3]
        while op >= 0 and op not in keep:
            keep.add(op)
            op = ops[op][1]
    order = sorted(keep)
    new = {old: i for i, old in enumerate(order)}
    out = dict(summary)
    out["ops"] = [[ops[o][0], new.get(ops[o][1], -1)] + ops[o][2:] for o in order]
    out["kernels"] = [k[:3] + [new.get(k[3], -1)] for k in summary["kernels"]]
    return out


def record(cell: str, out: Path) -> None:
    conf, mix = small.cell_inputs(cell, seq=128)
    conf["sizes"].update(CARD_SIZES[conf["family"]])
    conf["port"]["fields"].update(CARD_FIELDS[conf["family"]])
    mix["steps_per_slot"] = 1
    got = train.run(cell, conf, mix, seed=1, seconds=0.0, traced=True,
                    device="cuda", t0=0.0)
    (out / f"summary_{cell}.json").write_text(json.dumps(trimmed(got["summary"])))
    print(cell, len(got["summary"]["kernels"]), "kernels", got["numbers"])


if __name__ == "__main__":
    out = Path(sys.argv[1])
    out.mkdir(parents=True, exist_ok=True)
    for name in ("rwkv6-7b-l4.ring-f32.w4", "phi3.5-moe-42b-l1.ring-int8.w4"):
        record(name, out)
    assert not harness.forbidden_modules()
