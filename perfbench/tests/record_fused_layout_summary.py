"""Record the small traced-run summary of the int8 cell that
``test_perfbench_fused_inplace_share.py`` reads
(``perfbench/tests/data/fused_layout_summary_<cell>.json``), on the card:

    PYTHONPATH=src python3 perfbench/tests/record_fused_layout_summary.py OUT_DIR

One traced slot of one step at the small size of ``record_summaries.py``,
trimmed as ``record_ring_layout_summaries.py`` trims: beside the ops that
launched device work, every span of the program and the ops it ran inside
(a ``fused.layout`` span launches nothing where no chunk is padded).
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import harness  # noqa: E402
from perfbench.kinds import train  # noqa: E402
from perfbench.tests import record_ring_layout_summaries as layout  # noqa: E402

CELL = "phi3.5-moe-42b-l1.ring-int8.w4"


def record(out: Path, device: str = "cuda") -> dict:
    conf, mix = layout.small_inputs(CELL)
    got = train.run(CELL, conf, mix, seed=1, seconds=0.0, traced=True,
                    device=device, t0=0.0)
    summary = layout.trimmed(got["summary"])
    (out / f"fused_layout_summary_{CELL}.json").write_text(json.dumps(summary))
    print(CELL, len(got["summary"]["kernels"]), "kernels", got["numbers"])
    return summary


if __name__ == "__main__":
    out = Path(sys.argv[1])
    out.mkdir(parents=True, exist_ok=True)
    record(out)
    assert not harness.forbidden_modules()
