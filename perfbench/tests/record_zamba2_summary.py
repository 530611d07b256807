"""Record the small traced-run summary that ``test_perfbench_zamba2.py``'s
readers read (``perfbench/tests/data/zamba2_summary_<cell>.json``), on the
card:

    PYTHONPATH=src python3 perfbench/tests/record_zamba2_summary.py OUT_DIR

One traced slot of one step of the Zamba2 cell at a small size whose
shapes the kernels take (B4 at head_dim 224, B9 at state 16 and head_dim
32 with two B/C groups), so that every reader of the cell finds something
to read.
"""

import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import harness, traffic  # noqa: E402
from perfbench.kinds import train  # noqa: E402
from perfbench.tests.record_summaries import trimmed  # noqa: E402

CELL = "zamba2-7b-l12.ring-f32.w4"
SIZES = {"num_hidden_layers": 3, "hidden_size": 224, "attention_hidden_size": 448,
         "num_attention_heads": 2, "num_key_value_heads": 2, "attention_head_dim": 224,
         "intermediate_size": 256, "adapter_rank": 8, "hybrid_layer_ids": [1, 2],
         "mamba_d_state": 16, "mamba_headdim": 32, "n_mamba_heads": 14,
         "vocab_size": 512}
FIELDS = {"n_layers": 3, "d_model": 224, "n_heads": 2, "n_kv_heads": 2, "head_dim": 224,
          "d_ff": 256, "vocab": 512, "ssm_state": 16, "ssm_head_dim": 32,
          "hybrid_layers": [1, 2], "adapter_rank": 8}


def record(out: Path) -> None:
    spec = harness.cell_of(json.loads((ROOT / "BENCHMARK.json").read_text()), CELL)
    conf = copy.deepcopy(harness.load_config(spec["config"]))
    conf["sizes"].update(SIZES)
    conf["port"]["fields"].update(FIELDS)
    mix = dict(traffic.load(spec["traffic"]), seq_len=128, steps_per_slot=1)
    got = train.run(CELL, conf, mix, seed=1, seconds=0.0, traced=True,
                    device="cuda", t0=0.0)
    (out / f"zamba2_summary_{CELL}.json").write_text(json.dumps(trimmed(got["summary"])))
    print(CELL, len(got["summary"]["kernels"]), "kernels", got["numbers"])


if __name__ == "__main__":
    out = Path(sys.argv[1])
    out.mkdir(parents=True, exist_ok=True)
    record(out)
