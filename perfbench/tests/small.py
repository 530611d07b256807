"""The benchmark's configurations and traffic at a size the CPU runs in
seconds: every width cut, the structure (families, ring modes, schedules)
kept."""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Dict

from perfbench import harness, traffic

ROOT = Path(__file__).resolve().parents[2]
SIZES = {
    "rwkv": ({"num_hidden_layers": 1, "hidden_size": 64, "head_size": 32,
              "intermediate_size": 128, "vocab_size": 256},
             {"n_layers": 1, "d_model": 64, "rwkv_head_dim": 32, "d_ff": 128,
              "vocab": 256, "remat": False}),
    "moe": ({"num_hidden_layers": 1, "hidden_size": 64, "num_attention_heads": 4,
             "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 96,
             "num_local_experts": 4, "vocab_size": 200},
            {"n_layers": 1, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
             "head_dim": 16, "moe_dff": 96, "n_experts": 4,
             "vocab": 200, "remat": False}),
}


def bench() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_inputs(name: str, seq: int = 32) -> tuple:
    """(configuration, traffic) of cell ``name`` at the small size."""
    cell = harness.cell_of(bench(), name)
    conf = copy.deepcopy(harness.load_config(cell["config"]))
    sizes, fields = SIZES[conf["family"]]
    conf["sizes"].update(sizes)
    conf["port"]["fields"].update(fields)
    mix = dict(traffic.load(cell["traffic"]), seq_len=seq)
    return conf, mix
