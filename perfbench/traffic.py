"""The general generator of the benchmark's traffic: every mix is a data
file ``perfbench/traffic/<name>.json`` of parameters that this module
reads.

A training mix feeds token batches that are a pure function of ``(seed,
step)``: a random walk over the vocabulary, each row from a random start
in steps drawn uniformly from ``[step_low, step_high]`` (the pattern of the
program's synthetic pipeline, frozen here so that later changes to the
program cannot change the benchmark's inputs). Labels are the tokens one
place on, the last wrapping to the first. Every row of every step differs.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


def load(name: str) -> Dict:
    """The parameters of the traffic mix ``name``."""
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


class TokenWalk:
    """Step-indexed token batches: ``batch(step)`` gives ``{"tokens",
    "labels"}``, int32 arrays of ``(global_batch, seq_len)``."""

    def __init__(self, mix: Dict, vocab: int, seed: int):
        if seed < 0:
            raise ValueError(f"seed must be >= 0, got {seed}")
        self.vocab = int(vocab)
        self.seq_len = int(mix["seq_len"])
        self.global_batch = int(mix["global_batch"])
        self.low = int(mix["tokens"]["step_low"])
        self.high = int(mix["tokens"]["step_high"])
        self.seed = int(seed)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng([self.seed, int(step)])
        b, s = self.global_batch, self.seq_len
        start = rng.integers(0, self.vocab, size=(b, 1))
        steps = rng.integers(self.low, self.high + 1, size=(b, s - 1))
        walk = np.concatenate([start, steps], axis=1).cumsum(axis=1)
        tokens = np.mod(walk, self.vocab).astype(np.int32)
        labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
        return {"tokens": tokens, "labels": labels.astype(np.int32)}
