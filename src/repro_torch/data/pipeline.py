"""Deterministic synthetic token pipeline.

Batches are a pure function of (seed, step): the same global batch is
produced regardless of DP degree or restart point, which makes elastic
resharding and checkpoint-resume bit-reproducible (tested). A real deployment
swaps this for a sharded file reader with the same step-indexed contract.

The token stream is a structured Markov-ish sequence (not iid uniform) so
that models actually have something to learn in the end-to-end examples.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        b, s = self.global_batch, self.seq_len
        # structured stream: random walk over the vocab with bursts
        start = rng.integers(0, self.vocab, size=(b, 1))
        steps = rng.integers(-3, 4, size=(b, s - 1))
        walk = np.concatenate([start, steps], axis=1).cumsum(axis=1)
        tokens = np.mod(walk, self.vocab).astype(np.int32)
        labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
        return {"tokens": tokens, "labels": labels.astype(np.int32)}
