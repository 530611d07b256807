"""Model flops of one training step, from a configuration's sizes and the
traffic's shape: every matrix product three times (forward, and the two
products of its backward), attention over the visible causal pairs and the
WKV as its chunked products, also three times. Recomputation is not
counted, and routed experts count at their nominal top-k. The embedding is
a lookup and counts nothing; the head counts over the unpadded vocabulary.
A family's forward count is ``perfbench/count/flops_<family>.py``.
"""

from __future__ import annotations

import importlib
from typing import Dict


def train_step_flops(conf: Dict, traffic: Dict) -> float:
    """Model flops of one training step over the traffic's global batch."""
    family = importlib.import_module(f"perfbench.count.flops_{conf['family']}")
    return 3.0 * traffic["global_batch"] * family.forward(conf["sizes"],
                                                          traffic["seq_len"])
