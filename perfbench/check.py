"""The verdict ``correct`` from a cell's compared numbers.

A kind of cell (``perfbench/kinds/<kind>.py``) declares the numbers it can
compare (``NUMBERS``) and works them out; a cell compares those that its
file ``perfbench/limits/<cell>.json`` gives a limit, and only those
(``PERF.md`` says why a cell compares one number in place of another). A
number that is not finite fails.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Sequence

LIMITS_DIR = Path(__file__).resolve().parent / "limits"


def load_limits(cell: str, numbers: Sequence[str]) -> Dict[str, float]:
    """The cell's compared numbers and their limits; ``numbers`` are those
    that the cell's kind works out."""
    data = json.loads((LIMITS_DIR / f"{cell}.json").read_text())
    limits = {k: float(v) for k, v in data["limits"].items()}
    unknown = set(limits) - set(numbers)
    if unknown or not limits:
        raise ValueError(f"{cell}: limits for {sorted(unknown)}; numbers are "
                         f"{tuple(numbers)}")
    return limits


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number that has a limit is finite and within it."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)
