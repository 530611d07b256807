"""Utility functions mu_i(.) for the DDLJS objective — paper §IV-3.

All utilities are non-decreasing (and, except the sigmoid used in §VI,
concave) in the accumulated worker-time ``zeta_i * sum_t sum_s y_is[t]``.
The three paper instantiations plus the experimental sigmoid:

  1. excessive training avoidance: mu(k) = C * sqrt(k)   (SGD 1/sqrt(k) rate)
  2. energy efficiency:            mu(k) = -(c2 k^2 + c1 k)  (quadratic cost)
  3. proportional fairness:        mu(k) = log(1 + k)
  4. sigmoid (paper §VI):          mu(k) = l1 / (1 + exp(-l2 (k - l3)))
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

UtilityFn = Callable[[float], float]


@dataclasses.dataclass(frozen=True)
class Utility:
    """A named utility with scalar and vectorized evaluation."""

    name: str
    fn: UtilityFn

    def __call__(self, k: float) -> float:
        return float(self.fn(k))

    def vec(self, k: np.ndarray) -> np.ndarray:
        return np.vectorize(self.fn, otypes=[np.float64])(np.asarray(k, dtype=np.float64))

    def marginal(self, base: float, add: float) -> float:
        """Incremental utility pi = mu(base + add) - mu(base)."""
        return float(self.fn(base + add) - self.fn(base))


def sqrt_utility(scale: float = 1.0) -> Utility:
    return Utility("sqrt", lambda k: scale * math.sqrt(max(k, 0.0)))


def log_utility(scale: float = 1.0) -> Utility:
    return Utility("log", lambda k: scale * math.log1p(max(k, 0.0)))


def energy_utility(c1: float = 0.0, c2: float = 1e-6) -> Utility:
    """Negative quadratic energy cost (to be maximized)."""
    return Utility("energy", lambda k: -(c2 * k * k + c1 * k))


def sigmoid_utility(priority: float, sensitivity: float, expected_iters: float) -> Utility:
    """Paper §VI: mu(k) = lambda1 / (1 + exp(-lambda2 (k - lambda3))).

    priority   lambda1 in [1, 100]
    sensitivity lambda2 in (0, 1)
    expected_iters lambda3 in [300, 3000]
    """

    def fn(k: float) -> float:
        z = -sensitivity * (k - expected_iters)
        z = max(min(z, 60.0), -60.0)  # numerically safe logistic
        return priority / (1.0 + math.exp(z))

    return Utility("sigmoid", fn)


UTILITIES = {
    "sqrt": sqrt_utility,
    "log": log_utility,
    "energy": energy_utility,
    "sigmoid": sigmoid_utility,
}
