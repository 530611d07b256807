"""Calibrate Eq. (1) bandwidth from measured ring-all-reduce timings (the
counterpart of ``repro.cluster.calibrate``).

Timings of ring all-reduces (or of whole train steps, as
``sched.backend.LiveBackend`` feeds them) are fitted to the Eq. (1)
communication model:

    t(w, d) = x * slope + overhead,   x = d (w-1)/w,   slope = 2/b + 1/G

A linear least-squares over (x, t) yields ``slope`` and ``overhead``; given a
reduction throughput G (or attributing everything to the wire with G -> inf)
the calibrated per-hop bandwidth is ``b = 2 / (slope - 1/G)``.

:func:`measure_ring_timings` (and ``python -m repro_torch.cluster.calibrate``)
times the port's f32 ``dist.collectives.ring_all_reduce`` over a
``LocalRing`` whose ranks all live on one device, in this process, as the
reference times its ring over one process's devices. Each hop is then a
copy within that device, so on one card the fitted ``b`` is the bandwidth
of a device-to-device copy, not of a wire between cards.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.rar_model import RarJobProfile
from repro_torch.dist.collectives import LocalRing, ring_all_reduce


@dataclasses.dataclass(frozen=True)
class RingTimingSample:
    """One measured all-reduce: ring size ``world``, per-worker gradient size
    ``n_elements`` (the paper's d), wall-clock ``seconds`` per collective."""

    world: int
    n_elements: int
    seconds: float

    @property
    def comm_load(self) -> float:
        """x = d (w-1)/w — the Eq. (1) per-worker wire+reduce load."""
        return self.n_elements * (self.world - 1.0) / max(self.world, 1)


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    bandwidth: float        # fitted b, elements/sec
    overhead: float         # fitted per-collective latency gamma, seconds
    slope: float            # 2/b + 1/G, sec per element of comm load
    residual: float         # RMS fit residual, seconds
    n_samples: int


def fit_comm_model(
    samples: Sequence[RingTimingSample],
    reduce_speed: float = float("inf"),
) -> CalibrationResult:
    """Least-squares fit of t = x*slope + overhead over samples with w >= 2.

    ``reduce_speed`` is the assumed G (elements/sec); the default inf
    attributes the whole slope to the wire (a conservative bandwidth
    estimate: the true b is at least as large).
    """
    usable = [s for s in samples if s.world >= 2 and s.seconds > 0]
    if len(usable) < 2:
        raise ValueError("fit_comm_model: need >= 2 samples with world >= 2")
    x = np.array([s.comm_load for s in usable])
    t = np.array([s.seconds for s in usable])
    A = np.stack([x, np.ones_like(x)], axis=1)
    (slope, overhead), *_ = np.linalg.lstsq(A, t, rcond=None)
    slope = float(slope)
    overhead = float(max(overhead, 0.0))
    if slope <= 0.0:
        raise ValueError(
            f"fit_comm_model: fitted slope {slope:.3e} s/elem is not "
            f"positive — the timings show no dependence on the comm load "
            f"(too noisy, or a single load level)"
        )
    inv_g = 1.0 / reduce_speed if np.isfinite(reduce_speed) else 0.0
    wire = slope - inv_g
    if wire <= 0.0:
        raise ValueError(
            f"fit_comm_model: fitted slope {slope:.3e} s/elem <= 1/G "
            f"{inv_g:.3e} — the measured timings are inconsistent with the "
            f"assumed reduction throughput G={reduce_speed:.3e}; pass a "
            f"smaller reduce_speed (or the default inf) instead"
        )
    residual = float(np.sqrt(np.mean((A @ [slope, overhead] - t) ** 2)))
    return CalibrationResult(
        bandwidth=2.0 / wire,
        overhead=overhead,
        slope=slope,
        residual=residual,
        n_samples=len(usable),
    )


def calibrate_profile(
    profile: RarJobProfile,
    samples: Sequence[RingTimingSample],
    *,
    use_overhead: bool = False,
) -> RarJobProfile:
    """Replace ``profile.bandwidth`` with the value fitted from measurements.

    The profile's own ``reduce_speed`` is held fixed so the fit only
    re-attributes the wire term; ``use_overhead=True`` also adopts the fitted
    per-iteration latency gamma.
    """
    fit = fit_comm_model(samples, reduce_speed=profile.reduce_speed)
    updates = {"bandwidth": fit.bandwidth}
    if use_overhead:
        updates["overhead"] = fit.overhead
    return dataclasses.replace(profile, **updates)


def load_timings(path: str) -> List[RingTimingSample]:
    """Read a JSON list of {world, n_elements, seconds} records."""
    with open(path) as f:
        raw = json.load(f)
    return [
        RingTimingSample(
            world=int(r["world"]),
            n_elements=int(r["n_elements"]),
            seconds=float(r["seconds"]),
        )
        for r in raw
    ]


def dump_timings(samples: Iterable[RingTimingSample], path: str) -> None:
    with open(path, "w") as f:
        json.dump([dataclasses.asdict(s) for s in samples], f, indent=1)


# ---------------------------------------------------------------------------
# Measurement: a LocalRing of w ranks on one device
# ---------------------------------------------------------------------------

def measure_ring_timings(
    worlds: Sequence[int] = (2, 4, 8),
    n_elements: Sequence[int] = (1 << 14, 1 << 16, 1 << 18),
    repeats: int = 5,
    device="cuda",
) -> List[RingTimingSample]:
    """Time the f32 ``ring_all_reduce`` over a ``LocalRing`` of w ranks, all
    on ``device``, for every (world, size) of the grid (worlds below 2 are
    skipped, as in the reference; every other world runs, since one device
    holds any number of ranks). One warm call, then the best of
    ``repeats`` wall times, each ended by a device sync on a card."""
    dev = torch.device(device)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out: List[RingTimingSample] = []
    for w in worlds:
        if w < 2:
            continue
        ring = LocalRing([dev] * w)
        for d in n_elements:
            xs = [torch.ones(d, dtype=torch.float32, device=dev)
                  for _ in range(w)]
            ring_all_reduce(xs, ring)  # warm up
            sync()
            best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                ring_all_reduce(xs, ring)
                sync()
                best = min(best, time.perf_counter() - t0)
            out.append(RingTimingSample(world=w, n_elements=d, seconds=best))
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Record ring timings to JSON and print the fit (in this process)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.cluster.calibrate",
        description="Time the f32 ring all-reduce over a LocalRing of 2, 4 "
                    "and 8 ranks on one device and fit Eq. (1) to it.")
    parser.add_argument("--out", default="ring_timings.json")
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    samples = measure_ring_timings(repeats=args.repeats, device=args.device)
    dump_timings(samples, args.out)
    fit = fit_comm_model(samples)
    print(f"recorded {len(samples)} samples -> {args.out}; "
          f"fitted b={fit.bandwidth:.3e} elems/s, "
          f"gamma={fit.overhead * 1e6:.1f} us, rms={fit.residual:.2e}s "
          f"(every rank on {args.device}: b is a copy within that device, "
          f"not a wire between devices)")


if __name__ == "__main__":
    main()
