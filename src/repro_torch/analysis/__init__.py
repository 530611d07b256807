"""Correctness checks over the port (the ported part of ``repro.analysis``).

  * :mod:`repro_torch.analysis.lint` — AST lint over ``src/repro_torch``
    with the reference's determinism/accounting rules (torch's global
    generator included in ``unseeded-rng``) and a checked-in baseline
    (``python -m repro_torch.analysis.lint``).
  * :mod:`repro_torch.analysis.sanitize` — the opt-in runtime sanitizer
    (``OnlineDriver(sanitize=True)`` / ``REPRO_SANITIZE=1``): per-slot
    domain-invariant assertions.
  * :mod:`repro_torch.analysis.collectives` — the collective verifier:
    every registered ring variant and train-step mode recorded over a
    ``RecordingRing`` and checked on four axes (ring topology, differential
    deadlock order, Eq. (1) pricing, recompile hazards)
    (``python -m repro_torch.analysis.collectives``).
  * :mod:`repro_torch.analysis.fixtures` — the verifier's seeded mutation
    suite: one deliberately broken ring for each axis, which must fire.
  * :mod:`repro_torch.analysis.kernels` — the launch-config checker of the
    CUDA kernels: threads, shared memory, grid and instantiated shapes
    against Hopper's limits, the hop message's trailer, and on the card each
    kernel's resources and blocks per SM
    (``python -m repro_torch.analysis.kernels``).
  * :mod:`repro_torch.analysis.baseline` — the suppression ledger the lint
    and the verifier gate on.

The package exports the sanitizer and the baseline API; the lint, the
verifier and the checker are reached as ``repro_torch.analysis.<name>``
(imported here, ``python -m`` would load them twice).
"""

from repro_torch.analysis.baseline import (  # noqa: F401
    Baseline,
    apply_baseline,
    write_baseline,
)
from repro_torch.analysis.sanitize import (  # noqa: F401
    SanitizerError,
    SlotSanitizer,
    sanitize_enabled,
)
