"""Correctness checks over the port (the ported part of ``repro.analysis``).

  * :mod:`repro_torch.analysis.lint` — AST lint over ``src/repro_torch``
    with the reference's determinism/accounting rules (torch's global
    generator included in ``unseeded-rng``) and a checked-in baseline
    (``python -m repro_torch.analysis.lint``).
  * :mod:`repro_torch.analysis.sanitize` — the opt-in runtime sanitizer
    (``OnlineDriver(sanitize=True)`` / ``REPRO_SANITIZE=1``): per-slot
    domain-invariant assertions.
  * :mod:`repro_torch.analysis.baseline` — the suppression ledger the lint
    gates on.

The package exports the sanitizer and the baseline API; the lint is reached
as ``repro_torch.analysis.lint`` (imported here, ``python -m`` would load it
twice).
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
