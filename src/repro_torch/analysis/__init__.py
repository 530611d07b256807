"""Runtime correctness checks over the port (the ported part of
``repro.analysis``): the opt-in slot sanitizer."""

from repro_torch.analysis.sanitize import (  # noqa: F401
    SanitizerError,
    SlotSanitizer,
    sanitize_enabled,
)
