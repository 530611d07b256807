"""Shared suppression-baseline plumbing for the analysis CLIs (copied from
``repro.analysis.baseline``).

The AST-level checkers — :mod:`repro_torch.analysis.lint` here, and
``repro.analysis.lint`` and ``repro.analysis.collectives`` in the
reference — gate CI on "no findings outside the checked-in baseline". The
format is one suppression per line::

    rule:relative/path.py:Qual.symbol  # one-line justification

Keys carry no line numbers (entries survive unrelated edits); one entry
suppresses every same-key finding. Three failure classes keep the ledger
honest:

  * a finding without an entry is **new** — fix it or add a justified line;
  * an entry whose finding no longer fires is **stale** — debt that was
    paid off must leave the ledger, delete the line;
  * an entry whose justification is missing *or still the bootstrap
    placeholder* (``TODO``-prefixed, what ``--write-baseline`` emits) is
    **malformed** — a freshly regenerated baseline fails the gate until a
    human replaces every placeholder with a real justification, so
    ``--write-baseline`` can never be used to bulk-silence findings.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Sequence, Tuple

__all__ = ["PLACEHOLDER_JUSTIFICATION", "Baseline", "apply_baseline",
           "write_baseline"]

# what --write-baseline emits as the justification; Baseline.load treats any
# TODO-prefixed justification as malformed, so written entries fail the gate
# until a human replaces the placeholder
PLACEHOLDER_JUSTIFICATION = "TODO justify"


@dataclasses.dataclass
class Baseline:
    entries: Dict[str, str]   # key -> justification
    malformed: List[str]      # lines with a missing/placeholder justification

    @classmethod
    def load(cls, path: str) -> "Baseline":
        entries: Dict[str, str] = {}
        malformed: List[str] = []
        if not os.path.exists(path):
            return cls(entries, malformed)
        with open(path) as f:
            for raw in f:
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                key, sep, why = line.partition("  # ")
                key = key.strip()
                why = why.strip()
                if not sep or not why or why.startswith("TODO"):
                    malformed.append(line)
                    continue
                entries[key] = why
        return cls(entries, malformed)


def apply_baseline(
    findings: Sequence, baseline: Baseline
) -> Tuple[List, List[str]]:
    """(new findings, stale baseline keys) for items exposing ``.key``."""
    seen_keys = {f.key for f in findings}
    new = [f for f in findings if f.key not in baseline.entries]
    stale = sorted(k for k in baseline.entries if k not in seen_keys)
    return new, stale


def write_baseline(path: str, keys: Iterable[str], *, tool: str) -> int:
    """Write a bootstrap baseline with placeholder justifications.

    Returns the entry count. Every written line carries
    :data:`PLACEHOLDER_JUSTIFICATION`, which ``Baseline.load`` rejects as
    malformed — the file documents the debt but does not silence it.
    """
    unique = sorted(set(keys))
    with open(path, "w") as f:
        f.write(f"# {tool} baseline — pre-existing debt.\n"
                "# One suppression per line: rule:path:symbol"
                "  # justification\n"
                "# Placeholder (TODO...) justifications still FAIL the "
                "gate: replace each\n# with a real one-line rationale.\n")
        for key in unique:
            f.write(f"{key}  # {PLACEHOLDER_JUSTIFICATION}\n")
    return len(unique)
