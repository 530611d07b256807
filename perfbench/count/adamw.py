"""The bytes of one AdamW leaf update, counted from the call's recorded
inputs alone, whatever implements it: the parameter p and its gradient g
(each f32 or bf16) first, then the f32 moments m and v. p, g, m and v are
read once and the new p, m and v written once: 2 |p| + |g| + 16 bytes an
element, 28 with f32 p and g and 22 with bf16. Its few operations an
element count for nothing against the card's operations-per-byte line."""

from __future__ import annotations

from perfbench.count import elem_bytes, numel

MOMENT_BYTES = 4   # m and v, f32


def leaf_bytes(shapes, dtypes) -> float:
    """Bytes of one call from its recorded shapes and dtypes (p, g first)."""
    per_element = 2 * elem_bytes(dtypes[0]) + elem_bytes(dtypes[1]) + 4 * MOMENT_BYTES
    return float(numel(shapes[0]) * per_element)
