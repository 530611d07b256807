"""The operations and bytes of one call of B9, Mamba2's SSD scan, counted
from the recorded shapes of ``repro_torch::ssd_scan_fwd`` (x, dt, A, B, C
and the initial state first) and ``repro_torch::ssd_scan_bwd`` (x, dt, A,
B, C, the chunk states, dy, the final state's gradient and
``with_initial``), whatever implements them (:mod:`perfbench.count`'s
rules: inputs read once, outputs written once)."""

from __future__ import annotations

from typing import Sequence, Tuple

from perfbench import count

# the chunk at which the SSD's operations are counted (the chunked
# products of the scan); a definition of the count, not the kernels' tiling
SSD_COUNT_CHUNK = 64


def forward_ops(b: int, s: int, h: int, p: int, n: int, g: int) -> float:
    """The chunked products of the forward at :data:`SSD_COUNT_CHUNK`: per
    batch row and chunk, ``C B^T`` over the chunk's causal pairs once per
    B/C group (2N a pair); per head, the intra-chunk ``M xf`` over those
    pairs (2P a pair), the chunk's summary ``B^T xf`` and the readout ``C
    S`` (2LNP each)."""
    lc = min(SSD_COUNT_CHUNK, s)
    nc = -(-s // lc)
    pairs = lc * (lc + 1) // 2
    return float(b * nc * (g * pairs * 2 * n + h * (pairs * 2 * p + 4 * lc * n * p)))


def ssd_scan(direction: str, shapes: Sequence, dtypes: Sequence,
             *, with_initial: bool = False) -> Tuple[float, float]:
    """(operations, bytes) of one SSD call. x ``(B, S, H, P)``, dt ``(B,
    S, H)``, A ``(H,)``, B and C ``(B, S, N)`` or ``(B, S, G, N)``.
    Operations: :func:`forward_ops`; the backward twice the forward's.
    Bytes, forward: every tensor input read once (a carried state among
    them), y in x's dtype and the f32 final state written. Backward: x,
    dt, A, B, C, dy and the final state's gradient read once; dx, d(dt),
    dA, dB and dC written in their inputs' dtypes and, ``with_initial``,
    the initial state's f32 gradient. The chunk states that a forward saves
    for its backward (the backward's sixth input) are the implementation's
    choice and counted on neither side."""
    b, s, h, p = shapes[0]
    bc = shapes[3]
    g = bc[2] if len(bc) == 4 else 1
    n = bc[-1]
    ops = forward_ops(b, s, h, p, n, g)
    state = b * h * n * p * 4
    ins = count._tensor_bytes(shapes[:5], dtypes[:5])
    if direction == "fwd":
        return ops, float(count._tensor_bytes(shapes, dtypes)
                          + count.numel(shapes[0]) * count.elem_bytes(dtypes[0]) + state)
    reads = count._tensor_bytes(shapes[:5] + shapes[6:8], dtypes[:5] + dtypes[6:8])
    return 2.0 * ops, float(reads + ins + (state if with_initial else 0))
