"""The frozen arithmetic of the benchmark: the card's peaks, and the
operations and bytes of one call of each kernel family, counted from the
call's shapes alone, whatever implements it.

Every bound is ``max(operations / PEAK_FLOPS, bytes / PEAK_BYTES)``. Each
input byte counts as read once and each output byte as written once.
Products of f32 inputs are held to the dense TF32 tensor-core rate, the
fastest the card can multiply f32 inputs, so a faster route than today's
never reads above 100%.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

# NVIDIA H100 SXM5 80GB data sheet, dense (no sparsity), at its 700 W limit
PEAK_FLOPS = 495e12        # TF32 tensor cores: products of f32 inputs
PEAK_BYTES = 3.35e12       # HBM3 bytes/s

DTYPE_BYTES = {"float": 4, "float32": 4, "double": 8, "float64": 8,
               "c10::Half": 2, "half": 2, "float16": 2, "c10::BFloat16": 2,
               "bfloat16": 2, "signed char": 1, "int8": 1, "unsigned char": 1,
               "c10::Float8_e4m3fn": 1, "int": 4, "long int": 8, "long": 8,
               "bool": 1}

# the chunk length at which the WKV's operations are counted (the chunked
# products of the RWKV-6 recurrence); a definition of the count, not the
# kernels' own tiling
WKV_COUNT_CHUNK = 32


def elem_bytes(dtype: Optional[str]) -> int:
    """Bytes of one element of a dtype as the profiler names it; f32 when
    the profiler gives none."""
    return DTYPE_BYTES.get(dtype or "float", 4)


def numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take for a call."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def matmul(name: str, shapes, dtypes) -> Optional[Tuple[float, float]]:
    """(operations, bytes) of one recorded ``aten`` matrix product, or None
    for a call whose shapes are not those of a product. ``addmm`` and
    ``baddbmm`` take their bias first; the bias is read once and the add
    counted with the product."""
    op = name.split("::")[-1]
    if op in ("addmm", "baddbmm"):
        shapes, dtypes = shapes[1:], dtypes[1:]
    if op not in ("mm", "addmm", "bmm", "baddbmm") or len(shapes) < 2:
        return None
    a, b = shapes[0], shapes[1]
    if op in ("mm", "addmm") and len(a) == 2 and len(b) == 2:
        batch, (m, k), n = 1, a, b[1]
    elif op in ("bmm", "baddbmm") and len(a) == 3 and len(b) == 3:
        batch, m, k, n = a[0], a[1], a[2], b[2]
    else:
        return None
    ops = 2.0 * batch * m * n * k
    out = batch * m * n * elem_bytes(dtypes[0])
    ins = numel(a) * elem_bytes(dtypes[0]) + numel(b) * elem_bytes(dtypes[1])
    if name.split("::")[-1] in ("addmm", "baddbmm"):
        ins += out
    return ops, float(ins + out)


def visible_pairs(sq: int, skv: int, causal: bool, window: Optional[int],
                  q_offset: int = 0) -> int:
    """(query, key) pairs the attention mask lets through, query row ``i``
    at position ``i + q_offset``."""
    total = 0
    for i in range(sq):
        pos = i + q_offset
        hi = min(pos, skv - 1) if causal else skv - 1
        lo = max(0, pos - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def _tensor_bytes(shapes, dtypes) -> int:
    """Bytes of every tensor among a call's recorded inputs (a ``None``
    argument or a scalar records an empty shape)."""
    return sum(numel(s) * elem_bytes(d) for s, d in zip(shapes, dtypes)
               if s)


def flash_attention(direction: str, shapes, dtypes, *, causal: bool = True,
                    window: Optional[int] = None,
                    q_offset: int = 0) -> Tuple[float, float]:
    """(operations, bytes) of one attention call, from its recorded inputs:
    q ``(B, Sq, Hq, D)``, k and v ``(B, Skv, Hkv, D)`` first. Forward:
    ``Q K^T`` and ``P V``, 4 D a visible pair; writes O and the f32
    log-sum-exp. Backward from q, k, v, O, the log-sum-exp and dO: the
    scores once more, dP, dV, dQ and dK, 10 D a pair, and ``rowsum(dO *
    O)``, 2 D a row; writes dq, dk and dv."""
    (b, sq, hq, d), k = shapes[0], shapes[1]
    pairs = visible_pairs(sq, k[1], causal, window, q_offset) * b * hq
    reads = _tensor_bytes(shapes, dtypes)
    q_bytes = numel(shapes[0]) * elem_bytes(dtypes[0])
    if direction == "fwd":
        return 4.0 * d * pairs, float(reads + q_bytes + b * hq * sq * 4)
    kv_bytes = 2 * numel(k) * elem_bytes(dtypes[1])
    return (10.0 * d * pairs + 2.0 * b * sq * hq * d,
            float(reads + q_bytes + kv_bytes))


def wkv6(direction: str, shapes, dtypes, *,
         with_initial: bool = False) -> Tuple[float, float]:
    """(operations, bytes) of one WKV6 call, from its recorded inputs: r,
    k, v, logw ``(B, S, H, P)`` and u ``(H, P)`` first. Operations: the
    chunked products at :data:`WKV_COUNT_CHUNK` (pair scores and values
    ``4 B nc H L^2 P``, the chunk summaries and the state's readout ``4 B
    nc H L P^2``, the bonus ``2 B nc L H P``); the backward twice the
    forward's. Bytes, forward: every tensor input read once (a carried
    state among them), y and the f32 final state written. Backward: r, k,
    v, logw, u, dy and the final state's gradient read once, and, with
    ``with_initial``, the f32 initial state; dr, dk, dv, dlogw written in
    r's dtype, du in f32 and, ``with_initial``, the initial state's f32
    gradient. The chunk states that a forward saves for its backward (the
    backward's sixth input) are the implementation's choice and counted on
    neither side."""
    b, s, h, p = shapes[0]
    lc = min(WKV_COUNT_CHUNK, s)
    nc = -(-s // lc)
    ops = float(4 * b * nc * h * lc * lc * p + 4 * b * nc * h * lc * p * p
                + 2 * b * nc * lc * h * p)
    act = numel(shapes[0]) * elem_bytes(dtypes[0])
    state = b * h * p * p * 4
    if direction == "fwd":
        return ops, float(_tensor_bytes(shapes, dtypes) + act + state)
    reads = _tensor_bytes(shapes[:5] + shapes[6:], dtypes[:5] + dtypes[6:])
    initial = 2 * state if with_initial else 0
    return 2.0 * ops, float(reads + initial + 4 * act + h * p * 4)
