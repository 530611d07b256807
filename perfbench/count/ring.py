"""The fused int8 ring's kernel calls for one all-reduce, counted from the
reduced tensor's size alone (GADGET's priced wire: per hop one message of
an int8 payload in sub-blocks of ``BLOCK`` elements and one f32 scale a
sub-block).

A rank's chunk of ``n`` elements over ``w`` ranks is ``ceil(n / w)``,
padded to whole sub-blocks of ``min(BLOCK, chunk)``. Each rank makes, per
all-reduce: a quantize-and-pack of its own chunk (the first Share-Reduce
send); ``w - 2`` dequantize-add-requantize hops; one dequantize-accumulate
(its reduced chunk); a quantize-and-pack of that chunk (its Share-Only
send); one dequantize of all ``w`` gathered messages. Each call's bytes are
its inputs read once and its outputs written once.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

BLOCK = 4096
SCALE_BYTES = 4

# the CUDA kernel function names of the four int8 ring kernels
KERNELS = ("quantize_pack_kernel", "dequant_add_quantize_kernel",
           "dequant_accumulate_kernel", "dequant_kernel")


def chunk_layout(n: int, w: int, block: int = BLOCK) -> Tuple[int, int]:
    """(sub-blocks a chunk, elements a sub-block) of an ``n``-element
    tensor over ``w`` ranks."""
    c = max(-(-int(n) // max(w, 1)), 1)
    b = max(1, min(int(block), c))
    return -(-c // b), b


def all_reduce_calls(n: int, w: int, block: int = BLOCK
                     ) -> Dict[str, Tuple[int, float]]:
    """Kernel name -> (launches, bytes) of one fused int8 all-reduce of an
    ``n``-element f32 tensor, summed over the ``w`` ranks."""
    if w < 2:
        return {}
    nb, b = chunk_layout(n, w, block)
    payload, scales, f32 = nb * b, nb * SCALE_BYTES, nb * b * 4
    quantize = f32 + payload + scales
    hop = payload + scales + f32 + payload + scales
    accumulate = payload + scales + f32 + f32
    dequant = w * (payload + scales) + w * f32
    return {
        "quantize_pack_kernel": (2 * w, 2.0 * w * quantize),
        "dequant_add_quantize_kernel": ((w - 2) * w, float((w - 2) * w * hop)),
        "dequant_accumulate_kernel": (w, float(w * accumulate)),
        "dequant_kernel": (w, float(w * dequant)),
    }


def step_calls(leaf_sizes: Iterable[int], w: int, block: int = BLOCK
               ) -> Dict[str, Tuple[int, float]]:
    """Kernel name -> (launches, bytes) of one step that reduces every
    leaf once, leaf by leaf."""
    out = {k: (0, 0.0) for k in KERNELS}
    for n in leaf_sizes:
        for k, (launches, nbytes) in all_reduce_calls(n, w, block).items():
            out[k] = (out[k][0] + launches, out[k][1] + nbytes)
    return out
