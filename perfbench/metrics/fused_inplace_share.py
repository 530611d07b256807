"""The share of the fused int8 ring's message bytes that were written where
they cross the wire and read where they landed: each
``repro_torch::fused.layout`` span (one all-reduce of the fused quantized
ring, taken before its hops) carries as its inputs the message bytes that
the kernel making each wrote into the wire buffer and the bytes that went
through a pack, stack or placement copy, each summed over the ranks. So:
100 x in_place / (in_place + copied) over the window's spans, read where the
trace holds the device work of the ring's hops (``repro_torch::ring.hop``).
A program without the span reads nothing."""

from perfbench import trace

SPAN = "repro_torch::fused.layout"
HOP = "repro_torch::ring.hop"


def read(summary):
    if not any(trace.under(summary, k, lambda n: n == HOP) is not None
               for k in summary["kernels"]):
        return None
    names = summary["names"]
    in_place = copied = 0
    for op in summary["ops"]:
        counts = op[4]
        if (names[op[0]] == SPAN and len(counts) == 2
                and all(isinstance(c, int) for c in counts)):
            in_place += counts[0]
            copied += counts[1]
    if in_place + copied <= 0:
        return None
    return 100.0 * in_place / (in_place + copied)
