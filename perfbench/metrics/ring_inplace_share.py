"""The share of the f32 ring's chunk bytes that the ring took where the
gradient lies: each ``repro_torch::ring.layout`` span (one leaf's chunks,
taken before its hops) carries as its inputs the bytes taken as views of
the ranks' own tensors and the bytes put in padded copies, each summed
over the ranks. So: 100 x viewed / (viewed + copied) over the window's
spans, read where the trace holds the device work of the ring's hops
(``repro_torch::ring.hop``). A program without the span reads nothing."""

from perfbench import trace

SPAN = "repro_torch::ring.layout"
HOP = "repro_torch::ring.hop"


def read(summary):
    if not any(trace.under(summary, k, lambda n: n == HOP) is not None
               for k in summary["kernels"]):
        return None
    names = summary["names"]
    viewed = copied = 0
    for op in summary["ops"]:
        counts = op[4]
        if (names[op[0]] == SPAN and len(counts) == 2
                and all(isinstance(c, int) for c in counts)):
            viewed += counts[0]
            copied += counts[1]
    if viewed + copied <= 0:
        return None
    return 100.0 * viewed / (viewed + copied)
