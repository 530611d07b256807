"""The ring's hops' share of their byte roofline: each hop (the program's
span ``repro_torch::ring.hop``, one ppermute) carries as its first input
the bytes it sends, summed over the ranks; on one card a hop is a copy
that reads and writes them once. So: twice the window's hop bytes at the
HBM rate, over the device time of everything the hops launched."""

from perfbench import count, trace

SPAN = "repro_torch::ring.hop"


def read(summary):
    names = summary["names"]
    nbytes = sum(op[4][0] for op in summary["ops"]
                 if names[op[0]] == SPAN and op[4] and isinstance(op[4][0], int))
    spent = sum(k[1] for k in summary["kernels"]
                if trace.under(summary, k, lambda n: n == SPAN) is not None)
    if spent <= 0 or nbytes <= 0:
        return None
    return 100.0 * (2 * nbytes / count.PEAK_BYTES) / spent
