"""Share of the traced window that the card spent on the ring's reduction:
the device time of every kernel and copy launched inside the gradient
reduction (the ``perfbench::ring`` span), over the window."""

from perfbench import trace


def read(summary):
    spent = sum(k[1] for k in summary["kernels"]
                if trace.under(summary, k, lambda n: n == trace.RING) is not None)
    if spent <= 0 or summary["window_s"] <= 0:
        return None
    return 100.0 * spent / summary["window_s"]
