"""Device milliseconds a step of the ring's reduction of every rank's
gradients: the kernels and copies launched inside the program's span
``repro_torch::step.reduce``, over the window's steps (the program's own
reading of what ``ring_device_share`` reads as a share of the window)."""

from perfbench import trace

SPAN = "repro_torch::step.reduce"


def read(summary):
    spent = sum(k[1] for k in summary["kernels"]
                if trace.under(summary, k, lambda n: n == SPAN) is not None)
    if spent <= 0 or not summary.get("steps"):
        return None
    return 1000.0 * spent / summary["steps"]
