"""Device milliseconds a step of the Mamba2 layers' forward and its remat
recompute: the kernels launched inside the program's span
``repro_torch::mamba.layer`` (one Mamba2 layer, entered again by the
recompute in backward), over the window's steps. None where no kernel ran
inside the span."""

from perfbench import trace

SPAN = "repro_torch::mamba.layer"


def read(summary):
    spent = sum(k[1] for k in summary["kernels"]
                if trace.under(summary, k, lambda n: n == SPAN) is not None)
    if spent <= 0 or not summary.get("steps"):
        return None
    return 1000.0 * spent / summary["steps"]
