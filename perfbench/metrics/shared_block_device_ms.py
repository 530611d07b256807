"""Device milliseconds a step of the shared blocks' forward: the kernels
launched inside the program's span ``repro_torch::hybrid.shared`` (one use
of a shared block, from the concatenation to the use's ``linear``), over
the window's steps. None where no kernel ran inside the span."""

from perfbench import trace

SPAN = "repro_torch::hybrid.shared"


def read(summary):
    spent = sum(k[1] for k in summary["kernels"]
                if trace.under(summary, k, lambda n: n == SPAN) is not None)
    if spent <= 0 or not summary.get("steps"):
        return None
    return 1000.0 * spent / summary["steps"]
