"""Device milliseconds a step of the optimizer's update (AdamW on each
device's replica): the kernels launched inside the program's span
``repro_torch::step.update``, over the window's steps."""

from perfbench import trace

SPAN = "repro_torch::step.update"


def read(summary):
    spent = sum(k[1] for k in summary["kernels"]
                if trace.under(summary, k, lambda n: n == SPAN) is not None)
    if spent <= 0 or not summary.get("steps"):
        return None
    return 1000.0 * spent / summary["steps"]
