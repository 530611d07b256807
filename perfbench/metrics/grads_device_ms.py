"""Device milliseconds a step of every rank's loss and gradients: the
kernels launched inside the program's span ``repro_torch::step.grads``,
and those the autograd engine launched for the backward from its own
thread (under its ``autograd::engine::evaluate_function`` ops, which on the
card do not nest in the span), over the window's steps. None where no
kernel ran inside the span."""

from perfbench import trace

SPAN = "repro_torch::step.grads"
ENGINE = "autograd::engine::evaluate_function"


def read(summary):
    forward = backward = 0.0
    for k in summary["kernels"]:
        if trace.under(summary, k, lambda n: n == SPAN) is not None:
            forward += k[1]
        elif trace.under(summary, k, lambda n: n.startswith(ENGINE)) is not None:
            backward += k[1]
    if forward <= 0 or not summary.get("steps"):
        return None
    return 1000.0 * (forward + backward) / summary["steps"]
