"""Idle milliseconds a step at the step boundary: the idle gaps of the
card (each as ``trace.breakdown`` finds it, ended by a launch) whose
ending launch is inside the program's span ``repro_torch::step.batch``
(the host's batch, after the loss read's sync) or ``repro_torch::slot.form``
(the ring formed at a slot's start), or inside neither a
``repro_torch::step`` nor an ``autograd::engine::evaluate_function`` op
(between steps), and the gap after the last launch; over the window's
steps. A launch that no host op holds (one the profiler could not link) may
lie anywhere, so the gap it ends is not counted. None without the program's
step spans."""

from perfbench import trace

STEP = "repro_torch::step"
BOUNDARY = ("repro_torch::step.batch", "repro_torch::slot.form")
ENGINE = "autograd::engine::evaluate_function"


def _inside_step(name: str) -> bool:
    return name == STEP or name.startswith(ENGINE)


def _at_boundary(summary, kernel) -> bool:
    if kernel[3] < 0:
        return False
    return (trace.under(summary, kernel, lambda n: n in BOUNDARY) is not None
            or trace.under(summary, kernel, _inside_step) is None)


def read(summary):
    kernels, window = summary["kernels"], summary["window_s"]
    steps = summary.get("steps")
    if not steps or not any(trace.under(summary, k, lambda n: n == STEP) is not None
                            for k in kernels):
        return None
    idle, reach = 0.0, 0.0
    for k in kernels:
        start, dur = k[0], k[1]
        if reach < start < window and _at_boundary(summary, k):
            idle += start - reach
        reach = max(reach, start + dur)
    idle += max(window - reach, 0.0)
    return 1000.0 * idle / steps
