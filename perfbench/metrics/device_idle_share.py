"""Share of the traced window in which no kernel, copy or set ran on the
card: the window less the union of the device's activity intervals."""

from perfbench import trace


def read(summary):
    window = summary["window_s"]
    if window <= 0 or not summary["kernels"]:
        return None
    return 100.0 * (1.0 - trace.busy_s(summary) / window)
