"""The whole step's share of the card's peak: the model flops of the
window's steps (``perfbench.count.model``) over the window's seconds times
the TF32 tensor-core peak."""

from perfbench import count


def read(summary):
    if not summary.get("steps") or summary["window_s"] <= 0:
        return None
    flops = summary["steps"] * summary["step_flops"]
    return 100.0 * flops / (summary["window_s"] * count.PEAK_FLOPS)
