"""The int8 ring kernels' share of their byte roofline (B1-B3): the bytes
the ring's calls read and write at the HBM rate, over the kernels' device
time. The kernels are launched straight from Python and record no shapes,
so each kernel's bytes a launch is the fused int8 schedule's mean over one
step (``perfbench.count.ring``, from the step's gradient leaves and ring
size), times its launches in the trace."""

import re

from perfbench import count
from perfbench.count import ring


def read(summary):
    spec = summary.get("ring") or {}
    if spec.get("wire") != "int8":
        return None
    schedule = ring.step_calls(spec["leaf_sizes"], spec["workers"])
    patterns = {k: re.compile(rf"(?<![A-Za-z0-9_]){k}(?![A-Za-z0-9_])")
                for k in ring.KERNELS}
    launches = dict.fromkeys(ring.KERNELS, 0)
    spent = 0.0
    for k in summary["kernels"]:
        name = summary["names"][k[2]]
        for kernel, pattern in patterns.items():
            if pattern.search(name):
                launches[kernel] += 1
                spent += k[1]
                break
    nbytes = sum(launches[k] * schedule[k][1] / schedule[k][0]
                 for k in ring.KERNELS if schedule[k][0])
    if spent <= 0:
        return None
    return 100.0 * (nbytes / count.PEAK_BYTES) / spent
