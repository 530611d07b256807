"""B9's share of its roofline: the sum of the bounds of the recorded
``repro_torch::ssd_scan_fwd`` and ``ssd_scan_bwd`` calls (each from its
recorded shapes, ``perfbench.count.ssd``) over the device time of
everything those calls launched."""

from perfbench import count, trace
from perfbench.count import ssd

OPS = {"repro_torch::ssd_scan_fwd": "fwd", "repro_torch::ssd_scan_bwd": "bwd"}


def read(summary):
    times = trace.device_time_by_op(summary, lambda n: n in OPS)
    bound = spent = 0.0
    for op, seconds in times.items():
        shapes, dtypes, concrete = trace.recorded(summary, op)
        direction = OPS[trace.op_name(summary, op)]
        with_initial = direction == "bwd" and len(concrete) > 8 and concrete[8] is True
        bound += count.bound_s(*ssd.ssd_scan(direction, shapes, dtypes,
                                             with_initial=with_initial))
        spent += seconds
    return 100.0 * bound / spent if spent > 0 else None
