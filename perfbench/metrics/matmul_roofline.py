"""The recorded ``aten`` matrix products' share of their roofline: the sum
of each call's bound (its operations at the TF32 tensor-core peak, or its
bytes at the HBM rate, whichever is longer) over the device time of the
kernels those calls launched."""

from perfbench import count, trace

PRODUCTS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def read(summary):
    times = trace.device_time_by_op(summary, lambda n: n in PRODUCTS)
    bound = spent = 0.0
    for op, seconds in times.items():
        shapes, dtypes, _ = trace.recorded(summary, op)
        work = count.matmul(trace.op_name(summary, op), shapes, dtypes)
        if work is None:
            continue
        bound += count.bound_s(*work)
        spent += seconds
    return 100.0 * bound / spent if spent > 0 else None
