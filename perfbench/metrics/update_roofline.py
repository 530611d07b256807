"""AdamW's share of its byte roofline: the bytes of every recorded
``repro_torch::adamw_leaf`` call (``perfbench.count.adamw``, from its
recorded shapes and dtypes) at the HBM rate, over the device time of
everything those calls launched. A program whose update is no such
operator reads nothing."""

from perfbench import count, trace
from perfbench.count import adamw

OP = "repro_torch::adamw_leaf"


def read(summary):
    times = trace.device_time_by_op(summary, lambda n: n == OP)
    nbytes = spent = 0.0
    for op, seconds in times.items():
        shapes, dtypes, _ = trace.recorded(summary, op)
        nbytes += adamw.leaf_bytes(shapes, dtypes)
        spent += seconds
    return 100.0 * (nbytes / count.PEAK_BYTES) / spent if spent > 0 else None
