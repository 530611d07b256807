"""B4's share of its roofline: the sum of the bounds of the recorded
``repro_torch::flash_attention_fwd`` and ``_bwd`` calls (each from its
recorded shapes and its causal flag, window and query offset,
``perfbench.count.flash_attention``) over the device time of everything
those calls launched."""

from perfbench import count, trace

OPS = {"repro_torch::flash_attention_fwd": ("fwd", 3),
       "repro_torch::flash_attention_bwd": ("bwd", 6)}


def read(summary):
    times = trace.device_time_by_op(summary, lambda n: n in OPS)
    bound = spent = 0.0
    for op, seconds in times.items():
        shapes, dtypes, concrete = trace.recorded(summary, op)
        direction, first = OPS[trace.op_name(summary, op)]
        causal, window, offset = (list(concrete[first:first + 3]) + [None] * 3)[:3]
        work = count.flash_attention(direction, shapes, dtypes,
                                     causal=causal is not False, window=window,
                                     q_offset=offset or 0)
        bound += count.bound_s(*work)
        spent += seconds
    return 100.0 * bound / spent if spent > 0 else None
