"""The traced run: ``torch.profiler`` over the measured window, and its
reduction to a summary that the per-layer metric readers
(``perfbench/metrics/<name>.py``) read.

The window is the span ``perfbench::window`` on the driving thread. The
benchmark adds one span of its own inside the program's step,
``perfbench::ring``, around ``repro_torch.training.train_step.reduce_grads``
(the reduction of every rank's gradients over the ring), so that the
ring's device work can be told apart without running it again.

The summary (plain lists, so that a recorded one can be stored as JSON):

* ``window_s``: the window's length; ``steps``, ``step_flops``, ``ring``:
  what the harness ran in it;
* ``names``: every op and kernel name, once;
* ``ops``: ``[name, parent, shapes, dtypes, concrete]`` of every host op
  (and span) in the window, ``parent`` the index of the op it ran inside on
  its thread (-1 for none); shapes, dtypes and concrete inputs are kept
  for ops that launched device work and for the program's own operators;
* ``kernels``: ``[start_s, dur_s, name, op]`` of every device activity
  (kernel, copy, set) that overlaps the window, ``start_s`` from the
  window's start, ``op`` the index of the innermost host op that launched
  it (-1 for none).
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

WINDOW = "perfbench::window"
RING = "perfbench::ring"
# host-side profiler bookkeeping, not ops of the run
_BOOKKEEPING = ("Activity Buffer Request", "Runtime Triggered Module Loading",
                "Lazy Function Loading")


@contextlib.contextmanager
def ring_span() -> Iterator[None]:
    """Wrap the program's gradient reduction in the ``perfbench::ring`` span
    for as long as the block runs."""
    from repro_torch.training import train_step

    inner = train_step.reduce_grads

    def reduce_grads(*args, **kwargs):
        with torch.profiler.record_function(RING):
            return inner(*args, **kwargs)

    train_step.reduce_grads = reduce_grads
    try:
        yield
    finally:
        train_step.reduce_grads = inner


def profiler():
    """A profiler of the host and the card (where there is one) that records
    each op's input shapes."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=True)


def _is_runtime(name: str) -> bool:
    """A CUDA runtime or driver call (a launch, a copy, a sync)."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def summarize(prof) -> Dict:
    """The summary of a finished profile (see the module docstring)."""
    results = prof.profiler.kineto_results
    events = results.events()
    device, host = [], []
    for e in events:
        if e.device_type().name == "CPU":
            host.append(e)
        else:
            device.append(e)
    window = next(e for e in host if e.name() == WINDOW)
    w0, w1 = window.start_ns(), window.end_ns()
    launched = {e.linked_correlation_id() for e in device}

    names: List[str] = []
    index: Dict[str, int] = {}

    def name_id(name: str) -> int:
        if name not in index:
            index[name] = len(names)
            names.append(name)
        return index[name]

    ops, by_corr, spans = [], {}, defaultdict(list)
    for e in host:
        name = e.name()
        if (name in _BOOKKEEPING or e.linked_correlation_id() != 0
                or _is_runtime(name) or e.end_ns() < w0 or e.start_ns() > w1):
            continue
        keep = e.correlation_id() in launched or name.startswith("repro_torch::")
        shapes = [list(s) for s in e.shapes()] if keep else []
        dtypes = list(e.dtypes()) if keep else []
        concrete = _plain(e.concrete_inputs()) if keep else []
        by_corr.setdefault(e.correlation_id(), len(ops))
        spans[e.start_thread_id()].append((e.start_ns(), e.end_ns(), len(ops)))
        ops.append([name_id(name), -1, shapes, dtypes, concrete])
    for intervals in spans.values():
        _link_parents(intervals, ops)

    user_spans = {e.correlation_id() for e in host
                  if e.name() in (WINDOW, RING)}
    kernels = []
    for e in device:
        if e.linked_correlation_id() == 0 and e.correlation_id() in user_spans:
            continue                      # the device-side image of a span
        start, end = e.start_ns(), e.end_ns()
        if end <= w0 or start >= w1:
            continue
        kernels.append([(start - w0) / 1e9, (end - start) / 1e9,
                        name_id(e.name()), by_corr.get(e.linked_correlation_id(), -1)])
    kernels.sort(key=lambda k: k[0])
    return {"window_s": (w1 - w0) / 1e9, "names": names, "ops": ops,
            "kernels": kernels}


def _plain(values) -> list:
    """Concrete inputs as JSON-able values (anything else as None)."""
    out = []
    for v in values:
        out.append(v if isinstance(v, (bool, int, float, str, type(None))) else None)
    return out


def _link_parents(intervals: List[Tuple[int, int, int]], ops: List) -> None:
    """Set each op's parent to the innermost op of the same thread whose
    interval holds it."""
    intervals.sort(key=lambda x: (x[0], -x[1]))
    stack: List[Tuple[int, int]] = []
    for start, end, i in intervals:
        while stack and stack[-1][0] < end:
            stack.pop()
        if stack:
            ops[i][1] = stack[-1][1]
        stack.append((end, i))


# -- helpers for the metric readers -------------------------------------------

def ancestors(summary: Dict, op: int) -> Iterator[int]:
    """``op`` and every op it ran inside, innermost first."""
    ops = summary["ops"]
    while op >= 0:
        yield op
        op = ops[op][1]


def op_name(summary: Dict, op: int) -> str:
    return summary["names"][summary["ops"][op][0]] if op >= 0 else ""


def under(summary: Dict, kernel, pred: Callable[[str], bool]) -> Optional[int]:
    """The innermost op enclosing a kernel's launch whose name passes
    ``pred``, or None."""
    for op in ancestors(summary, kernel[3]):
        if pred(op_name(summary, op)):
            return op
    return None


def device_time_by_op(summary: Dict, pred: Callable[[str], bool]
                      ) -> Dict[int, float]:
    """Device seconds of every op whose name passes ``pred``, counting each
    kernel launched inside it (its innermost such op)."""
    out: Dict[int, float] = defaultdict(float)
    for k in summary["kernels"]:
        op = under(summary, k, pred)
        if op is not None:
            out[op] += k[1]
    return out


def busy_intervals(summary: Dict) -> List[Tuple[float, float]]:
    """The union of the device's activity inside the window, as sorted
    disjoint ``(start_s, end_s)``."""
    out: List[Tuple[float, float]] = []
    end_w = summary["window_s"]
    for start, dur, _, _ in summary["kernels"]:
        a, b = max(start, 0.0), min(start + dur, end_w)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_s(summary: Dict) -> float:
    return sum(b - a for a, b in busy_intervals(summary))


def breakdown(summary: Dict, top: int = 10) -> Dict:
    """The device activities that took most time, summed by name, and the
    idle time between them summed by the host op whose launch ended the
    gap."""
    by_name: Dict[str, float] = defaultdict(float)
    for k in summary["kernels"]:
        by_name[summary["names"][k[2]]] += k[1]
    gaps: Dict[str, float] = defaultdict(float)
    reach = 0.0
    for start, dur, _, op in summary["kernels"]:
        if start > reach and start < summary["window_s"]:
            gaps[op_name(summary, op) or "(no host op)"] += start - reach
        reach = max(reach, start + dur)
    if reach < summary["window_s"]:
        gaps["(after the last launch)"] += summary["window_s"] - reach

    def ranked(d: Dict[str, float]) -> List[List]:
        return [[n, s] for n, s in sorted(d.items(), key=lambda x: -x[1])[:top]]

    return {"device_ops": ranked(by_name), "idle_gaps": ranked(gaps)}


def recorded(summary: Dict, op: int) -> Tuple[Sequence, Sequence, Sequence]:
    """(shapes, dtypes, concrete inputs) recorded for an op."""
    _, _, shapes, dtypes, concrete = summary["ops"][op]
    return shapes, dtypes, concrete
