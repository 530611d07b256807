"""A training cell: the program's elastic ring trainer, slot after slot.

Set-up draws the weights on the card from the seed (the benchmark's own
draws, handed to the program through ``ElasticTrainer(params=...)``) and
runs the first ``check_steps`` steps through the window's own call,
``ElasticTrainer.run_slot``: a slot of one step (it compiles and warms
every shape the cell uses), then a slot of the rest. After the first step
it reads each leaf's first reduced gradient from AdamW's first moment;
after the last, each leaf's change from the seed's weights, drawn again.

The window then runs ``run_slot(SlotPlan(workers, steps_per_slot))`` slot
after slot, the ring formed and the state resharded at each, and closes at
the end of the slot in which ``--seconds`` have passed. After it, the
program's state is freed and the plain reference follows the same first
steps from the same seed (:mod:`perfbench.reference.train`).

Both sides give ``{"losses", "grad", "update"}``: each of the first steps'
loss, each leaf's norm of the first reduced gradient (as the optimizer's
state holds it after one step) and each leaf's norm of its change over
those steps. :data:`NUMBERS` are worked out from them (:func:`gaps`):

* ``loss_gap``: the largest ``|loss - reference| / |reference|`` over the
  steps; ``first_loss_gap``: the same for the first step alone;
* ``grad_gap``: over the leaves, the largest gap between the two norms,
  ``|program - reference|``, over the larger of the reference's norm of
  that leaf and of the median leaf;
* ``update_gap``: the same for the change, over the leaves whose
  reference gradient is at least :data:`STILL_LEAF` of the median leaf's
  (a leaf whose gradient is nought to rounding moves under Adam by
  rounding alone).
"""

from __future__ import annotations

import contextlib
import gc
import math
import statistics
import time
from typing import Dict, List, Optional

import torch

from perfbench import trace
from perfbench.count import model as model_flops
from perfbench.reference import common
from perfbench.reference.train import family, follow, optimizer, wire
from perfbench.traffic import TokenWalk

NUMBERS = ("loss_gap", "first_loss_gap", "grad_gap", "update_gap")
# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by rounding alone: its change is not compared
STILL_LEAF = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               keep: Optional[set] = None) -> List[float]:
    paths = [p for p in ref if keep is None or p in keep]
    if set(prog) != set(ref) or not paths:
        return [math.inf]
    median = statistics.median(ref[p] for p in paths)
    return [abs(prog[p] - ref[p]) / max(ref[p], median, 1e-30) for p in paths]


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Every number of the program's readings against the reference's."""
    if len(prog["losses"]) != len(ref["losses"]):
        steps = [math.inf]
    else:
        steps = [abs(a - b) / max(abs(b), 1e-30)
                 for a, b in zip(prog["losses"], ref["losses"])]
    median = statistics.median(ref["grad"].values())
    moving = {p for p, g in ref["grad"].items() if g >= STILL_LEAF * median}
    return {"loss_gap": max(steps), "first_loss_gap": steps[0],
            "grad_gap": max(_leaf_gaps(prog["grad"], ref["grad"])),
            "update_gap": max(_leaf_gaps(prog["update"], ref["update"], moving))}


def worst_leaves(prog: Dict, ref: Dict) -> Dict[str, str]:
    """The leaf with the largest gap of each per-leaf number."""
    out = {}
    for key in ("grad", "update"):
        median = statistics.median(ref[key].values())
        out[key] = max(ref[key], key=lambda p: abs(prog[key][p] - ref[key][p])
                       / max(ref[key][p], median, 1e-30))
    return out


def port_config(conf: Dict):
    """The program's configuration of ``conf``: its registered architecture
    with the fields the file sets, checked against the file's sizes."""
    import dataclasses

    from repro_torch.configs import get_arch

    port = conf["port"]
    cfg = dataclasses.replace(get_arch(port["arch"]), **port["fields"])
    wrong = {f: (getattr(cfg, f), conf["sizes"][k]) for f, k in port["same"].items()
             if getattr(cfg, f) != conf["sizes"][k]}
    if wrong:
        raise ValueError(f"the program's {port['arch']} differs from "
                         f"{conf['name']}: {wrong}")
    return cfg


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def start(conf: Dict, mix: Dict, seed: int, device, marks: Optional[Dict] = None):
    """The program's trainer after its first ``check_steps`` steps, its
    readings for the check, and its gradient leaves' sizes; ``marks`` gets
    the clock at the end of each part of it."""
    marks = {} if marks is None else marks
    from repro_torch.models.model import build_model
    from repro_torch.models.module import _flatten
    from repro_torch.training.elastic import ElasticTrainer, SlotPlan
    from repro_torch.training.optimizer import make_optimizer

    fam, sizes = family(conf), conf["sizes"]
    model = build_model(port_config(conf))
    layout = fam.layout(sizes)
    want = {p: tuple(s.shape) for p, s in _flatten(model.param_specs())}
    if want != {p: tuple(shape) for p, shape, _, _ in layout}:
        raise ValueError(f"{conf['name']}: the program's weights are laid out "
                         f"otherwise than the reference's: {want}")
    w, check_steps = mix["workers"], mix["check_steps"]
    trainer = ElasticTrainer(
        model, make_optimizer(mix["optimizer"]),
        TokenWalk(mix, sizes["vocab_size"], seed),
        global_batch=mix["global_batch"], base_lr=mix["lr"], mode=mix["mode"],
        device=device, params=common.nest(common.draw(layout, seed, device)))
    home = trainer.group.devices[0]
    _sync(device)
    marks["weights"] = time.perf_counter()
    trainer.run_slot(SlotPlan(workers=w, steps=1))
    marks["first_step"] = time.perf_counter()
    grad = optimizer(mix).first_grad_norms(
        {k: dict(_flatten(v)) for k, v in trainer.opt_state[home].items()
         if isinstance(v, dict)})
    trainer.run_slot(SlotPlan(workers=w, steps=check_steps - 1))
    _sync(device)
    marks["later_steps"] = time.perf_counter()
    first = common.draw(layout, seed, device)
    params = dict(_flatten(trainer.params[home]))
    update = {p: common.norm(params[p] - first[p]) for p in first}
    leaf_sizes = [t.numel() for t in params.values()]
    readings = {"losses": list(trainer.losses[:check_steps]), "grad": grad,
                "update": update}
    del first, params
    _sync(device)
    marks["readings"] = time.perf_counter()
    return trainer, readings, leaf_sizes


def _parts(t0: float, marks: Dict) -> Dict[str, float]:
    """Seconds of each part of set-up, from the clock marks in order (the
    first, ``started``, from ``t0``: imports and the process's start)."""
    out, last = {}, t0
    for name, at in marks.items():
        out[name] = at - last
        last = at
    return out


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(cell: str, conf: Dict, mix: Dict, *, seed: int, seconds: float,
        traced: bool, device, t0: float) -> Dict:
    """One run of the cell: ``{"values", "attempted", "failed", "numbers",
    "peak_bytes", "summary", "phases"}`` (the summary only when
    ``traced``)."""
    from repro_torch.training.elastic import SlotPlan

    marks = {"started": time.perf_counter()}
    trainer, program, leaf_sizes = start(conf, mix, seed, device, marks)
    w, check_steps = mix["workers"], mix["check_steps"]
    prof = trace.profiler() if traced else contextlib.nullcontext()
    spans = trace.ring_span() if traced else contextlib.nullcontext()
    steps = 0
    with spans, prof:
        began = time.perf_counter()
        with torch.profiler.record_function(trace.WINDOW):
            while True:
                steps += trainer.run_slot(SlotPlan(workers=w, steps=mix["steps_per_slot"]))["steps"]
                if time.perf_counter() - began >= seconds:
                    break
            _sync(device)
        elapsed = time.perf_counter() - began
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    window_losses = trainer.losses[check_steps:]
    del trainer
    free(device)

    closed = time.perf_counter()
    summary = None
    if traced:
        summary = trace.summarize(prof)
        summary.update(steps=steps, step_flops=model_flops.train_step_flops(conf, mix),
                       ring={"wire": wire(mix).WIRE, "workers": w,
                             "leaf_sizes": leaf_sizes})
    summarized = time.perf_counter()
    reference = follow(conf, mix, seed, device)
    followed = time.perf_counter()
    tokens = steps * mix["global_batch"] * mix["seq_len"]
    return {"values": {"train_tokens_per_s": tokens / elapsed,
                       "peak_gib": peak / 2 ** 30,
                       "setup_s": began - t0},
            "attempted": steps,
            "failed": sum(not math.isfinite(x) for x in window_losses),
            "numbers": gaps(program, reference),
            "peak_bytes": peak, "summary": summary,
            "phases": {"setup_s": began - t0,
                       "setup_parts_s": _parts(t0, marks), "window_s": elapsed,
                       "trace_summary_s": summarized - closed,
                       "reference_s": followed - summarized}}
