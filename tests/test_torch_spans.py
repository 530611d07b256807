"""The program's spans (``repro_torch.spans``) over one slot of
``ElasticTrainer.run_slot`` on the CPU: reduced qwen3-0.6b with AdamW, on
rings of 2 and 4 ranks, in the f32 ``ring`` and the fused int8 mode.

Under ``torch.profiler`` each span appears as often as the step does its
part, nested as ``repro_torch.spans`` lists them, with AdamW's operator
(``repro_torch::adamw_leaf``) once a leaf inside ``step.update``; the hops'
bytes, their one counter, add up to what ``LocalRing`` counted; no span is
a user annotation (which a trace of the card would mirror onto the device);
and a profiled slot leaves the same bits as one run without a profiler. The
error-feedback reduction, which no trainer mode takes, is one ``step.reduce``
too.
"""

from collections import Counter, defaultdict

import pytest
import torch

from repro_torch import spans
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.dist.collectives import LocalRing
from repro_torch.dist.compression import DEFAULT_BLOCK, _fused_chunk_layout
from repro_torch.models.model import build_model
from repro_torch.models.module import _flatten
from repro_torch.training.elastic import ElasticTrainer, SlotPlan
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_step import (
    init_ef_state,
    make_ring_train_step,
    shard_batch,
)

ARCH = "qwen3-0.6b"
SEQ, GLOBAL_BATCH, LR, STEPS = 16, 8, 1e-3, 2
CASES = [(mode, w) for mode in ("ring", "compressed-fused") for w in (2, 4)]
INSIDE_STEP = ("step.batch", "step.grads", "step.reduce", "step.update")


def _trainer(mode):
    cfg = get_arch(ARCH).reduced()
    return ElasticTrainer(build_model(cfg), make_optimizer("adamw"),
                          SyntheticTokens(cfg.vocab, SEQ, GLOBAL_BATCH, seed=0),
                          global_batch=GLOBAL_BATCH, base_lr=LR, mode=mode,
                          device="cpu")


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        fn()
    return [e for e in prof.events() if e.name.startswith(spans.PREFIX)]


def _short(event) -> str:
    return event.name[len(spans.PREFIX):]


def test_span_is_the_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert spans.span("step") is spans.OFF
    assert spans.span("ring.hop", 10) is spans.OFF
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert spans.span("step") is not spans.OFF


@pytest.mark.parametrize("mode,w", CASES)
def test_slot_spans_nest_and_count(mode, w):
    tr = _trainer(mode)
    tr.run_slot(SlotPlan(w, 1))                  # builds the ring program
    ring = tr.group.current.ring
    before = (sum(ring.bytes), sum(ring.messages))
    events = _profiled(lambda: tr.run_slot(SlotPlan(w, STEPS)))
    counts = Counter(_short(e) for e in events)
    hops = [e for e in events if _short(e) == "ring.hop"]
    leaves = len(list(_flatten(tr.model.param_specs())))
    # beside the spans, AdamW's operator, once a leaf a step; each ring
    # takes each leaf's chunks once, the fused int8 ring with its gathers
    layout = {"ring.layout" if mode == "ring" else "fused.layout": STEPS * leaves}
    assert counts == {"slot.form": 1, "step": STEPS, "step.batch": STEPS,
                      "step.grads": STEPS * w, "step.reduce": STEPS,
                      "step.update": STEPS, "ring.hop": len(hops),
                      "adamw_leaf": STEPS * leaves, **layout}
    assert hops
    parents = defaultdict(set)
    for e in events:
        parents[_short(e)].add(_short(e.cpu_parent) if e.cpu_parent else None)
    assert parents["slot.form"] == parents["step"] == {None}
    for name in INSIDE_STEP:
        assert parents[name] == {"step"}, name
    assert parents["ring.hop"] == {"step.reduce"}
    assert parents["adamw_leaf"] == {"step.update"}
    inputs = defaultdict(list)
    for e in events:
        inputs[_short(e)].append(list(e.concrete_inputs))
    if mode == "ring":
        # each leaf's bytes on every rank, taken as a view or copied
        assert parents["ring.layout"] == {"step.reduce"}
        params = next(iter(tr.params.values()))
        leaf_bytes = [v.numel() * v.element_size() for _, v in _flatten(params)]
        assert all(len(i) == 2 for i in inputs["ring.layout"])
        assert sorted(sum(i) for i in inputs["ring.layout"]) == sorted(
            w * n for n in leaf_bytes * STEPS)
    else:
        # every rank's w messages a leaf, written in place but for the
        # scales of a trailer off 4 bytes (tiny chunks), which are copied
        assert parents["fused.layout"] == {"step.reduce"}
        params = next(iter(tr.params.values()))
        want = []
        for _, v in _flatten(params):
            c_pad, nb, _ = _fused_chunk_layout(v.numel(), w, DEFAULT_BLOCK)
            copied = 4 * nb if c_pad % 4 else 0
            want.append([w * w * (c_pad + 4 * nb - copied), w * w * copied])
        assert sorted(inputs["fused.layout"]) == sorted(want * STEPS)
    for name in ("slot.form", "step") + INSIDE_STEP:
        assert all(i == [] for i in inputs[name]), name
    assert all(len(i) == 1 for i in inputs["ring.hop"])
    assert (sum(i[0] for i in inputs["ring.hop"]), len(hops) * w) == (
        sum(ring.bytes) - before[0], sum(ring.messages) - before[1])
    assert not any(e.is_user_annotation for e in events)


def test_re_ring_is_a_slot_form_that_builds():
    tr = _trainer("ring")
    events = _profiled(lambda: tr.run_slot(SlotPlan(4, 2, leave=(1, 2))))
    names = [_short(e) for e in events if e.cpu_parent is None]
    assert names == ["slot.form", "step", "slot.form", "step"]
    assert tr.group.compile_count == 2 and tr.group.workers == 2


def test_error_feedback_reduction_is_a_step_reduce():
    cfg = get_arch(ARCH).reduced()
    model, opt, w = build_model(cfg), make_optimizer("adamw"), 2
    ring = LocalRing(["cpu"] * w)
    step = make_ring_train_step(model, opt, ring, mode="compressed-fused",
                                error_feedback=True)
    params = model.init(0, device="cpu", dtype=torch.float32)
    cpu = torch.device("cpu")
    batch = SyntheticTokens(cfg.vocab, SEQ, GLOBAL_BATCH, seed=0).batch(0)
    shards = shard_batch({k: torch.as_tensor(v) for k, v in batch.items()},
                         ring.devices)
    ef = init_ef_state(params, ring.devices)
    events = _profiled(lambda: step({cpu: params}, {cpu: opt.init(params)},
                                    shards, ef))
    counts = Counter(_short(e) for e in events)
    assert counts["step.grads"] == w and counts["step.update"] == 1
    assert counts["step.reduce"] == 1 and counts["ring.hop"] > 0
    assert {_short(e.cpu_parent) for e in events
            if _short(e) == "ring.hop"} == {"step.reduce"}
    assert sum(e.concrete_inputs[0] for e in events
               if _short(e) == "ring.hop") == sum(ring.bytes)


@pytest.mark.parametrize("mode,w", CASES)
def test_profiled_slot_is_bit_identical(mode, w):
    plain, traced = _trainer(mode), _trainer(mode)
    plain.run_slot(SlotPlan(w, STEPS))
    _profiled(lambda: traced.run_slot(SlotPlan(w, STEPS)))
    assert plain.losses == traced.losses
    for attr in ("params", "opt_state"):
        a = dict(_flatten(next(iter(getattr(plain, attr).values()))))
        b = dict(_flatten(next(iter(getattr(traced, attr).values()))))
        assert a.keys() == b.keys()
        for path in a:
            assert torch.equal(a[path], b[path]), (attr, path)
