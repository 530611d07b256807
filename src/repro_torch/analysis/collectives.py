"""Collective verifier over a recording ring —
``python -m repro_torch.analysis.collectives``.

The counterpart of ``repro.analysis.collectives``. GADGET prices each ring
with Eq. (1); a ring that deadlocks, sends extra collectives or messages of
another size than priced, or rebuilds its program every slot breaks that
pricing. The reference traces jaxprs; eager PyTorch has none, so here every
ring-all-reduce variant registered in :mod:`repro_torch.dist.registry`, and
every ``make_ring_train_step`` mode, runs over a :class:`RecordingRing`: a
:class:`~repro_torch.dist.collectives.LocalRing` that records one
:class:`CollectiveSite` for each ``permute`` (one ``ppermute``) and each
``psum`` it carries, with the permutation and each rank's message dtype and
bytes. The records are checked on the reference's four axes, across a
world-size sweep:

**(i) ring-topology** — every permutation must be a bijection forming a
single Hamiltonian cycle over the ranks, and the hop directions must match
the variant's declaration: one distinct perm for a unidirectional ring, at
most two mutually inverse perms for the bidirectional split, none for psum
variants.

**(ii) deadlock-order** — collectives only complete when every rank issues
the same sequence. A recording holds no ``lax.cond`` to read, so the check
is *differential*: each variant and step mode is recorded on four input
families made from one seed (N(0, 1); rank r's tensor times (-1)^r; all
negative; all zero), and the sequences of ``(primitive, perm, dtypes,
bytes)`` must be identical across them. A difference is a collective whose
issue depends on the data: ranks in separate processes would issue
mismatched sequences and hang. The check sees a branch only where one of
the families takes it the other way — which is why the families flip signs
and include zeros — and cannot see one that no family reaches.

**(iii) pricing** — the recorded message counts and bytes must equal the
scheduler's formulas exactly: ``ppermute`` count against
``RingVariant.expected_messages`` (the gamma multiplier) and bytes against
``expected_bytes`` (the executed, padded layout through
``rar_model.wire_formula``); for the fused layouts every message must be
the declared wire format (one int8 buffer of ``payload + trailer`` bytes of
``hop_message_layout`` for int8/fp8, one bare bfloat16 buffer of the padded
chunk for bf16); overlap step modes price per bucket of
``plan_bucket_sizes``. A message whose ranks send different dtypes or sizes
is a pricing finding too: SPMD cannot express it, and a transport across
processes would carry it.

**(iv) recompile-hazard** — ``RingWorkerGroup`` caches its ring programs by
``(workers, mode, n_buckets, wire_dtype)``. Torch has no weak types; the
counterpart of a weak-typed leaf is a state leaf that is not a tensor (a
Python number) or a floating tensor of another dtype than its parameter, in
the step's params and optimizer state and in every optimizer's state. Also
checked: drift of shape, dtype or device between a step's input and output
state; two recordings of one ``(mode, w)`` step with identical records;
identical records for per-worker batches of 2 and 4; no assignment of a
``STATIC_CLOSURE_ATTRS`` entry after ``__init__`` (by AST); and a live
``RingWorkerGroup``'s cache (``sched.backend.audit_compiled_step_cache``).

The records are taken on ``--device`` (``cuda`` by default; it raises
without a card, and the tests pass ``--device cpu``): on a card the fused
variants run through the ring kernels, so the check covers the real
kernels' messages. The CLI exits 0 when the sweep is clean and the seeded
mutation suite (:mod:`repro_torch.analysis.fixtures`) still fires each axis.
Suppressions use the baseline plumbing of
:mod:`repro_torch.analysis.baseline` (``collectives_baseline.txt`` next to
this module, absent while the sweep is clean).
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.baseline import Baseline, apply_baseline, write_baseline
from repro_torch.dist.collectives import LocalRing
from repro_torch.dist.overlap import tree_leaves

CHECKS = ("ring-topology", "deadlock-order", "pricing", "recompile-hazard")

DEFAULT_WORLDS = (2, 3, 4, 8)    # at least three world sizes
DEFAULT_DS = (96, 777)           # one divides every world size, one pads
# the input families of the differential deadlock check, from one seed
FAMILIES = ("normal", "alternating", "negative", "zero")
SEED = 0
_STEP_SOURCE = "src/repro_torch/training/train_step.py"
_ELASTIC_SOURCE = "src/repro_torch/training/elastic.py"
_OPTIMIZER_SOURCE = "src/repro_torch/training/optimizer.py"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verifier finding, keyed like a lint violation.

    ``check`` is the axis (the JSON ``rule``); ``path`` the repo-relative
    source of the offending variant or module; ``symbol`` the variant or
    mode name (no world size, so one baseline entry covers the sweep);
    ``message`` carries the (w, d) specifics.
    """

    check: str
    path: str
    symbol: str
    message: str
    line: int = 0

    @property
    def key(self) -> str:
        return f"{self.check}:{self.path}:{self.symbol}"

    def to_json(self) -> Dict:
        return {"rule": self.check, "path": self.path, "line": self.line,
                "symbol": self.symbol, "message": self.message,
                "key": self.key}

    def __str__(self) -> str:
        return (f"{self.path}: [{self.check}] {self.symbol}: {self.message}"
                f"  ({self.key})")


@dataclasses.dataclass(frozen=True)
class CollectiveSite:
    """One collective a ring carried: ``ppermute`` (one ``permute``) or
    ``psum``, its permutation, and each rank's message dtype and bytes.
    ``dtype`` and ``nbytes`` are rank 0's, the reference's fields."""

    primitive: str
    perm: Optional[Tuple[Tuple[int, int], ...]]
    rank_dtypes: Tuple[str, ...]
    rank_bytes: Tuple[int, ...]
    repeat: int = 1

    @property
    def dtype(self) -> str:
        return self.rank_dtypes[0]

    @property
    def nbytes(self) -> int:
        return self.rank_bytes[0]

    @property
    def uniform(self) -> bool:
        """Every rank sends the same dtype and the same bytes."""
        return len(set(self.rank_dtypes)) == 1 and len(set(self.rank_bytes)) == 1


def _dtype_name(dtype: torch.dtype) -> str:
    """``torch.int8`` -> ``int8``: the name the reference's jaxprs give."""
    return str(dtype).replace("torch.", "")


def _message(tensors: Sequence[torch.Tensor]):
    return (tuple(_dtype_name(t.dtype) for t in tensors),
            tuple(t.numel() * t.element_size() for t in tensors))


class RecordingRing(LocalRing):
    """A :class:`LocalRing` that records one :class:`CollectiveSite` for
    each collective it carries, in order, in :attr:`sites`."""

    def __init__(self, devices: Sequence):
        super().__init__(devices)
        self.sites: List[CollectiveSite] = []

    def permute(self, sends, perm):
        recvs = super().permute(sends, perm)
        self.sites.append(CollectiveSite(
            "ppermute", tuple((int(s), int(d)) for s, d in perm),
            *_message(sends)))
        return recvs

    def psum(self, xs):
        out = super().psum(xs)
        self.sites.append(CollectiveSite("psum", None, *_message(xs)))
        return out


def _ppermute_count(sites: Sequence[CollectiveSite]) -> int:
    return sum(s.repeat for s in sites if s.primitive == "ppermute")


def _ppermute_bytes(sites: Sequence[CollectiveSite]) -> int:
    return sum(s.nbytes * s.repeat for s in sites
               if s.primitive == "ppermute")


# ---------------------------------------------------------------------------
# the recording harness
# ---------------------------------------------------------------------------

def resolve_device(device) -> torch.device:
    """``device`` as a torch device, a bare ``cuda`` resolved to the
    current card; raises where there is no card (no fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for, but no CUDA "
                               "card is available (pass --device cpu)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def family_inputs(family: str, w: int, shape: Tuple[int, ...],
                  seed: int = SEED) -> np.ndarray:
    """``(w, *shape)`` f32, one row a rank, of one input family: N(0, 1);
    rank r's times (-1)^r; all negative; all zero. Every family is drawn
    from the same seed."""
    base = np.random.default_rng(seed).standard_normal(
        (w,) + tuple(shape)).astype(np.float32)
    if family == "normal":
        return base
    if family == "alternating":
        signs = np.where(np.arange(w) % 2 == 0, 1.0, -1.0).astype(np.float32)
        return base * signs.reshape((w,) + (1,) * len(shape))
    if family == "negative":
        return -np.abs(base)
    if family == "zero":
        return np.zeros_like(base)
    raise ValueError(f"unknown input family {family!r}; known: {FAMILIES}")


def record_ring_variant(variant, w: int, d: int, device="cuda",
                        data: Optional[np.ndarray] = None
                        ) -> List[CollectiveSite]:
    """Run one registered collective over a :class:`RecordingRing` of ``w``
    ranks on ``device``, on ``w`` f32 tensors of ``d`` elements (``data``,
    one row a rank; the ``normal`` family by default); return its
    records."""
    dev = resolve_device(device)
    if data is None:
        data = family_inputs("normal", w, (d,))
    ring = RecordingRing([dev] * w)
    variant.build(ring)([torch.from_numpy(np.ascontiguousarray(data[r])).to(dev)
                         for r in range(w)])
    return ring.sites


class _VerifierModel:
    """Two-leaf linear model with deliberately non-round sizes, so chunk
    padding (the usual pricing-drift hideout) is exercised on every
    record: the reference's ``_VerifierModel``."""

    features = 37
    targets = 5

    def init(self, seed: int = 0, device="cpu") -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng(seed)
        w = rng.standard_normal((self.features, self.targets)).astype(np.float32)
        return {"w": torch.from_numpy(w).to(device),
                "b": torch.zeros(self.targets, dtype=torch.float32,
                                 device=device)}

    def loss(self, params, batch):
        pred = batch["x"] @ params["w"] + params["b"]
        return torch.mean(torch.square(pred - batch["y"]))


@dataclasses.dataclass
class StepRecord:
    """One recorded train step: its collectives, the state it took and
    returned (trees on the step's device) and its leaf sizes in
    ``tree_leaves`` order."""

    sites: List[CollectiveSite]
    params: Dict
    opt_state: Dict
    new_params: Dict
    new_opt_state: Dict
    leaf_sizes: List[int]


def record_train_step(mode: str, w: int, per_worker_batch: int = 2,
                      device="cuda", family: str = "normal") -> StepRecord:
    """One ``make_ring_train_step`` step of ``mode`` with SGD-momentum on
    the verifier model over a :class:`RecordingRing` of ``w`` ranks on
    ``device``, its global batch of ``w * per_worker_batch`` rows drawn as
    ``family`` (rank r's rows are row block r)."""
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.train_step import make_ring_train_step, shard_batch

    dev = resolve_device(device)
    model = _VerifierModel()
    optimizer = make_optimizer("sgdm")
    ring = RecordingRing([dev] * w)
    step = make_ring_train_step(model, optimizer, ring, lr=1e-2, mode=mode)
    params = model.init(0, dev)
    opt_state = optimizer.init(params)
    batch = {k: torch.from_numpy(family_inputs(
        family, w, (per_worker_batch, n), seed=SEED + i).reshape(
            w * per_worker_batch, n)) for i, (k, n) in
        enumerate((("x", model.features), ("y", model.targets)))}
    new_params, new_opt, _ = step({dev: params}, {dev: opt_state},
                                  shard_batch(batch, ring.devices))
    return StepRecord(ring.sites, params, opt_state, new_params[dev],
                      new_opt[dev], [v.numel() for _, v in tree_leaves(params)])


# ---------------------------------------------------------------------------
# axis (i): ring topology
# ---------------------------------------------------------------------------

def _cycle_error(perm: Tuple[Tuple[int, int], ...], w: int) -> Optional[str]:
    """Why ``perm`` is not a single Hamiltonian cycle on 0..w-1 (or None)."""
    srcs = sorted(s for s, _ in perm)
    dsts = sorted(d for _, d in perm)
    if srcs != list(range(w)) or dsts != list(range(w)):
        return (f"perm {perm} is not a bijection covering ranks 0..{w - 1} "
                "— some worker never sends or never receives")
    nxt = dict(perm)
    length, cur = 1, nxt[0]
    while cur != 0 and length <= w:
        cur = nxt[cur]
        length += 1
    if length != w:
        return (f"perm {perm} splits the {w}-rank axis into disjoint cycles "
                f"(the cycle through rank 0 has length {length}) — partial "
                "sums never visit every worker, the reduction is silently "
                "wrong")
    return None


def _inverse(perm: Tuple[Tuple[int, int], ...]) -> frozenset:
    return frozenset((d, s) for s, d in perm)


def check_topology(variant, sites: Sequence[CollectiveSite],
                   w: int) -> List[str]:
    """Axis (i) messages for one recording; ``variant.directions`` is 0, 1
    or 2."""
    msgs: List[str] = []
    perms = [s.perm for s in sites
             if s.primitive == "ppermute" and s.perm is not None]
    if variant.directions == 0:
        if perms:
            msgs.append(f"psum-based variant contains {len(perms)} "
                        "ppermute(s) — no explicit ring is declared")
        return msgs
    distinct: List[Tuple[Tuple[int, int], ...]] = []
    for p in perms:
        if p not in distinct:
            distinct.append(p)
    for p in distinct:
        err = _cycle_error(p, w)
        if err:
            msgs.append(err)
    if msgs:
        return msgs
    if variant.directions == 1 and len(distinct) > 1:
        msgs.append(
            f"hops use {len(distinct)} distinct permutations {distinct} in "
            "a unidirectional ring — chunks must travel one consistent "
            "direction or they bounce instead of walking the cycle")
    elif variant.directions == 2:
        if len(distinct) > 2:
            msgs.append(f"bidirectional ring uses {len(distinct)} distinct "
                        f"permutations {distinct}; expected at most two")
        elif len(distinct) == 2 and \
                frozenset(distinct[0]) != _inverse(distinct[1]):
            msgs.append(
                f"bidirectional ring directions {distinct} are not mutual "
                "inverses — the two half-rings must counter-rotate")
    return msgs


# ---------------------------------------------------------------------------
# axis (ii): deadlock ordering, differential
# ---------------------------------------------------------------------------

def _profile(sites: Sequence[CollectiveSite]) -> Tuple:
    """What every rank must agree on, in order."""
    return tuple((s.primitive, s.perm, s.rank_dtypes, s.rank_bytes, s.repeat)
                 for s in sites)


def check_deadlock(families: Dict[str, Sequence[CollectiveSite]]
                   ) -> List[str]:
    """Axis (ii) messages: the families' collective sequences against the
    first family's."""
    msgs: List[str] = []
    names = list(families)
    want = _profile(families[names[0]])
    for name in names[1:]:
        got = _profile(families[name])
        if got == want:
            continue
        at = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
                  min(len(want), len(got)))
        msgs.append(
            f"the {name!r} inputs issue {len(got)} collective(s) against "
            f"{len(want)} for the {names[0]!r} inputs, first apart at "
            f"collective {at} — the issue of a collective depends on the "
            "data: ranks in separate processes would issue mismatched "
            "sequences and the ring deadlocks; make the predicate "
            "replica-invariant")
    return msgs


# ---------------------------------------------------------------------------
# axis (iii): pricing agreement
# ---------------------------------------------------------------------------

def _rank_mismatch_errors(sites: Sequence[CollectiveSite]) -> List[str]:
    """Collectives whose ranks send different dtypes or sizes."""
    msgs, seen = [], set()
    for s in sites:
        sig = (s.primitive, s.rank_dtypes, s.rank_bytes)
        if s.uniform or sig in seen:
            continue
        seen.add(sig)
        per_rank = list(zip(s.rank_dtypes, s.rank_bytes))
        msgs.append(
            f"{s.primitive} with rank messages {per_rank} — ranks send "
            "different dtypes or sizes in one collective, which SPMD cannot "
            "express and rar_model does not price")
    return msgs


def _fused_message_errors(sites: Sequence[CollectiveSite], d: int, w: int,
                          compression: str = "int8-fused") -> List[str]:
    """Per-message layout check for the fused wire formats: int8 and fp8
    payloads travel bitcast to one int8 buffer of exactly ``payload +
    scale-trailer`` bytes; the bf16 wire is a bare bfloat16 buffer of the
    padded chunk (2 B an element, no trailer)."""
    from repro_torch.dist.compression import DEFAULT_BLOCK
    from repro_torch.kernels.quant_ring import hop_message_layout

    layout = hop_message_layout(-(-d // w), block=DEFAULT_BLOCK)
    if compression == "bf16-fused":
        want_dtype = "bfloat16"
        want_bytes = 2 * layout.payload_bytes  # padded chunk, no trailer
        expect = (f"bfloat16[{want_bytes} B] (2 B x {layout.payload_bytes} "
                  "padded elements, no scale trailer)")
    else:  # int8-fused / fp8-fused: 1 B payload + bitcast f32 scale trailer
        want_dtype = "int8"
        want_bytes = layout.message_bytes
        expect = (f"int8[{want_bytes} B] ({layout.payload_bytes} payload + "
                  f"{layout.trailer_bytes} trailer)")
    msgs: List[str] = []
    seen = set()
    for s in sites:
        if s.primitive != "ppermute":
            continue
        sig = (s.dtype, s.nbytes)
        if sig in seen:
            continue
        seen.add(sig)
        if s.dtype != want_dtype or s.nbytes != want_bytes:
            msgs.append(
                f"fused hop message is {s.dtype}[{s.nbytes} B] but the "
                f"{compression} layout for a {-(-d // w)}-element chunk is "
                f"{expect} — kernel wire format and scheduler pricing have "
                "drifted")
    return msgs


def check_pricing(variant, sites: Sequence[CollectiveSite], w: int,
                  d: int) -> List[str]:
    """Axis (iii) messages for one recording against the rar_model
    formulas."""
    msgs = _rank_mismatch_errors(sites)
    count = _ppermute_count(sites)
    expected = variant.expected_messages(w, d)
    if count != expected:
        msgs.append(
            f"recorded ring issues {count} ppermute(s) but rar_model prices "
            f"{expected} message(s) for w={w} "
            f"(compression={variant.compression!r}) — the per-message gamma "
            "accounting is wrong")
    if variant.collective == "ppermute":
        total = _ppermute_bytes(sites)
        expect_bytes = variant.expected_bytes(d, w)
        if abs(total - expect_bytes) > 1e-6 * max(expect_bytes, 1.0):
            msgs.append(
                f"recorded ppermute payloads total {total} B but rar_model "
                f"prices {expect_bytes:g} B for d={d}, w={w} "
                f"(compression={variant.compression!r}) — Eq. (1)'s wire "
                "term no longer matches what the ring sends")
        if variant.compression in ("int8-fused", "bf16-fused", "fp8-fused") \
                and not variant.n_buckets:
            msgs.extend(_fused_message_errors(sites, d, w,
                                              variant.compression))
        extras = sorted({s.primitive for s in sites
                         if s.primitive != "ppermute"})
        if extras:
            msgs.append(
                f"ring variant also issues unpriced collective(s) "
                f"{extras} — rar_model prices ppermutes only")
    else:  # psum-based variant
        n_psum = sum(s.repeat for s in sites if s.primitive == "psum")
        if n_psum != 1:
            msgs.append(f"psum variant issues {n_psum} psum(s); expected "
                        "exactly 1 all-reduce")
    return msgs


def check_step_pricing(spec, sites: Sequence[CollectiveSite], w: int,
                       leaf_sizes: Sequence[int]) -> List[str]:
    """Axis (iii) for a full train step: the per-leaf (or per-bucket)
    reduction.

    The reference's step also traces one 4-byte psum, the loss ``pmean``.
    The port's step averages the ranks' losses on the host
    (``torch.stack(...).mean()``) and issues no collective for it, so this
    expects no loss psum: ``n_leaves`` psums in ``psum`` mode, none in the
    ring modes. A transport across processes makes the loss mean a
    collective again, and this expectation gains it back.
    """
    msgs = _rank_mismatch_errors(sites)
    n_leaves = len(leaf_sizes)
    n_psum = sum(s.repeat for s in sites if s.primitive == "psum")
    count = _ppermute_count(sites)
    if spec.collective == "psum":
        if count:
            msgs.append(f"psum mode records {count} ppermute(s); expected 0")
        if n_psum != n_leaves:
            msgs.append(
                f"psum mode records {n_psum} psum(s); expected {n_leaves} "
                "(one a grad leaf; the loss mean is taken on the host)")
        return msgs
    leaf_variant = spec.leaf_variant()
    if spec.n_buckets:
        # overlap mode: one ring a planned bucket, priced with the same
        # reverse-autodiff plan the executed reduction uses
        from repro_torch.dist.overlap import plan_bucket_sizes

        payloads = list(plan_bucket_sizes(leaf_sizes, spec.n_buckets,
                                          reverse=True))
        unit = f"{len(payloads)} bucket(s) over leaves {list(leaf_sizes)}"
    else:
        payloads = list(leaf_sizes)
        unit = f"{n_leaves} leaves"
    expected = sum(leaf_variant.expected_messages(w) for _ in payloads)
    if count != expected:
        msgs.append(
            f"step records {count} ppermute(s) but rar_model prices "
            f"{expected} ({unit} x "
            f"{leaf_variant.expected_messages(w)}) for w={w}")
    total = _ppermute_bytes(sites)
    expect_bytes = sum(leaf_variant.expected_bytes(size, w)
                       for size in payloads)
    if abs(total - expect_bytes) > 1e-6 * max(expect_bytes, 1.0):
        msgs.append(
            f"step ppermute payloads total {total} B but rar_model prices "
            f"{expect_bytes:g} B over {unit} at w={w}")
    if n_psum:
        msgs.append(f"step records {n_psum} psum(s); expected none (the "
                    "loss mean is taken on the host) — extra collectives "
                    "are unpriced")
    return msgs


# ---------------------------------------------------------------------------
# axis (iv): recompilation hazards
# ---------------------------------------------------------------------------

def _param_of(path: str, param_paths: Sequence[str]) -> Optional[str]:
    """The parameter an optimizer-state leaf belongs to: the longest
    parameter path that appears in it between slashes."""
    padded = f"/{path}/"
    hits = [p for p in param_paths if f"/{p}/" in padded]
    return max(hits, key=len) if hits else None


def scalar_leaf_findings(tree, origin: str, path: str = _STEP_SOURCE,
                         params=None) -> List[Finding]:
    """Leaves that would re-key a ring program: a leaf that is not a tensor
    (a Python number in the state), or, with ``params``, a floating leaf of
    another dtype than the parameter it belongs to."""
    out: List[Finding] = []
    param_dtypes = {} if params is None else \
        {p: v.dtype for p, v in tree_leaves(params) if isinstance(v, torch.Tensor)}
    for where, leaf in tree_leaves(tree):
        if not isinstance(leaf, torch.Tensor):
            out.append(Finding(
                check="recompile-hazard", path=path, symbol=origin,
                message=(
                    f"leaf {where} of the {origin} template is a Python "
                    f"{type(leaf).__name__}, not a tensor — a scalar in the "
                    "step's state changes with every caller that passes a "
                    "tensor, defeating the (workers, mode) cache")))
            continue
        owner = _param_of(where, list(param_dtypes))
        if owner is not None and leaf.is_floating_point() and \
                leaf.dtype != param_dtypes[owner]:
            out.append(Finding(
                check="recompile-hazard", path=path, symbol=origin,
                message=(
                    f"leaf {where} of the {origin} template is "
                    f"{leaf.dtype} but its parameter {owner} is "
                    f"{param_dtypes[owner]} — the update promotes or casts "
                    "every step")))
    return out


def _drift(tree_in, tree_out, what: str) -> List[str]:
    """Leaves whose path, shape, dtype or device differ between a step's
    input and output state."""
    a, b = tree_leaves(tree_in), tree_leaves(tree_out)
    if [p for p, _ in a] != [p for p, _ in b]:
        return [f"{what} leaves {[p for p, _ in a]} -> {[p for p, _ in b]}"]
    out = []
    for (where, x), (_, y) in zip(a, b):
        drift = []
        if not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)):
            if type(x) is not type(y):
                drift.append(f"type {type(x).__name__} -> {type(y).__name__}")
        else:
            if tuple(x.shape) != tuple(y.shape):
                drift.append(f"shape {tuple(x.shape)} -> {tuple(y.shape)}")
            if x.dtype != y.dtype:
                drift.append(f"dtype {x.dtype} -> {y.dtype}")
            if x.device != y.device:
                drift.append(f"device {x.device} -> {y.device}")
        if drift:
            out.append(f"{what} leaf {where} ({', '.join(drift)})")
    return out


def audit_step_recompilation(mode: str, w: int, device="cuda") -> List[Finding]:
    """Axis (iv) for one (mode, w): Python scalars and dtype mismatches in
    the state, state drift across the step, and records identical between
    two runs and between per-worker batches of 2 and 4."""
    findings: List[Finding] = []
    symbol = f"make_ring_train_step[{mode}]"
    rec = record_train_step(mode, w, device=device)
    findings.extend(scalar_leaf_findings(rec.params, f"{symbol} params"))
    findings.extend(scalar_leaf_findings(rec.opt_state, f"{symbol} opt_state",
                                         params=rec.params))
    for drift in (_drift(rec.params, rec.new_params, "params")
                  + _drift(rec.opt_state, rec.new_opt_state, "opt_state")):
        findings.append(Finding(
            check="recompile-hazard", path=_STEP_SOURCE, symbol=symbol,
            message=(f"state {drift} drifts across one step at w={w} — "
                     "feeding the output back in changes the step's inputs "
                     "every slot")))
    again = record_train_step(mode, w, device=device)
    if _profile(rec.sites) != _profile(again.sites):
        findings.append(Finding(
            check="recompile-hazard", path=_STEP_SOURCE, symbol=symbol,
            message=f"two recordings of the same (mode={mode}, w={w}) step "
                    "issue different collectives — the ring program is "
                    "nondeterministic (unstable iteration order or fresh "
                    "state per call)"))
    big = record_train_step(mode, w, per_worker_batch=4, device=device)
    if _profile(rec.sites) != _profile(big.sites):
        findings.append(Finding(
            check="recompile-hazard", path=_STEP_SOURCE, symbol=symbol,
            message=(
                f"collective structure changes with the per-worker batch "
                f"size at w={w} ({len(rec.sites)} vs {len(big.sites)} "
                "collectives) — shape-dependent control flow reaches the "
                "ring, so every batch geometry needs a different program")))
    return findings


def audit_optimizer_templates(device="cuda") -> List[Finding]:
    """Python scalars and dtype mismatches in every optimizer's state."""
    from repro_torch.training.optimizer import make_optimizer

    findings: List[Finding] = []
    params = _VerifierModel().init(0, resolve_device(device))
    for name in ("adamw", "adafactor", "sgdm"):
        state = make_optimizer(name).init(params)
        findings.extend(scalar_leaf_findings(
            state, f"optimizer[{name}] state", path=_OPTIMIZER_SOURCE,
            params=params))
    return findings


def _class_static_attrs(cls_node: ast.ClassDef) -> Tuple[str, ...]:
    """Read STATIC_CLOSURE_ATTRS from a class body (string-literal tuple)."""
    for node in cls_node.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and \
                        tgt.id == "STATIC_CLOSURE_ATTRS":
                    try:
                        value = ast.literal_eval(node.value)
                    except ValueError:
                        return ()
                    return tuple(str(v) for v in value)
    return ()


def audit_static_closure(source_path: Optional[str] = None) -> List[Finding]:
    """AST check: no method outside ``__init__`` assigns a static closure
    attr of a class declaring ``STATIC_CLOSURE_ATTRS`` (RingWorkerGroup)."""
    if source_path is None:
        import repro_torch.training.elastic as elastic_mod

        source_path = elastic_mod.__file__
    with open(source_path) as f:
        tree = ast.parse(f.read(), source_path)
    findings: List[Finding] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        attrs = _class_static_attrs(cls)
        if not attrs:
            continue
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                continue
            if method.name == "__init__":
                continue
            for node in ast.walk(method):
                if not isinstance(node, (ast.Assign, ast.AugAssign,
                                         ast.AnnAssign)):
                    continue
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in targets:
                    if isinstance(tgt, ast.Attribute) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id == "self" and tgt.attr in attrs:
                        findings.append(Finding(
                            check="recompile-hazard",
                            path=_ELASTIC_SOURCE,
                            symbol=f"{cls.name}.{method.name}",
                            line=node.lineno,
                            message=(
                                f"self.{tgt.attr} (a STATIC_CLOSURE_ATTRS "
                                "entry the ring programs close over) is "
                                f"assigned in {method.name}() — mutating it "
                                "after __init__ serves stale programs "
                                "under the (workers, mode) cache key")))
    return findings


def audit_live_group(device="cuda") -> List[Finding]:
    """``compile_count`` / cache-key cross-check on a live
    ``RingWorkerGroup`` (``_program`` builds a ring program but runs no
    step)."""
    from repro_torch.sched.backend import audit_compiled_step_cache
    from repro_torch.training.elastic import (
        RingWorkerGroup,
        largest_feasible_ring,
        ring_devices,
    )
    from repro_torch.training.optimizer import make_optimizer

    findings: List[Finding] = []
    group = RingWorkerGroup(_VerifierModel(), make_optimizer("sgdm"),
                            global_batch=8, lr=1e-2, mode="ring",
                            devices=ring_devices(resolve_device(device)))
    group._program(1)
    group._program(1)  # same key: must be a cache hit
    if group.compile_count != 1:
        findings.append(Finding(
            check="recompile-hazard", path=_ELASTIC_SOURCE,
            symbol="RingWorkerGroup._program",
            message=(
                f"two _program() calls at one (workers, mode) key built "
                f"{group.compile_count} program(s); expected 1 — equal-sized "
                "back-to-back slots are rebuilding their ring")))
    for problem in audit_compiled_step_cache(group):
        findings.append(Finding(
            check="recompile-hazard", path=_ELASTIC_SOURCE,
            symbol="RingWorkerGroup", message=problem))
    # worker-count resolution must be idempotent: requested sizes that clamp
    # to the same feasible ring share one cache entry
    for gb in (8, 12):
        for req in range(1, 10):
            resolved = largest_feasible_ring(req, global_batch=gb,
                                             n_devices=8)
            again = largest_feasible_ring(resolved, global_batch=gb,
                                          n_devices=8)
            if resolved != again:
                findings.append(Finding(
                    check="recompile-hazard", path=_ELASTIC_SOURCE,
                    symbol="largest_feasible_ring",
                    message=(
                        f"resolution is not idempotent: requested={req} -> "
                        f"{resolved} -> {again} (global_batch={gb}) — "
                        "aliased requests would split the ring-program "
                        "cache")))
    return findings


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SweepStats:
    variants: int = 0
    step_modes: int = 0
    records: int = 0
    hops: int = 0
    psums: int = 0
    worlds: Tuple[int, ...] = ()

    def add(self, records: Dict[str, Sequence[CollectiveSite]]) -> None:
        for sites in records.values():
            self.records += 1
            self.hops += sum(s.primitive == "ppermute" for s in sites)
            self.psums += sum(s.primitive == "psum" for s in sites)


def verify_ring_variant(variant, worlds: Sequence[int], ds: Sequence[int],
                        stats: Optional[SweepStats] = None,
                        device="cuda") -> List[Finding]:
    """The three per-record axes for one registered collective across the
    sweep, each (w, d) recorded on every input family."""
    findings: List[Finding] = []
    for w in worlds:
        for d in ds:
            records = {fam: record_ring_variant(
                variant, w, d, device, family_inputs(fam, w, (d,)))
                for fam in FAMILIES}
            if stats is not None:
                stats.add(records)
            sites = records[FAMILIES[0]]
            for check, msgs in (
                    ("ring-topology", check_topology(variant, sites, w)),
                    ("deadlock-order", check_deadlock(records)),
                    ("pricing", check_pricing(variant, sites, w, d))):
                findings.extend(Finding(
                    check=check, path=variant.source, symbol=variant.name,
                    message=f"[w={w}, d={d}] {msg}") for msg in msgs)
    return findings


def verify_step_mode(mode: str, worlds: Sequence[int],
                     stats: Optional[SweepStats] = None,
                     device="cuda") -> List[Finding]:
    """Axes (i)-(iii) for one full train-step mode across the sweep."""
    from repro_torch.dist.registry import STEP_MODES

    spec = STEP_MODES[mode]
    symbol = f"make_ring_train_step[{mode}]"
    findings: List[Finding] = []
    for w in worlds:
        steps = {fam: record_train_step(mode, w, device=device, family=fam)
                 for fam in FAMILIES}
        records = {fam: rec.sites for fam, rec in steps.items()}
        if stats is not None:
            stats.add(records)
        first = steps[FAMILIES[0]]
        for check, msgs in (
                ("ring-topology", check_topology(spec, first.sites, w)),
                ("deadlock-order", check_deadlock(records)),
                ("pricing", check_step_pricing(spec, first.sites, w,
                                               first.leaf_sizes))):
            findings.extend(Finding(
                check=check, path=_STEP_SOURCE, symbol=symbol,
                message=f"[w={w}] {msg}") for msg in msgs)
    return findings


def run_verifier(worlds: Sequence[int] = DEFAULT_WORLDS,
                 ds: Sequence[int] = DEFAULT_DS, *,
                 include_steps: bool = True,
                 include_recompile: bool = True,
                 device="cuda") -> Tuple[List[Finding], SweepStats]:
    """The full sweep: every registered variant and step mode on
    ``device``."""
    from repro_torch.dist.registry import RING_VARIANTS
    from repro_torch.training.train_step import RING_STEP_MODES

    stats = SweepStats(worlds=tuple(worlds))
    findings: List[Finding] = []
    for variant in RING_VARIANTS:
        stats.variants += 1
        findings.extend(verify_ring_variant(variant, worlds, ds, stats,
                                            device=device))
    if include_steps:
        step_worlds = [w for w in worlds if w != max(worlds)] or list(worlds)
        for mode in RING_STEP_MODES:
            stats.step_modes += 1
            findings.extend(verify_step_mode(mode, step_worlds, stats,
                                             device=device))
            if include_recompile:
                findings.extend(audit_step_recompilation(
                    mode, min(step_worlds), device=device))
    if include_recompile:
        findings.extend(audit_optimizer_templates(device))
        findings.extend(audit_static_closure())
        findings.extend(audit_live_group(device))
    return findings, stats


# ---------------------------------------------------------------------------
# the seeded mutation suite (must fire, like the kernel checker's rejects)
# ---------------------------------------------------------------------------

def run_self_test(w: int = 4, d: int = 777, device="cuda") -> List[str]:
    """Record each deliberately broken fixture and return the axes that
    FAILED to fire (empty = every analysis still has teeth)."""
    from repro_torch.analysis.fixtures import (
        broken_ring_variants,
        python_scalar_template,
    )

    failures: List[str] = []
    for variant, expect_check in broken_ring_variants():
        findings = verify_ring_variant(variant, [w], [d], device=device)
        fired = {f.check for f in findings}
        if expect_check not in fired:
            failures.append(
                f"{variant.name}: expected a {expect_check} finding, got "
                f"{sorted(fired) or 'none'}")
    scalar = scalar_leaf_findings(python_scalar_template(),
                                  "Python-scalar fixture")
    if not any(f.check == "recompile-hazard" for f in scalar):
        failures.append("python_scalar_template: expected a recompile-hazard "
                        "finding on the Python float leaf")
    return failures


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "collectives_baseline.txt")


def findings_json(findings: Sequence[Finding], baseline: Baseline,
                  stats: SweepStats, self_test_failures: List[str]) -> Dict:
    new, stale = apply_baseline(findings, baseline)
    new_keys = {f.key for f in new}
    return {
        "tool": "repro_torch.analysis.collectives",
        "findings": [dict(f.to_json(), baselined=f.key not in new_keys)
                     for f in findings],
        "stale": stale,
        "malformed": list(baseline.malformed),
        "self_test_failures": self_test_failures,
        "stats": dataclasses.asdict(stats),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.collectives",
        description="collective verifier over a recording ring for every "
                    "registered ring collective (module docstring has the "
                    "four axes)")
    parser.add_argument("--worlds", type=int, nargs="+",
                        default=list(DEFAULT_WORLDS),
                        help="world sizes to sweep (default: %(default)s)")
    parser.add_argument("--d", type=int, nargs="+", dest="ds",
                        default=list(DEFAULT_DS),
                        help="gradient sizes to sweep (default: %(default)s"
                             " — one divisible by every world, one padded)")
    parser.add_argument("--skip-steps", action="store_true",
                        help="skip the full train-step mode sweep")
    parser.add_argument("--skip-recompile", action="store_true",
                        help="skip the recompilation-hazard audit")
    parser.add_argument("--skip-self-test", action="store_true",
                        help="skip the seeded mutation suite (it must fire "
                             "one finding per broken fixture)")
    parser.add_argument("--baseline", default=None,
                        help="baseline file (default: repro_torch/analysis/"
                             "collectives_baseline.txt)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="report every finding, ignoring the baseline")
    parser.add_argument("--write-baseline", action="store_true",
                        help="write current findings as the baseline; "
                             "placeholder entries still fail the gate "
                             "until justified")
    parser.add_argument("--json", default=None, metavar="PATH",
                        help="also write machine-readable findings "
                             "(rule/path/line/symbol/message) to PATH")
    parser.add_argument("--device", default="cuda",
                        help="where the rings run (default: %(default)s; "
                             "raises without a card)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    findings, stats = run_verifier(
        args.worlds, args.ds, include_steps=not args.skip_steps,
        include_recompile=not args.skip_recompile, device=device)
    baseline_path = args.baseline or default_baseline_path()

    if args.write_baseline:
        n = write_baseline(baseline_path, (f.key for f in findings),
                           tool="repro_torch.analysis.collectives")
        print(f"wrote {n} baseline entries -> {baseline_path}")
        print("placeholder justifications still FAIL the gate — replace "
              "each 'TODO justify' with a real rationale")
        return 0

    baseline = Baseline(entries={}, malformed=[]) if args.no_baseline \
        else Baseline.load(baseline_path)
    self_test_failures: List[str] = []
    if not args.skip_self_test:
        self_test_failures = run_self_test(device=device)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(findings_json(findings, baseline, stats,
                                    self_test_failures), f, indent=2)

    new, stale = apply_baseline(findings, baseline)
    status = 0
    for f in new:
        print(f"collectives: {f}")
        status = 1
    for line in baseline.malformed:
        print("collectives: baseline entry missing or placeholder "
              f"justification: {line}")
        status = 1
    for key in stale:
        print("collectives: stale baseline entry (finding no longer fires "
              f"— delete the line): {key}")
        status = 1
    for failure in self_test_failures:
        print(f"collectives: MUTATION SUITE NOT FIRING: {failure}")
        status = 1
    suppressed = len(findings) - len(new)
    self_test = "skipped" if args.skip_self_test else \
        f"{len(self_test_failures)} silent"
    print(f"collectives: {stats.variants} variant(s) + {stats.step_modes} "
          f"step mode(s) at worlds {list(stats.worlds)} on {device}: "
          f"{stats.records} record(s), {stats.hops} hop(s), {stats.psums} "
          f"psum(s); {len(findings)} finding(s), {suppressed} baselined, "
          f"{len(new)} new, {len(stale)} stale; mutation suite: "
          f"{self_test} -> {'FAIL' if status else 'OK'}")
    return status


if __name__ == "__main__":
    sys.exit(main())
