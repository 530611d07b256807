"""AST lint for ``src/repro_torch`` — repo-specific determinism/accounting
rules (the counterpart of ``repro.analysis.lint``).

Run as ``python -m repro_torch.analysis.lint``. Exits 0 when every violation is
covered by the checked-in baseline (``lint_baseline.txt`` next to this
module); exits 1 on new violations, on stale baseline entries (debt that was
paid off must leave the ledger), and on baseline lines whose justification
is missing or still the ``TODO`` placeholder ``--write-baseline`` emits
(shared plumbing: :mod:`repro_torch.analysis.baseline`).

Rules (full rationale in ``src/repro/analysis/README.md``):

  ``unseeded-rng``      calls into the *module-level* ``random`` /
                        ``numpy.random`` global state anywhere in
                        src/repro_torch, and into torch's global generator:
                        ``torch.manual_seed`` (and the other global seeders)
                        and a torch sampler (``torch.rand*``, ``randn*``,
                        ``randint*``, ``randperm``, ``normal``,
                        ``bernoulli``, ``multinomial``, a tensor's in-place
                        ``normal_``/``uniform_``/...) called without
                        ``generator=``. The replay contract requires every
                        draw to flow from an explicit seeded
                        ``np.random.default_rng(seed)`` or
                        ``torch.Generator``. (The reference needs no torch
                        case: ``jax.random`` has no global state.)
  ``wallclock``         ``time.time()`` / ``perf_counter()`` / ``datetime
                        .now()`` inside scheduler/driver decision paths
                        (``sched/``, ``core/``): wall-clock reads make slot
                        decisions unreplayable.
  ``unordered-iter``    ``for``-loop or comprehension iterating a set-typed
                        expression (set literal/comprehension, ``set()`` /
                        ``frozenset()`` call, ``.keys()``, or a local bound
                        to one) in a decision path. Set order is
                        insertion/hash dependent; anything feeding a
                        ``SlotDecision`` or candidate ordering must iterate
                        ``sorted(...)`` or a list.
  ``event-coverage``    every ``ClusterEvent`` subclass in sched/events.py
                        must be referenced (dispatched or explicitly
                        ignored) in sched/driver.py — an event the driver
                        silently drops breaks replay of any stream that
                        emits it.
  ``unfrozen-dataclass``public dataclasses in sched/api.py must be
                        ``frozen=True``: slot records/decisions are shared
                        accounting artifacts; in-place mutation after commit
                        bypasses the z-accounting.
  ``mutable-default``   mutable default argument values (list/dict/set)
                        anywhere in src/repro_torch — shared-state bugs that break
                        run-to-run independence.

Baseline format, one suppression per line::

    rule:relative/path.py:Qual.symbol  # one-line justification

The key carries no line numbers, so baselines survive unrelated edits; one
entry suppresses every same-rule violation inside that symbol.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.baseline import (  # noqa: F401  (re-exported API)
    Baseline,
    apply_baseline,
    write_baseline,
)

# decision-path prefixes (relative to the repro_torch package root): modules whose
# code runs inside the per-slot decision loop and is therefore held to the
# replay contract
DECISION_PATH_PREFIXES = ("sched/", "core/")

# seeded constructors / types that are fine to touch on numpy.random
_NP_RANDOM_OK = {
    "default_rng", "Generator", "SeedSequence", "BitGenerator",
    "PCG64", "PCG64DXSM", "Philox", "SFC64", "MT19937",
}
# stdlib random: only instantiating an explicitly seeded Random is fine
_STDLIB_RANDOM_OK = {"Random", "SystemRandom", "getstate", "setstate"}

# torch samplers that draw from the global generator unless given
# ``generator=``; and the calls that seed or reseed global generators
_TORCH_SAMPLERS = {
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "normal", "bernoulli", "multinomial", "poisson",
}
_TORCH_GLOBAL_SEEDERS = {
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
    "torch.cuda.seed", "torch.cuda.seed_all",
}
# in-place samplers of a tensor (``x.normal_()``), global unless given
# ``generator=``
_TENSOR_SAMPLERS = {
    "normal_", "uniform_", "bernoulli_", "random_", "exponential_",
    "geometric_", "log_normal_", "cauchy_",
}

_WALLCLOCK_CALLS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today",
}

_SORTING_WRAPPERS = {"sorted", "min", "max", "sum", "len", "any", "all",
                     "frozenset", "set"}


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str        # posix path relative to the lint root
    symbol: str      # dotted enclosing scope ("<module>" at top level)
    line: int
    message: str

    @property
    def key(self) -> str:
        """Baseline key — stable across unrelated edits (no line numbers)."""
        return f"{self.rule}:{self.path}:{self.symbol}"

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] {self.message}"
                f"  ({self.key})")


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------

def _dotted_name(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Resolve an attribute chain to a dotted name, expanding import aliases
    on the root (``np.random.rand`` -> ``numpy.random.rand``)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(aliases.get(node.id, node.id))
    return ".".join(reversed(parts))


def _collect_aliases(tree: ast.Module) -> Dict[str, str]:
    """local name -> fully qualified module/object it was imported as."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


class _ScopeIndex(ast.NodeVisitor):
    """Map every node to its dotted enclosing scope (class/function names)."""

    def __init__(self) -> None:
        self.scope_of: Dict[ast.AST, str] = {}
        self._stack: List[str] = []

    def _enter(self, node: ast.AST, name: str) -> None:
        self._stack.append(name)
        self.generic_visit(node)
        self._stack.pop()

    def visit_FunctionDef(self, node):  # noqa: N802
        self._tag(node)
        self._enter(node, node.name)

    visit_AsyncFunctionDef = visit_FunctionDef  # noqa: N815

    def visit_ClassDef(self, node):  # noqa: N802
        self._tag(node)
        self._enter(node, node.name)

    def generic_visit(self, node):
        self._tag(node)
        super().generic_visit(node)

    def _tag(self, node: ast.AST) -> None:
        self.scope_of[node] = ".".join(self._stack) or "<module>"


@dataclasses.dataclass
class _FileCtx:
    path: str                 # relative posix path
    tree: ast.Module
    aliases: Dict[str, str]
    scopes: Dict[ast.AST, str]
    decision_path: bool

    def symbol(self, node: ast.AST) -> str:
        return self.scopes.get(node, "<module>")


# ---------------------------------------------------------------------------
# per-file rules
# ---------------------------------------------------------------------------

def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def _rule_unseeded_rng(ctx: _FileCtx) -> List[Violation]:
    out: List[Violation] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _TENSOR_SAMPLERS
                and not _has_generator(node)):
            out.append(Violation(
                "unseeded-rng", ctx.path, ctx.symbol(node), node.lineno,
                f"in-place {node.func.attr}() without generator= draws from "
                "torch's global generator — pass a seeded torch.Generator"))
            continue
        name = _dotted_name(node.func, ctx.aliases)
        if name is None:
            continue
        if name in _TORCH_GLOBAL_SEEDERS:
            out.append(Violation(
                "unseeded-rng", ctx.path, ctx.symbol(node), node.lineno,
                f"call to {name} (torch's global generator state) — seed a "
                "torch.Generator and pass it as generator="))
        elif (name.startswith("torch.") and name.count(".") == 1
              and name.split(".")[1] in _TORCH_SAMPLERS
              and not _has_generator(node)):
            out.append(Violation(
                "unseeded-rng", ctx.path, ctx.symbol(node), node.lineno,
                f"call to {name} without generator= draws from torch's "
                "global generator — pass a seeded torch.Generator"))
        elif name.startswith("numpy.random."):
            attr = name.split(".")[2]
            if attr not in _NP_RANDOM_OK:
                out.append(Violation(
                    "unseeded-rng", ctx.path, ctx.symbol(node), node.lineno,
                    f"call to module-level numpy.random.{attr} — draw from "
                    "an explicit np.random.default_rng(seed) instead"))
        elif name.startswith("random.") and name.count(".") == 1:
            attr = name.split(".")[1]
            if attr not in _STDLIB_RANDOM_OK:
                out.append(Violation(
                    "unseeded-rng", ctx.path, ctx.symbol(node), node.lineno,
                    f"call to stdlib random.{attr} (global, unseeded state) "
                    "— use a seeded np.random.default_rng"))
    return out


def _rule_wallclock(ctx: _FileCtx) -> List[Violation]:
    if not ctx.decision_path:
        return []
    out: List[Violation] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted_name(node.func, ctx.aliases)
        if name in _WALLCLOCK_CALLS:
            out.append(Violation(
                "wallclock", ctx.path, ctx.symbol(node), node.lineno,
                f"{name}() in a scheduler/driver decision path — wall-clock "
                "reads make slot decisions unreplayable"))
    return out


def _is_setlike_expr(node: ast.AST, set_names: Set[str]) -> bool:
    """Syntactically set-typed: literal, comprehension, set()/frozenset()
    call, ``.keys()`` call, a known set-typed local, or a binop of those
    (``a & b`` etc. preserves set-ness)."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id in (
                "set", "frozenset"):
            return True
        if isinstance(node.func, ast.Attribute) and node.func.attr == "keys":
            return True
        return False
    if isinstance(node, ast.Name):
        return node.id in set_names
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitAnd, ast.BitOr, ast.BitXor, ast.Sub)):
        return (_is_setlike_expr(node.left, set_names)
                or _is_setlike_expr(node.right, set_names))
    return False


def _rule_unordered_iter(ctx: _FileCtx) -> List[Violation]:
    if not ctx.decision_path:
        return []
    out: List[Violation] = []
    funcs = [n for n in ast.walk(ctx.tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for fn in funcs:
        # local names bound to set-like expressions within this function
        set_names: Set[str] = set()
        for node in ast.walk(fn):
            targets: List[ast.expr] = []
            value: Optional[ast.expr] = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            if value is not None and _is_setlike_expr(value, set_names):
                for t in targets:
                    if isinstance(t, ast.Name):
                        set_names.add(t.id)
        iters: List[Tuple[ast.expr, int]] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.For):
                iters.append((node.iter, node.lineno))
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                for gen in node.generators:
                    iters.append((gen.iter, node.lineno))
        for it, line in iters:
            if _is_setlike_expr(it, set_names):
                out.append(Violation(
                    "unordered-iter", ctx.path, ctx.symbol(fn), line,
                    "iteration over a set-typed value in a decision path — "
                    "wrap in sorted(...) so ordering is replayable"))
    return out


def _rule_unfrozen_dataclass(ctx: _FileCtx) -> List[Violation]:
    if ctx.path != "sched/api.py":
        return []
    out: List[Violation] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ClassDef) or node.name.startswith("_"):
            continue
        for dec in node.decorator_list:
            frozen = None
            if isinstance(dec, ast.Call):
                name = _dotted_name(dec.func, ctx.aliases)
                if name in ("dataclasses.dataclass", "dataclass"):
                    frozen = any(
                        kw.arg == "frozen"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is True
                        for kw in dec.keywords)
            else:
                name = _dotted_name(dec, ctx.aliases)
                if name in ("dataclasses.dataclass", "dataclass"):
                    frozen = False
            if frozen is False:
                out.append(Violation(
                    "unfrozen-dataclass", ctx.path, node.name, node.lineno,
                    f"public dataclass {node.name} in sched.api is not "
                    "frozen — slot artifacts must be immutable after "
                    "commit (or baselined as copy-on-commit)"))
    return out


def _rule_mutable_default(ctx: _FileCtx) -> List[Violation]:
    out: List[Violation] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        defaults = list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None]
        for d in defaults:
            mutable = isinstance(d, (ast.List, ast.Dict, ast.Set,
                                     ast.ListComp, ast.DictComp, ast.SetComp))
            if isinstance(d, ast.Call) and isinstance(d.func, ast.Name) \
                    and d.func.id in ("list", "dict", "set"):
                mutable = True
            if mutable:
                out.append(Violation(
                    "mutable-default", ctx.path, ctx.symbol(node), d.lineno,
                    f"mutable default argument in {node.name}() — shared "
                    "across calls; use None + in-body default"))
    return out


_FILE_RULES = (
    _rule_unseeded_rng,
    _rule_wallclock,
    _rule_unordered_iter,
    _rule_unfrozen_dataclass,
    _rule_mutable_default,
)


# ---------------------------------------------------------------------------
# repo-level rule: event coverage
# ---------------------------------------------------------------------------

def _event_subclasses(tree: ast.Module) -> List[str]:
    """ClusterEvent subclasses (transitively) defined in an events module."""
    known = {"ClusterEvent"}
    out: List[str] = []
    changed = True
    while changed:  # fixpoint over single-file inheritance chains
        changed = False
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef) or node.name in known:
                continue
            bases = {b.id for b in node.bases if isinstance(b, ast.Name)}
            if bases & known:
                known.add(node.name)
                out.append(node.name)
                changed = True
    return out


def _rule_event_coverage(root: str) -> List[Violation]:
    events_path = os.path.join(root, "sched", "events.py")
    driver_path = os.path.join(root, "sched", "driver.py")
    if not (os.path.exists(events_path) and os.path.exists(driver_path)):
        return []
    with open(events_path) as f:
        events_tree = ast.parse(f.read(), events_path)
    with open(driver_path) as f:
        driver_tree = ast.parse(f.read(), driver_path)
    subclasses = _event_subclasses(events_tree)
    # a Name *load* in driver.py counts as handled (isinstance dispatch or
    # construction or an explicit-ignore branch); bare imports do not
    handled = {n.id for n in ast.walk(driver_tree)
               if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}
    out: List[Violation] = []
    for name in subclasses:
        if name not in handled:
            out.append(Violation(
                "event-coverage", "sched/driver.py",
                f"OnlineDriver.run[{name}]", 1,
                f"event {name} (sched/events.py) is never dispatched or "
                "explicitly ignored in the driver — streams emitting it "
                "would be silently dropped, breaking replay"))
    return out


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def default_root() -> str:
    """The repro_torch package root (the directory containing sched/,
    core/, ...)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "lint_baseline.txt")


def _iter_py_files(root: str) -> Iterable[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith("__"))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def run_lint(root: Optional[str] = None) -> List[Violation]:
    """Run every rule over ``root`` (default: the repro_torch package)."""
    root = os.path.abspath(root or default_root())
    violations: List[Violation] = []
    for path in _iter_py_files(root):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        if rel.startswith("analysis/"):
            continue  # the linter does not lint its own rule fixtures
        with open(path) as f:
            source = f.read()
        try:
            tree = ast.parse(source, path)
        except SyntaxError as e:
            violations.append(Violation(
                "syntax-error", rel, "<module>", e.lineno or 1, str(e)))
            continue
        idx = _ScopeIndex()
        idx.visit(tree)
        ctx = _FileCtx(
            path=rel, tree=tree, aliases=_collect_aliases(tree),
            scopes=idx.scope_of,
            decision_path=rel.startswith(DECISION_PATH_PREFIXES),
        )
        for rule in _FILE_RULES:
            violations.extend(rule(ctx))
    violations.extend(_rule_event_coverage(root))
    return sorted(violations, key=lambda v: (v.path, v.line, v.rule))


def violations_json(violations: Sequence[Violation],
                    baseline: Baseline) -> Dict:
    """Machine-readable findings (the --json artifact schema, shared with
    repro.analysis.collectives): every violation with rule/path/line/symbol/
    message plus its baseline status, and the stale/malformed ledger state
    that also fails the gate."""
    new, stale = apply_baseline(violations, baseline)
    new_keys = {v.key for v in new}
    return {
        "tool": "repro_torch.analysis.lint",
        "findings": [
            {"rule": v.rule, "path": v.path, "line": v.line,
             "symbol": v.symbol, "message": v.message, "key": v.key,
             "baselined": v.key not in new_keys}
            for v in violations
        ],
        "stale": stale,
        "malformed": list(baseline.malformed),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="repo-specific determinism/accounting lint over "
                    "src/repro_torch")
    parser.add_argument("--root", default=None,
                        help="package root to lint (default: repro_torch)")
    parser.add_argument("--baseline", default=None,
                        help="baseline file (default: "
                             "repro_torch/analysis/lint_baseline.txt)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="report every violation, ignoring the baseline")
    parser.add_argument("--write-baseline", action="store_true",
                        help="write the current violation set as the "
                             "baseline; written placeholder entries still "
                             "fail the lint until each is justified")
    parser.add_argument("--json", default=None, metavar="PATH",
                        help="also write machine-readable findings "
                             "(rule/path/line/symbol/message) to PATH")
    args = parser.parse_args(argv)
    baseline_path = args.baseline or default_baseline_path()
    violations = run_lint(args.root)

    if args.write_baseline:
        n = write_baseline(baseline_path, (v.key for v in violations),
                           tool="repro_torch.analysis.lint")
        print(f"wrote {n} baseline entries -> {baseline_path}")
        print("placeholder justifications still FAIL the lint — replace "
              "each 'TODO justify' with a real rationale")
        return 0

    baseline = Baseline(entries={}, malformed=[]) if args.no_baseline \
        else Baseline.load(baseline_path)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(violations_json(violations, baseline), f, indent=2)
    new, stale = apply_baseline(violations, baseline)
    status = 0
    for v in new:
        print(v)
        status = 1
    for line in baseline.malformed:
        print(f"baseline entry missing or placeholder justification: {line}")
        status = 1
    for key in stale:
        print(f"stale baseline entry (violation no longer fires — delete "
              f"the line): {key}")
        status = 1
    suppressed = len(violations) - len(new)
    print(f"lint: {len(violations)} violation(s), {suppressed} baselined, "
          f"{len(new)} new, {len(stale)} stale -> "
          f"{'FAIL' if status else 'OK'}")
    return status


if __name__ == "__main__":
    sys.exit(main())
