"""The port's determinism lint (``repro_torch.analysis.lint``) and its
baseline plumbing, held against the reference's (``repro.analysis.lint``).

Every lint and baseline case of ``tests/test_analysis.py`` is mirrored on
the port's lint: the same synthetic trees go through both lints, and the
findings each writes with ``--json`` (rule, path, line, symbol, message,
key, baselined) are equal, as are the stale and malformed entries. The
torch-RNG case is the port's own: the reference's ``jax.random`` has no
global state, so its lint has no torch rule, and the port is held to
explicit ``torch.Generator`` draws. Last, the port's tree is clean against
its checked-in baseline, and ``python -m repro_torch.analysis.lint`` exits 0.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import lint as jax_lint
from repro_torch.analysis import lint as alint

ROOT = Path(__file__).resolve().parents[1]

WALLCLOCK = {
    "sched/bad.py": """
        import time

        def decide():
            return time.time()
    """,
}

# the synthetic trees of tests/test_analysis.py, and the keys each fires
TREES = {
    "wallclock": ({
        **WALLCLOCK,
        "util/ok.py": """
            import time

            def bench():
                return time.perf_counter()
        """,
    }, ["wallclock:sched/bad.py:decide"]),
    "unseeded-rng": ({
        "util/rng.py": """
            import random
            import numpy as np

            def bad():
                return np.random.rand(3) + random.random()

            def good(seed):
                rng = np.random.default_rng(seed)
                return rng.standard_normal(3)
        """,
    }, ["unseeded-rng:util/rng.py:bad", "unseeded-rng:util/rng.py:bad"]),
    "unordered-iter": ({
        "core/order.py": """
            def bad(xs):
                pending = set(xs)
                return [x for x in pending]

            def bad_literal(a, b):
                for x in {a} | {b}:
                    yield x

            def good(xs):
                pending = set(xs)
                return [x for x in sorted(pending)]
        """,
    }, ["unordered-iter:core/order.py:bad",
        "unordered-iter:core/order.py:bad_literal"]),
    "unfrozen-dataclass": ({
        rel: """
            import dataclasses

            @dataclasses.dataclass
            class Record:
                x: int

            @dataclasses.dataclass(frozen=True)
            class Frozen:
                x: int

            @dataclasses.dataclass
            class _Private:
                x: int
        """ for rel in ("sched/api.py", "util/other.py")
    }, ["unfrozen-dataclass:sched/api.py:Record"]),
    "mutable-default": ({
        "util/defs.py": """
            def bad(acc=[]):
                return acc

            def good(acc=None):
                return acc or []
        """,
    }, ["mutable-default:util/defs.py:bad"]),
    "event-coverage": ({
        "sched/events.py": """
            class ClusterEvent:
                pass

            class Alpha(ClusterEvent):
                pass

            class Beta(Alpha):
                pass
        """,
        "sched/driver.py": """
            from repro.sched.events import Alpha

            class OnlineDriver:
                def run(self, ev):
                    if isinstance(ev, Alpha):
                        return 1
                    return 0
        """,
    }, ["event-coverage:sched/driver.py:OnlineDriver.run[Beta]"]),
}


def _write_tree(root, files):
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    return str(root)


def _findings(lint, root, baseline, out):
    """(exit code, the --json record without its tool name) of ``lint``."""
    rc = lint.main(["--root", root, "--baseline", str(baseline),
                    "--json", str(out)])
    data = json.loads(out.read_text())
    return rc, data.pop("tool"), data


@pytest.mark.parametrize("rule", list(TREES))
def test_rule_fires_as_in_reference(rule, tmp_path):
    files, keys = TREES[rule]
    root = _write_tree(tmp_path / "tree", files)
    empty = tmp_path / "empty_baseline.txt"
    empty.write_text("# empty\n")
    rc, tool, got = _findings(alint, root, empty, tmp_path / "port.json")
    jrc, jtool, want = _findings(jax_lint, root, empty, tmp_path / "ref.json")
    assert (tool, jtool) == ("repro_torch.analysis.lint", "repro.analysis.lint")
    assert got == want and rc == jrc == 1
    vs = alint.run_lint(root)
    assert sorted(v.key for v in vs) == sorted(keys)
    assert {v.rule for v in vs} == {rule}
    if rule == "unseeded-rng":  # np.random.rand and random.random
        assert len(vs) == 2 and all(v.symbol == "bad" for v in vs)


def test_torch_global_generator_is_unseeded_rng(tmp_path):
    root = _write_tree(tmp_path, {
        "models/init.py": """
            import torch
            from torch import randn

            def seeds():
                torch.manual_seed(0)
                torch.cuda.manual_seed_all(0)

            def draws(x):
                a = torch.rand(3) + randn(3) + torch.randint(0, 5, (3,))
                b = torch.randperm(4).float() + torch.normal(0.0, 1.0, (4,))
                c = torch.bernoulli(x) + torch.multinomial(x, 1)
                return a, b, c, x.normal_(), torch.rand_like(x)

            def seeded(x, seed):
                gen = torch.Generator()
                gen.manual_seed(seed)
                return (torch.rand(3, generator=gen),
                        torch.randn(3, generator=gen),
                        torch.randint(0, 5, (3,), generator=gen),
                        torch.randperm(4, generator=gen),
                        torch.multinomial(x, 1, generator=gen),
                        x.uniform_(generator=gen), torch.zeros(3))
        """,
    })
    vs = alint.run_lint(root)
    assert {v.rule for v in vs} == {"unseeded-rng"}
    by_symbol = {}
    for v in vs:
        by_symbol[v.symbol] = by_symbol.get(v.symbol, 0) + 1
    # two global seeders; rand, randn (imported bare), randint, randperm,
    # normal, bernoulli, multinomial, normal_ and rand_like without a
    # generator; nothing in the seeded function
    assert by_symbol == {"seeds": 2, "draws": 9}
    # the reference's lint, with no torch rule, sees none of them
    assert jax_lint.run_lint(root) == []


def test_port_tree_is_lint_clean_against_baseline():
    """The CI gate as a test: no new violations, no stale/malformed entries."""
    violations = alint.run_lint()
    baseline = alint.Baseline.load(alint.default_baseline_path())
    new, stale = alint.apply_baseline(violations, baseline)
    assert new == [], "\n".join(str(v) for v in new)
    assert stale == []
    assert baseline.malformed == []
    assert Path(alint.default_root()) == ROOT / "src" / "repro_torch"


def test_lint_module_exits_zero_on_the_port_tree():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint"],
                          env=env, capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("-> OK")


def test_lint_main_exit_codes(tmp_path):
    assert alint.main([]) == 0  # the port's tree against its baseline

    root = _write_tree(tmp_path, WALLCLOCK)
    empty = tmp_path / "empty_baseline.txt"
    empty.write_text("# empty\n")
    assert alint.main(["--root", root, "--baseline", str(empty)]) == 1
    assert jax_lint.main(["--root", root, "--baseline", str(empty)]) == 1

    ok = tmp_path / "baseline.txt"
    ok.write_text("wallclock:sched/bad.py:decide  # fixture debt\n")
    assert alint.main(["--root", root, "--baseline", str(ok)]) == 0

    # paid-off debt must leave the ledger: same baseline, violation gone
    (tmp_path / "sched" / "bad.py").write_text("def decide():\n    return 0\n")
    assert alint.main(["--root", root, "--baseline", str(ok)]) == 1
    assert jax_lint.main(["--root", root, "--baseline", str(ok)]) == 1


def test_baseline_requires_justification(tmp_path):
    path = tmp_path / "baseline.txt"
    path.write_text("wallclock:sched/bad.py:decide\n")
    baseline = alint.Baseline.load(str(path))
    ref = jax_lint.Baseline.load(str(path))
    assert baseline.entries == ref.entries == {}
    assert baseline.malformed == ref.malformed == ["wallclock:sched/bad.py:decide"]


def test_write_baseline_placeholders_cannot_silence_lint(tmp_path):
    """A freshly bootstrapped baseline documents the debt but still fails
    the gate until every `TODO justify` placeholder is replaced."""
    root = _write_tree(tmp_path, WALLCLOCK)
    baseline = tmp_path / "baseline.txt"
    assert alint.main(["--root", root, "--baseline", str(baseline),
                       "--write-baseline"]) == 0
    text = baseline.read_text()
    assert "wallclock:sched/bad.py:decide  # TODO justify" in text

    assert alint.main(["--root", root, "--baseline", str(baseline)]) == 1
    loaded = alint.Baseline.load(str(baseline))
    assert loaded.entries == {}
    assert loaded.malformed == ["wallclock:sched/bad.py:decide"
                                "  # TODO justify"]
    # the reference's lint reads the port's bootstrap file the same way
    ref = jax_lint.Baseline.load(str(baseline))
    assert (ref.entries, ref.malformed) == (loaded.entries, loaded.malformed)

    baseline.write_text(text.replace("TODO justify",
                                     "fixture debt, tracked"))
    assert alint.main(["--root", root, "--baseline", str(baseline)]) == 0


def test_lint_json_findings(tmp_path):
    root = _write_tree(tmp_path / "tree", WALLCLOCK)
    empty = tmp_path / "empty_baseline.txt"
    empty.write_text("# empty\n")
    rc, tool, data = _findings(alint, root, empty, tmp_path / "port.json")
    assert rc == 1 and tool == "repro_torch.analysis.lint"
    assert data["stale"] == [] and data["malformed"] == []
    (record,) = data["findings"]
    assert record["rule"] == "wallclock"
    assert record["path"] == "sched/bad.py"
    assert record["symbol"] == "decide"
    assert record["line"] > 0
    assert record["baselined"] is False
    assert record["key"] == "wallclock:sched/bad.py:decide"
    assert data == _findings(jax_lint, root, empty, tmp_path / "ref.json")[2]


def test_lint_json_marks_suppressed_findings(tmp_path):
    root = _write_tree(tmp_path / "tree", WALLCLOCK)
    ok = tmp_path / "baseline.txt"
    ok.write_text("wallclock:sched/bad.py:decide  # fixture debt\n")
    rc, _, data = _findings(alint, root, ok, tmp_path / "port.json")
    assert rc == 0
    (record,) = data["findings"]
    assert record["baselined"] is True
    assert data == _findings(jax_lint, root, ok, tmp_path / "ref.json")[2]


def test_stale_entry_reported_as_in_reference(tmp_path):
    root = _write_tree(tmp_path / "tree", {"util/ok.py": "X = 1\n"})
    stale = tmp_path / "baseline.txt"
    stale.write_text("wallclock:sched/bad.py:decide  # paid off\n"
                     "mutable-default:util/defs.py:bad\n")
    rc, _, data = _findings(alint, root, stale, tmp_path / "port.json")
    assert rc == 1
    assert data["stale"] == ["wallclock:sched/bad.py:decide"]
    assert data["malformed"] == ["mutable-default:util/defs.py:bad"]
    assert data == _findings(jax_lint, root, stale, tmp_path / "ref.json")[2]
