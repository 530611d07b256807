"""Nothing the benchmark runs loads JAX or the JAX package (top-level module
names compared whole: the program's ``repro_torch`` begins with
``repro``), and the references load nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
REFERENCE = ROOT / "perfbench" / "reference"


def test_forbidden_names_are_whole_top_level_names():
    assert "repro" in harness.FORBIDDEN and "repro_torch" not in harness.FORBIDDEN
    loaded = set(sys.modules)
    try:
        sys.modules["repro_torch_lookalike"] = sys.modules["json"]
        sys.modules["jaxlib.fake"] = sys.modules["json"]
        assert harness.forbidden_modules() == ["jaxlib.fake"] + sorted(
            m for m in loaded if m.split(".")[0] in harness.FORBIDDEN)
    finally:
        sys.modules.pop("repro_torch_lookalike")
        sys.modules.pop("jaxlib.fake")


def test_a_small_run_loads_no_jax_and_no_reference_package():
    code = (
        "import sys, time; sys.path[:0] = ['src', '.']\n"
        "from perfbench import harness\n"
        "from perfbench.tests import small\n"
        "conf, mix = small.cell_inputs('phi3.5-moe-42b-l1.ring-int8.w4')\n"
        "r = harness.run_cell(small.bench(), 'phi3.5-moe-42b-l1.ring-int8.w4',"
        " seed=1, seconds=0.1, traced=True, device='cpu', t0=time.perf_counter(),"
        " conf=conf, mix=mix)\n"
        "assert r['correct'], r\n"
        "print(harness.forbidden_modules(), 'repro_torch' in sys.modules)\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().splitlines()[-1] == "[] True"


def test_references_import_nothing_of_the_program():
    for path in REFERENCE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("repro_torch", *harness.FORBIDDEN), (
                    path.name, name)
    code = ("import sys; sys.path[:0] = ['.']\n"
            "import importlib, pathlib\n"
            "for p in pathlib.Path('perfbench/reference').rglob('*.py'):\n"
            "    importlib.import_module('.'.join(p.with_suffix('').parts))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip() == "[]"
