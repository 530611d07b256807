"""Import isolation of the PyTorch port: ``repro_torch`` and
``chip_smoke.py`` import neither JAX nor anything of the JAX package.

The runtime check is a subprocess because this test process has JAX
loaded already (tests/conftest.py installs the JAX package's shims).
"""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_modules():
    names = ["repro_torch"]
    for info in pkgutil.walk_packages([str(PORT)], prefix="repro_torch."):
        names.append(info.name)
    return names


def test_port_modules_import_without_jax_or_reference():
    modules = _port_modules()
    assert "repro_torch.training.elastic" in modules
    assert "repro_torch.kernels.quant_ring" in modules
    for name in ("kernels.flash_attention", "configs.granite_3_2b",
                 "configs.h2o_danube_1p8b", "kernels.rwkv6_wkv",
                 "models.rwkv", "configs.rwkv6_7b", "core.gvne", "core.lp",
                 "sched.driver", "sched.backend", "analysis.sanitize",
                 "cluster.calibrate", "launch.schedule_and_train",
                 "kernels.ssd_scan", "models.ssm", "configs.zamba2_1p2b",
                 "cluster.traces", "cluster.metrics", "cluster.simulator",
                 "launch.serve", "sched.serving", "models.moe_model",
                 "models.encdec", "configs.phi3p5_moe_42b",
                 "configs.arctic_480b", "configs.whisper_large_v3",
                 "configs.internvl2_26b", "configs.phi3_medium_14b",
                 "training.ft", "training.checkpoint", "analysis.baseline",
                 "analysis.lint", "launch.quickstart", "launch.serve_batched",
                 "analysis.collectives", "analysis.fixtures",
                 "analysis.kernels", "dist.sharding", "launch.mesh",
                 "launch.cost_analysis", "launch.dryrun",
                 "launch.profile_cell"):
        assert f"repro_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ISOLATED', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED" in proc.stdout


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_jax_or_reference_import_in_port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"
