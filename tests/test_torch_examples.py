"""The port's example CLIs against the reference's examples.

  * ``python -m repro_torch.launch.quickstart`` (scheduler-only numpy, no
    device): its stdout equal line for line to ``examples/quickstart.py``'s.
  * ``repro_torch.launch.serve_batched`` on the CPU against
    ``examples/serve_batched.py``, run in this process with its models'
    weights drawn in f32 (the port's demo serves f32 weights; the example
    draws the specs' bf16) and carried across by ``params_from_reference``:
    every request's tokens equal to the reference engine's for each of the
    four families, and the co-schedule's slot table and SLO attainment
    line equal to the reference's.
"""

import contextlib
import importlib.util
import inspect
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models.model import build_model as jax_build_model
from repro_torch.launch import quickstart, serve_batched
from repro_torch.models.module import params_from_reference

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the reduced models' ops are small, and test
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_prints_the_references_lines(capsys):
    quickstart.main()
    port = capsys.readouterr().out.splitlines()
    _example("quickstart").main()
    ref = capsys.readouterr().out.splitlines()
    assert port == ref and len(ref) == 17
    assert ref[-1].startswith("  total_utility=")


def _reference_f32_params(arch: str):
    model = jax_build_model(jax_get_arch(arch).reduced())
    return model.init(jax.random.PRNGKey(0), dtype=jnp.float32)


def _from_reference(arch: str, model, device: str):
    """The port demo's params factory: the reference's f32 weights."""
    return params_from_reference(
        jax.tree.map(np.asarray, _reference_f32_params(arch)), device)


@pytest.fixture(scope="module")
def reference_run():
    """The reference example's two demos, its models' weights in f32 and
    every engine it builds recorded; returns (stdout lines, engines)."""
    mod = _example("serve_batched")
    engines = []

    class Recording(mod.ServingEngine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            engines.append(self)

    def build_f32(cfg):
        model = jax_build_model(cfg)
        init = model.init
        model.init = lambda key, dtype=None: init(key, dtype=jnp.float32)
        return model

    mod.ServingEngine, mod.build_model = Recording, build_f32
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.engine_demo()
        mod.coschedule_demo()
    return buf.getvalue().splitlines(), engines


@pytest.fixture(scope="module")
def port_run():
    """The port's two demos on the CPU from the reference's weights."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = {
            "engines": serve_batched.engine_demo("cpu", _from_reference),
            "coschedule": serve_batched.coschedule_demo("cpu", _from_reference)}
    return buf.getvalue().splitlines(), summary


def test_serve_batched_defaults_to_the_card():
    for fn in (serve_batched.engine_demo, serve_batched.coschedule_demo):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this process has a card")
    # no card: the default raises, nothing moves to the CPU
    with pytest.raises((RuntimeError, AssertionError)):
        serve_batched.main([])


def test_engine_demo_tokens_equal_reference(reference_run, port_run):
    _, engines = reference_run
    _, summary = port_run
    ref = dict(zip(serve_batched.ARCHS, engines))
    assert [e.arch for e in ref.values()] == [f"{a}-reduced" for a in ref]
    assert list(summary["engines"]) == serve_batched.ARCHS
    for arch, got in summary["engines"].items():
        want = {r.id: list(map(int, r.tokens)) for r in ref[arch].finished}
        assert got["tokens"] == want, arch
        assert got["served"] == len(want) == serve_batched.N_REQUESTS
        assert got["captures"] == [1, 1, 1] and got["device"] == "cpu"
        assert ref[arch].compile_count == 1


def test_coschedule_table_and_attainment_equal_reference(reference_run, port_run):
    ref_lines, _ = reference_run
    port_lines, summary = port_run

    def block(lines):
        start = lines.index("slot  train  serve  served_tokens")
        return lines[start:start + serve_batched.HORIZON + 2]

    assert block(port_lines) == block(ref_lines)
    assert block(ref_lines)[-1].startswith("SLO attainment (from event log): ")
    co = summary["coschedule"]
    assert co["slo_attainment"] == co["reported_attainment"]
    assert f"{co['slo_attainment']:.3f}" in block(ref_lines)[-1]
    assert min(co["workers"][0][serve_batched.BURST_START:]) <= 2
    json.dumps(summary)  # the CLI's last line
