"""Fault tolerance (``repro_torch.training.ft``) and ``checkpoint.latest_step``
held against the reference's (``repro.training.ft``, ``repro.training.
checkpoint``).

  * ``latest_step`` reads the same manifest as the reference's, and None
    without one.
  * ``HeartbeatMonitor.dead`` and ``stragglers`` return the reference's
    lists, in its order, on seeded heartbeat sequences: repeated beats of
    one worker, fewer than two workers, and ties (a step time exactly
    ``straggler_factor`` times the median, a beat exactly ``timeout`` old),
    which flag nothing on either side.
  * ``FaultTolerantRunner`` on reduced qwen3-0.6b (``compressed-fused``,
    AdamW) with the reference test's plans and injector
    (``tests/test_training.py::test_fault_tolerant_recovery``: 2 survivors
    in slot 1) on the CPU. The injector also fills the trainer's params and
    moments with NaN, so the run continues correctly only if the restore
    read the checkpoint. Held: the reference's ``recoveries`` and
    ``final_step``, the restored state bit-identical to the state at the
    end of slot 0, and every loss bit-identical to a plain port trainer
    (no checkpoint) over the plans the runner ran, ``[(4, 3), (2, 3), (4,
    2)]``.
  * The same run against the reference runner, in one subprocess (this
    file run as a script, 8 host devices, ``.npz`` out) from the
    reference's initial parameters: losses within ``LOSS_ATOL`` and every
    final leaf (parameters, m, v) within the ``compressed-fused`` limit of
    ``tests/test_torch_training.py`` (5e-3 relative norm; its docstring
    says why).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.training import checkpoint as jax_checkpoint
from repro.training import ft as jax_ft
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models.model import build_model
from repro_torch.models.module import _flatten, _unflatten, params_from_reference
from repro_torch.training import FaultTolerantRunner, Heartbeat, HeartbeatMonitor
from repro_torch.training import checkpoint
from repro_torch.training.elastic import ElasticTrainer, SlotPlan
from repro_torch.training.optimizer import make_optimizer

ARCH, MODE = "qwen3-0.6b", "compressed-fused"
SEQ, GLOBAL_BATCH, LR = 16, 8, 1e-3
# the reference test's plans, its failing slot and survivors, and the plans
# the runner runs in their place
PLANS = [(4, 3), (4, 3), (4, 2)]
FAIL_SLOT, SURVIVORS = 1, 2
RAN = [(4, 3), (2, 3), (4, 2)]
# tests/test_torch_training.py's limits for compressed-fused
LEAF_LIMIT, LOSS_ATOL = 5e-3, 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the reduced model's ops are small, and test
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def jax_proc(tmp_path_factory):
    """The reference runner in a subprocess, started before the module's
    first test so that the port's tests run beside it."""
    tmp = tmp_path_factory.mktemp("ft_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(tmp / "out.npz"),
         str(tmp / "ckpt")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield proc, tmp / "out.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_out(jax_proc):
    proc, out = jax_proc
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    with np.load(out) as f:
        return dict(f)


def test_latest_step_matches_reference(tmp_path):
    d = str(tmp_path / "ckpt")
    assert checkpoint.latest_step(d) is None
    assert jax_checkpoint.latest_step(d) is None
    params = {"w": torch.arange(4, dtype=torch.float32)}
    for step in (0, 7, 12):
        checkpoint.save_checkpoint(d, params=params, step=step)
        assert checkpoint.latest_step(d) == jax_checkpoint.latest_step(d) == step
    # the reference's writer, read by the port's
    jax_checkpoint.save_checkpoint(d, params={"w": np.zeros(3, np.float32)},
                                   step=31)
    assert checkpoint.latest_step(d) == 31


def _beats(rng, n_workers, n_beats):
    """Heartbeats of ``n_workers`` workers in a seeded order, repeats
    included; a few step times drawn from a small set so medians tie."""
    for _ in range(n_beats):
        w = int(rng.integers(0, n_workers))
        st = float(rng.choice([0.5, 1.0, 1.0, 2.5]) if rng.random() < 0.5
                   else rng.exponential(1.0))
        yield w, int(rng.integers(0, 100)), float(rng.uniform(0.0, 30.0)), st


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n_workers", [1, 2, 5, 9])
def test_heartbeat_monitor_matches_reference(seed, n_workers):
    rng = np.random.default_rng(seed)
    timeout = float(rng.choice([5.0, 10.0]))
    factor = float(rng.choice([1.5, 2.5]))
    mon = HeartbeatMonitor(timeout=timeout, straggler_factor=factor)
    ref = jax_ft.HeartbeatMonitor(timeout=timeout, straggler_factor=factor)
    assert mon.dead(0.0) == ref.dead(0.0) == []
    assert mon.stragglers() == ref.stragglers() == []
    for args in _beats(rng, n_workers, 3 * n_workers + 2):
        mon.beat(Heartbeat(*args))
        ref.beat(jax_ft.Heartbeat(*args))
        assert mon.stragglers() == ref.stragglers()
        for now in (0.0, 12.5, 25.0, 40.0, float(rng.uniform(0, 45))):
            assert mon.dead(now) == ref.dead(now)
    assert list(mon.last) == list(ref.last)
    if n_workers == 1:
        assert mon.stragglers() == []


def test_heartbeat_ties_flag_nothing():
    for mod in (jax_ft, None):
        hb = mod.Heartbeat if mod else Heartbeat
        mon = (mod.HeartbeatMonitor if mod else HeartbeatMonitor)(
            timeout=10.0, straggler_factor=2.5)
        for w, st in enumerate([1.0, 1.0, 2.5]):
            mon.beat(hb(worker=w, step=3, t=5.0, step_time=st))
        assert mon.stragglers() == []        # 2.5 == 2.5 x median 1.0
        assert mon.dead(15.0) == []          # exactly timeout old
        mon.beat(hb(worker=3, step=3, t=5.0, step_time=10.0))
        # median 1.75: 10.0 is beyond 2.5 x 1.75, 2.5 is not
        assert mon.stragglers() == [3] and mon.dead(15.5) == [0, 1, 2, 3]


def _setup():
    cfg = get_arch(ARCH).reduced()
    return build_model(cfg), SyntheticTokens(cfg.vocab, SEQ, GLOBAL_BATCH, seed=0)


def _trainer(params, **kw):
    model, data = _setup()
    return ElasticTrainer(model, make_optimizer("adamw"), data,
                          global_batch=GLOBAL_BATCH, base_lr=LR, mode=MODE,
                          device="cpu", params=params, **kw)


def _state(trainer) -> dict:
    """A copy of the trainer's state: its first replica's params and
    optimizer state, flat."""
    return {k: v.clone() for k, v in _flatten(
        {"params": next(iter(trainer.params.values())),
         "opt": next(iter(trainer.opt_state.values()))})}


def _poison(trainer) -> None:
    """Every floating leaf of every replica of params and moments to NaN."""
    for tree in list(trainer.params.values()) + list(trainer.opt_state.values()):
        for _, v in _flatten(tree):
            if v.is_floating_point():
                v.fill_(float("nan"))


def run_ft(params, ckpt_dir):
    """The runner with the reference test's plans and injector, the state
    poisoned at the failure; returns the trainer, the runner's result, the
    state at the end of each slot and the state right after the restore."""
    tr = _trainer(params, checkpoint_dir=ckpt_dir)
    slot_ends, restored = [], []
    run_slot, restore = tr.run_slot, tr.restore

    def recording_run_slot(plan):
        out = run_slot(plan)
        slot_ends.append(_state(tr))
        return out

    def recording_restore():
        ok = restore()
        restored.append(_state(tr))
        return ok

    tr.run_slot, tr.restore = recording_run_slot, recording_restore

    def injector(slot):
        if slot == FAIL_SLOT:
            _poison(tr)
            return SURVIVORS
        return None

    runner = FaultTolerantRunner(tr, fail_injector=injector)
    res = runner.run([SlotPlan(w, s) for w, s in PLANS])
    return tr, res, slot_ends, restored


def _assert_same_state(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_runner_recovers_bit_identically(tmp_path):
    model, _ = _setup()
    params = model.init(0, device="cpu", dtype=torch.float32)
    tr, res, slot_ends, restored = run_ft(params, str(tmp_path / "ckpt"))
    assert res["recoveries"] == 1 and res["final_step"] == 8
    assert tr.restores == 1 and len(restored) == 1 and len(slot_ends) == 3
    assert checkpoint.latest_step(str(tmp_path / "ckpt")) == 8
    _assert_same_state(restored[0], slot_ends[0])
    plain = _trainer(params)
    for w, s in RAN:
        plain.run_slot(SlotPlan(w, s))
    assert len(tr.losses) == 8 and tr.losses == plain.losses
    assert res["final_loss"] == plain.losses[-1]
    _assert_same_state(_state(tr), _state(plain))
    with pytest.raises(ValueError):
        FaultTolerantRunner(plain)               # no checkpoint_dir


def test_runner_matches_reference(jax_out, tmp_path):
    init = params_from_reference(_unflatten(
        {k[len("init/"):]: v for k, v in jax_out.items()
         if k.startswith("init/")}), "cpu")
    tr, res, _, _ = run_ft(init, str(tmp_path / "ckpt"))
    recoveries, final_step, restores = jax_out["counts"]
    assert (res["recoveries"], res["final_step"], tr.restores) == (
        recoveries, final_step, restores) == (1, 8, 1)
    want = jax_out["losses"]
    assert len(tr.losses) == len(want) == 8
    np.testing.assert_allclose(tr.losses, want, rtol=0, atol=LOSS_ATOL)
    leaves = _state(tr)
    assert int(leaves.pop("opt/step")) == int(jax_out["final/opt/step"]) == 8
    assert sorted(leaves) == sorted(k[len("final/"):] for k in jax_out
                                    if k.startswith("final/")
                                    and k != "final/opt/step")
    for path, v in leaves.items():
        ref = jax_out[f"final/{path}"].astype(np.float64)
        gap = np.linalg.norm(v.numpy().astype(np.float64) - ref) / np.linalg.norm(ref)
        assert gap < LEAF_LIMIT, (path, gap)


def _jax_reference(out, ckpt_dir):
    import jax

    from repro.configs import get_arch as jax_get_arch
    from repro.data.pipeline import SyntheticTokens as JaxTokens
    from repro.models.model import build_model as jax_build_model
    from repro.models.module import _flatten as jax_flatten
    from repro.training.elastic import ElasticTrainer as JaxTrainer
    from repro.training.elastic import SlotPlan as JaxPlan
    from repro.training.optimizer import make_optimizer as jax_make_optimizer

    cfg = jax_get_arch(ARCH).reduced()
    model = jax_build_model(cfg)
    data = JaxTokens(cfg.vocab, SEQ, GLOBAL_BATCH, seed=0)
    tr = JaxTrainer(model, jax_make_optimizer("adamw"), data,
                    global_batch=GLOBAL_BATCH, base_lr=LR, mode=MODE,
                    checkpoint_dir=ckpt_dir)
    res = {f"init/{p}": np.asarray(v)
           for p, v in jax_flatten(jax.device_get(tr.params))}
    runner = jax_ft.FaultTolerantRunner(
        tr, fail_injector=lambda slot: SURVIVORS if slot == FAIL_SLOT else None)
    out_res = runner.run([JaxPlan(w, s) for w, s in PLANS])
    res["losses"] = np.array(tr.losses)
    res["counts"] = np.array([out_res["recoveries"], out_res["final_step"],
                              tr.restores])
    state = {"params": tr.params, "opt": tr.opt_state}
    for p, v in jax_flatten(jax.device_get(state)):
        res[f"final/{p}"] = np.asarray(v)
    np.savez(out, **res)


if __name__ == "__main__":
    _jax_reference(sys.argv[1], sys.argv[2])
