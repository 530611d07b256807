"""The slice as a whole: the port's ``ElasticTrainer`` held loss for loss
against the JAX package's, on reduced qwen3-0.6b with AdamW, in modes
``ring`` (the paper's f32 ring) and ``compressed-fused`` (the fused int8
ring), across a slot-boundary resize w=4 -> 2 and a mid-slot re-ring.

The JAX trainers run in one subprocess (this file run as a script) on 8
host devices, the reference's layout; the port runs its ranks on the CPU
and starts from the reference trainer's initial parameters.

Losses agree to atol 1e-5 in both modes; measured: at most 9.5e-7 (one ulp
of the loss). AdamW's update does not change when every gradient is scaled
by one factor, so the losses alone would pass a reduced gradient of the
wrong scale (a missing ``/ w``). The final parameters and the AdamW moments
m and v are therefore held against the reference's too, per leaf, by
||port - ref|| / ||ref||: a gradient k times too large makes that k - 1 for
m and k^2 - 1 for v. Limits, with the largest measured per-leaf gaps:

  * ``ring``: 1e-5 (measured 1.7e-6). The f32 ring is bit-identical to the
    reference's; what is left is autograd's ulps.
  * ``compressed-fused``: 5e-3 (measured 7.6e-4, on m). Each rank's
    gradient differs from the reference's by ulps, which now and then moves
    an element across a rounding tie of the int8 quantizer: one int8 step,
    1/127 of its block's amax.
"""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.training.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.training.elastic import largest_feasible_ring as jax_largest_feasible_ring
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import train as train_cli
from repro_torch.models.model import build_model
from repro_torch.models.module import _flatten, _unflatten, params_from_reference
from repro_torch.training.elastic import (
    ElasticTrainer,
    RingWorkerGroup,
    SlotPlan,
    largest_feasible_ring,
)
from repro_torch.training.optimizer import make_optimizer

ARCH = "qwen3-0.6b"
SEQ, GLOBAL_BATCH, LR = 16, 8, 1e-3
PLANS = [(4, 2, None), (2, 2, None), (4, 4, (2, 2))]
# mode -> limit on each final leaf's relative gap to the reference
MODES = {"ring": 1e-5, "compressed-fused": 5e-3}
LOSS_ATOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_ref") / "out.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as f:
        return dict(f)


def _setup():
    cfg = get_arch(ARCH).reduced()
    return build_model(cfg), SyntheticTokens(cfg.vocab, SEQ, GLOBAL_BATCH, seed=0)


def _init_params(jax_out):
    return params_from_reference(_unflatten(
        {k[len("init/"):]: v for k, v in jax_out.items()
         if k.startswith("init/")}), "cpu")


def _trainer(jax_out, mode, **kw):
    model, data = _setup()
    return ElasticTrainer(model, make_optimizer("adamw"), data,
                          global_batch=GLOBAL_BATCH, base_lr=LR, mode=mode,
                          device="cpu", params=_init_params(jax_out), **kw)


@pytest.mark.parametrize("mode", list(MODES))
def test_trainer_matches_reference_loss_for_loss(jax_out, mode):
    tr = _trainer(jax_out, mode)
    for workers, steps, leave in PLANS:
        res = tr.run_slot(SlotPlan(workers, steps, leave=leave))
        assert res["steps"] == steps and res["workers"] == workers
    want = jax_out[f"{mode}/losses"]
    assert len(tr.losses) == len(want) == 8
    np.testing.assert_allclose(tr.losses, want, rtol=0, atol=LOSS_ATOL)
    assert tr.losses[-1] < tr.losses[0]
    state = {"params": next(iter(tr.params.values())),
             "opt": next(iter(tr.opt_state.values()))}
    leaves = dict(_flatten(state))
    assert sorted(leaves) == sorted(k[len(f"{mode}/final/"):] for k in jax_out
                                    if k.startswith(f"{mode}/final/"))
    assert int(leaves.pop("opt/step")) == int(jax_out[f"{mode}/final/opt/step"]) == 8
    for path, v in leaves.items():
        ref = jax_out[f"{mode}/final/{path}"].astype(np.float64)
        gap = np.linalg.norm(v.numpy().astype(np.float64) - ref) / np.linalg.norm(ref)
        assert gap < MODES[mode], (path, gap)
    re_rings, compiles, reshards, step = jax_out[f"{mode}/counts"]
    assert tr.re_ring_events == re_rings == 1
    assert tr.group.compile_count == compiles == 2   # w=4 and w=2, reused
    assert tr.resharding_events == reshards and tr.step == step


def test_ring_sizes_clamp_as_in_reference():
    for gb in (1, 6, 8, 12):
        for req in range(-1, 11):
            for n in (1, 3, 8):
                assert largest_feasible_ring(req, global_batch=gb, n_devices=n) \
                    == jax_largest_feasible_ring(req, global_batch=gb, n_devices=n)
    model, _ = _setup()
    group = RingWorkerGroup(model, make_optimizer("adamw"), global_batch=8,
                            lr=LR, mode="compressed-fused", devices=["cpu"] * 8)
    assert [group.form(w) for w in (3, 8, 5, 4, 2, 4)] == [2, 8, 4, 4, 2, 4]
    assert group.compile_count == 3                  # 2, 8, 4
    assert group.cache_key(4) == (4, "compressed-fused", None, "int8")
    assert set(RingWorkerGroup.STATIC_CLOSURE_ATTRS) <= set(vars(group))
    with pytest.raises(NotImplementedError):
        RingWorkerGroup(model, make_optimizer("adamw"), global_batch=8, lr=LR,
                        mode="bidir", devices=["cpu"])


def test_checkpoint_round_trip(jax_out, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    tr = _trainer(jax_out, "compressed-fused", checkpoint_dir=ckpt)
    tr.run_slot(SlotPlan(4, 2))
    # the reference's loader reads the port's files: same key layout
    jparams, jopt, jstep, _ = jax_load_checkpoint(ckpt)
    assert jstep == 2 and int(jopt["step"]) == 2
    saved = dict(_flatten(next(iter(tr.params.values()))))
    assert sorted(dict(_flatten(jparams))) == sorted(saved)
    restored = _trainer(jax_out, "compressed-fused", checkpoint_dir=ckpt)
    assert restored.restore() and restored.step == 2 and restored.restores == 1
    for path, v in _flatten(next(iter(restored.params.values()))):
        assert torch.equal(v, saved[path]), path
    # a restored trainer continues exactly as the one that saved
    tr.run_slot(SlotPlan(2, 1))
    restored.run_slot(SlotPlan(2, 1))
    assert restored.losses == tr.losses[-1:]
    assert not _trainer(jax_out, "ring").restore()  # no checkpoint_dir


def test_train_cli_on_cpu(capsys):
    assert inspect.signature(ElasticTrainer).parameters["device"].default == "cuda"
    train_cli.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "2",
                    "--dp", "2", "--seq", "16", "--mode", "compressed-fused",
                    "--log-every", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary["final_step"] == 2 and summary["mode"] == "compressed-fused"
    assert np.isfinite(summary["final_loss"]) and len(lines) == 3


def _jax_reference(out):
    import jax

    from repro.configs import get_arch as jax_get_arch
    from repro.data.pipeline import SyntheticTokens as JaxTokens
    from repro.models.model import build_model as jax_build_model
    from repro.training.elastic import ElasticTrainer as JaxTrainer
    from repro.training.elastic import SlotPlan as JaxPlan
    from repro.training.optimizer import make_optimizer as jax_make_optimizer

    cfg = jax_get_arch(ARCH).reduced()
    model = jax_build_model(cfg)
    data = JaxTokens(cfg.vocab, SEQ, GLOBAL_BATCH, seed=0)
    res = {}
    for mode in MODES:
        tr = JaxTrainer(model, jax_make_optimizer("adamw"), data,
                        global_batch=GLOBAL_BATCH, base_lr=LR, mode=mode)
        for path, v in _flatten(jax.device_get(tr.params)):
            res[f"init/{path}"] = np.asarray(v)
        for workers, steps, leave in PLANS:
            tr.run_slot(JaxPlan(workers, steps, leave=leave))
        res[f"{mode}/losses"] = np.array(tr.losses)
        state = {"params": tr.params, "opt": tr.opt_state}
        for path, v in _flatten(jax.device_get(state)):
            res[f"{mode}/final/{path}"] = np.asarray(v)
        res[f"{mode}/counts"] = np.array([tr.re_ring_events,
                                          tr.group.compile_count,
                                          tr.resharding_events, tr.step])
    np.savez(out, **res)


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
