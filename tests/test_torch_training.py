"""The slice as a whole: the port's ``ElasticTrainer`` held loss for loss
against the JAX package's, on reduced qwen3-0.6b with AdamW, in every ring
step mode of the reference (``STEP_MODES``), across a slot-boundary resize
w=4 -> 2 and a mid-slot re-ring.

The JAX trainers run in two subprocesses side by side (this file run as a
script, each on 8 host devices, the reference's layout); the port runs its
ranks on the CPU and starts from the reference trainer's initial
parameters.

Losses agree to atol 1e-5 in every mode (measured below). AdamW's update does not change when every gradient is scaled
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
  * ``bidir``: 1e-5 (measured 1.8e-6), as ``ring``: both half-rings keep
    the reference's hop order.
  * ``psum``: 1e-5 (measured 1.7e-6): a sum in rank order against XLA's
    all-reduce, both f32.
  * ``compressed``: 5e-3 (measured 1.3e-3, on v), as ``compressed-fused``:
    one int8 step of a whole-chunk scale now and then.
  * ``compressed-fused-overlap``: 1e-2 (measured 2.1e-3, on m), as
    ``compressed-fused``, over the reference's buckets, whose blocks span
    several leaves.
  * ``bf16-fused``: 1e-3 (measured 2.2e-4, on v): the bf16 ring is
    bit-identical to the reference's, but an ulp of gradient now and then
    moves a bf16 rounding, one bf16 step (2^-8 relative).
  * ``fp8-fused``: 1e-2 (measured 1.7e-3, on m): as ``compressed-fused``,
    with e4m3's steps (up to 2^-3 relative).

Losses agree within 1e-5 in every mode (measured at most 4.3e-6, in
``fp8-fused``; 1.4e-6 in the overlap mode; one ulp, 9.5e-7, elsewhere).
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
from repro.training.elastic import RingWorkerGroup as JaxRingWorkerGroup
from repro.training.elastic import largest_feasible_ring as jax_largest_feasible_ring
from repro.training.train_step import RING_STEP_MODES as JAX_RING_STEP_MODES
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.dist.collectives import LocalRing
from repro_torch.dist.compression import ef_compressed_all_reduce
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
from repro_torch.training.train_step import (
    RING_STEP_MODES,
    init_ef_state,
    make_ring_train_step,
    rank_grads,
    shard_batch,
)

ARCH = "qwen3-0.6b"
SEQ, GLOBAL_BATCH, LR = 16, 8, 1e-3
PLANS = [(4, 2, None), (2, 2, None), (4, 4, (2, 2))]
# mode -> limit on each final leaf's relative gap to the reference
MODES = {"ring": 1e-5, "bidir": 1e-5, "psum": 1e-5, "compressed": 5e-3,
         "compressed-fused": 5e-3, "compressed-fused-overlap": 1e-2,
         "bf16-fused": 1e-3, "fp8-fused": 1e-2}
LOSS_ATOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this file's torch ops on one thread. The reduced model's ops are
    small, and when test workers share the cores, torch's own thread pool
    makes each trainer run tens of times slower than one thread does. The
    results are the same on these inputs (measured: identical gaps)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    """The reference trainers' results, the modes split over two
    subprocesses that run side by side."""
    tmp = tmp_path_factory.mktemp("train_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    modes = list(MODES)
    groups = [modes[0::2], modes[1::2]]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(tmp / f"out{k}.npz"),
         ",".join(group)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for k, group in enumerate(groups)]
    res = {}
    for k, proc in enumerate(procs):
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        with np.load(tmp / f"out{k}.npz") as f:
            res.update(f)
    return res


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
    with pytest.raises(ValueError):
        RingWorkerGroup(model, make_optimizer("adamw"), global_batch=8, lr=LR,
                        mode="int4-fused", devices=["cpu"])


def test_every_mode_keys_its_cache_as_the_reference():
    assert RING_STEP_MODES == JAX_RING_STEP_MODES and len(RING_STEP_MODES) == 8
    model, _ = _setup()
    for mode in RING_STEP_MODES:
        for n_buckets in (None, 2):
            group = RingWorkerGroup(model, make_optimizer("adamw"),
                                    global_batch=8, lr=LR, mode=mode,
                                    n_buckets=n_buckets, devices=["cpu"] * 8)
            ref = JaxRingWorkerGroup(None, None, global_batch=8, lr=LR,
                                     mode=mode, n_buckets=n_buckets)
            assert group.cache_key(4) == ref.cache_key(4), mode
            assert group.form(4) == 4 and group.compile_count == 1


def test_step_rejects_what_the_reference_rejects():
    model, _ = _setup()
    opt, ring = make_optimizer("adamw"), LocalRing(["cpu"] * 2)
    with pytest.raises(ValueError):
        make_ring_train_step(model, opt, ring, mode="int4-fused")
    for mode in ("bf16-fused", "fp8-fused", "compressed-fused-overlap"):
        with pytest.raises(ValueError):
            make_ring_train_step(model, opt, ring, mode=mode, error_feedback=True)
    with pytest.raises(ValueError):
        make_ring_train_step(model, opt, ring, mode="compressed-fused", n_buckets=2)
    for mode in ("ring", "compressed", "compressed-fused"):
        make_ring_train_step(model, opt, ring, mode=mode, error_feedback=True)
    make_ring_train_step(model, opt, ring, mode="compressed-fused-overlap",
                         n_buckets=2)


@pytest.mark.parametrize("fused", [False, True])
def test_error_feedback_step_carries_a_residual(jax_out, fused):
    """The per-rank residual state: zero in, the rank's quantization error
    out, and the step's reduced gradient the EF all-reduce's."""
    model, data = _setup()
    params = _init_params(jax_out)
    opt = make_optimizer("adamw")
    ring = LocalRing(["cpu"] * 2)
    mode = "compressed-fused" if fused else "compressed"
    step = make_ring_train_step(model, opt, ring, lr=LR, mode=mode,
                                error_feedback=True)
    shards = shard_batch({k: torch.as_tensor(v) for k, v in data.batch(0).items()},
                         ring.devices)
    ef0 = init_ef_state(params, ring.devices)
    home = ring.devices[0]
    _, _, metrics, ef1 = step({home: params}, {home: opt.init(params)}, shards, ef0)
    assert np.isfinite(float(metrics["loss"]))
    assert len(ef1) == 2 and sorted(ef1[0]) == sorted(ef0[0])
    _, grads = rank_grads(model, {home: params}, shards, ring.devices)
    for path in ef0[0]:
        _, want = ef_compressed_all_reduce([g[path] for g in grads],
                                           [e[path] for e in ef0],
                                           LocalRing(["cpu"] * 2), fused=fused)
        for r in range(2):
            assert torch.equal(ef1[r][path], want[r]), path
    # without ef_state the same step reduces plainly and returns three values
    assert len(step({home: params}, {home: opt.init(params)}, shards)) == 3


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
    modes = {a.dest: a.choices for a in train_cli.build_parser()._actions}["mode"]
    assert tuple(modes) == JAX_RING_STEP_MODES
    train_cli.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "2",
                    "--dp", "2", "--seq", "16", "--mode", "compressed-fused",
                    "--log-every", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary["final_step"] == 2 and summary["mode"] == "compressed-fused"
    assert np.isfinite(summary["final_loss"]) and len(lines) == 3


def _jax_reference(out, modes):
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
    for mode in modes:
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
    _jax_reference(sys.argv[1], sys.argv[2].split(","))
