"""The port's RWKV6 LM (``repro_torch.models.rwkv.Rwkv6LM``) held against
the JAX package's on reduced rwkv6-7b in f32, with the reference's own
weights carried across by ``params_from_reference``: the config and its
parameter count, the spec tree, logits and loss, every gradient leaf
against ``jax.value_and_grad(model.loss)`` (remat off and on), the model
trained through the WKV6 autograd function (the path a CUDA tensor takes,
here on its plain versions), one AdamW step, and the port's
``ElasticTrainer`` in ``ring`` mode across a w=4 -> 2 resize and a mid-slot
re-ring, loss for loss against the reference trainer, which runs in a
subprocess (this file run as a script, on 8 host devices).

Tolerances: loss rtol/atol 1e-5; logits rtol/atol 1e-5 (measured 2.2e-5 of
an absolute 4.6 on its largest, so held to ``1e-5 * max|logits|``); grads
per leaf to a relative norm of 1e-5 (measured at most 2.7e-6, on
``time_mix/bonus_u``, whose gradient reaches 1e3); AdamW atol 1e-6; trainer
losses atol 1e-5, as ``tests/test_torch_training.py`` holds the ``ring``
mode, and the final parameters and AdamW moments per leaf to a relative
norm of 2e-4 (measured at most 6.2e-5, on ``opt/m/time_mix/mu_v``; the
dense ``ring`` mode's limit is 1e-5). The gap is spread over most elements
of every leaf, not a few: the reduced model's ``bonus_u`` gradient reaches
1e3 (its second moment 3e4), and eight AdamW steps carry the f32 ordering
differences of each step's gradients (at most 2.7e-6 of a leaf's norm) into
every weight.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.models.model import build_model as jax_build_model
from repro.training.optimizer import adamw_init as jax_adamw_init
from repro.training.optimizer import adamw_update as jax_adamw_update
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.kernels import rwkv6_wkv as W
from repro_torch.models import rwkv
from repro_torch.models.model import build_model
from repro_torch.models.module import _flatten, _unflatten, params_from_reference
from repro_torch.training.elastic import ElasticTrainer, SlotPlan
from repro_torch.training.optimizer import adamw_init, adamw_update, make_optimizer

ARCH = "rwkv6-7b"
FULL_PARAMS = 7_534_546_944
SEQ, GLOBAL_BATCH, LR = 40, 8, 1e-3   # 40 tokens: a second, ragged chunk
PLANS = [(4, 2, None), (2, 2, None), (4, 4, (2, 2))]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this file's torch ops on one thread: its ops are small, and when
    test workers share the cores, torch's own thread pool makes them many
    times slower than one thread does."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_arch(ARCH).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    batch = JaxTokens(jcfg.vocab, SEQ, 4, seed=3).batch(0)
    model = build_model(get_arch(ARCH).reduced())
    params = params_from_reference(np_tree(jparams), "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jmodel, jparams, batch, model, params, tbatch


def test_config_and_param_count_match_reference():
    for reduced in (False, True):
        ref, cfg = jax_get_arch(ARCH), get_arch(ARCH)
        if reduced:
            ref, cfg = ref.reduced(), cfg.reduced()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert cfg.n_params() == ref.n_params()
    cfg = get_arch(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_model // cfg.rwkv_head_dim,
            cfg.rwkv_head_dim, cfg.d_ff, cfg.vocab) == (32, 4096, 64, 64,
                                                        14336, 65536)
    assert cfg.n_params() == FULL_PARAMS
    # chip_smoke.py's full-width path: the depth cut to 4 layers
    assert dataclasses.replace(cfg, n_layers=4).n_params() == 1_411_584_000
    assert cfg.remat and not cfg.reduced().remat


def test_param_specs_match_reference(setup):
    jmodel, _, _, model, _, _ = setup
    want = dict(_flatten(jmodel.param_specs()))
    got = dict(_flatten(model.param_specs()))
    assert list(got) == list(want) and len(got) == 25
    for path, spec in want.items():
        assert got[path].shape == spec.shape and got[path].axes == spec.axes
        assert (got[path].init, got[path].scale) == (spec.init, spec.scale)


def test_forward_and_loss_match_reference(setup):
    jmodel, jparams, batch, model, params, tbatch = setup
    jlogits, _ = jmodel.forward(jparams, batch)
    logits, _ = model.forward(params, tbatch)
    jlogits = np.asarray(jlogits)
    assert logits.shape == jlogits.shape
    assert np.abs(logits.numpy() - jlogits).max() <= 1e-5 * np.abs(jlogits).max()
    np.testing.assert_allclose(float(model.loss(params, tbatch)),
                               float(jmodel.loss(jparams, batch)),
                               rtol=1e-5, atol=1e-5)


def grads_of(model, params, tbatch):
    leaves = {p: v.clone().requires_grad_(True) for p, v in _flatten(params)}
    loss = model.loss(_unflatten(leaves), tbatch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def assert_grads_match(loss, grads, jloss, jgrads):
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5, atol=1e-5)
    want = dict(_flatten(np_tree(jgrads)))
    assert sorted(grads) == sorted(want)
    for path, g in grads.items():
        assert g.shape == want[path].shape, path
        assert rel_norm(g.numpy(), want[path]) <= 1e-5, path


@pytest.mark.parametrize("remat", [False, True])
def test_grads_match_reference(setup, remat):
    jmodel, jparams, batch, model, params, tbatch = setup
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(jparams, batch)
    if remat:
        model = build_model(dataclasses.replace(model.cfg, remat=True))
    assert_grads_match(*grads_of(model, params, tbatch), jloss, jgrads)


@pytest.mark.parametrize("remat", [False, True])
def test_model_trains_through_the_wkv6_function(setup, monkeypatch, remat):
    """With the recurrence through :func:`wkv6` (plain versions on the CPU),
    the loss and gradients are the reference's; with remat the forward runs
    again inside backward, so the function's forward is called twice a
    layer."""
    jmodel, jparams, batch, model, params, tbatch = setup
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(jparams, batch)
    calls = []

    def through_function(r, k, v, logw, u, initial_state=None):
        calls.append(r.shape)
        return W.wkv6(r, k, v, logw, u, initial_state)

    monkeypatch.setattr(rwkv, "wkv6_chunked", through_function)
    model = build_model(dataclasses.replace(model.cfg, remat=remat))
    assert_grads_match(*grads_of(model, params, tbatch), jloss, jgrads)
    n_layers = model.cfg.n_layers
    assert len(calls) == (2 if remat else 1) * n_layers


def test_adamw_step_matches_reference(setup):
    _, jparams, _, _, params, _ = setup
    rng = np.random.default_rng(5)
    jgrads = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)),
        jparams)
    grads = params_from_reference(np_tree(jgrads), "cpu")
    jp, jstate = jax_adamw_update(jgrads, jax_adamw_init(jparams), jparams,
                                  lr=1e-3)
    p, state = adamw_update(grads, adamw_init(params), params, lr=1e-3)
    for got, want in ((p, jp), (state["m"], jstate["m"]), (state["v"], jstate["v"])):
        got, want = dict(_flatten(got)), dict(_flatten(np_tree(want)))
        assert sorted(got) == sorted(want)
        for path in want:
            np.testing.assert_allclose(got[path].numpy(), want[path], rtol=0,
                                       atol=1e-6, err_msg=path)


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    """The reference trainer's results, from a subprocess on 8 host
    devices."""
    out = tmp_path_factory.mktemp("rwkv_ref") / "out.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as f:
        return dict(f)


def test_trainer_matches_reference_loss_for_loss(jax_out):
    cfg = get_arch(ARCH).reduced()
    init = params_from_reference(_unflatten(
        {k[len("init/"):]: v for k, v in jax_out.items()
         if k.startswith("init/")}), "cpu")
    tr = ElasticTrainer(build_model(cfg), make_optimizer("adamw"),
                        SyntheticTokens(cfg.vocab, SEQ, GLOBAL_BATCH, seed=0),
                        global_batch=GLOBAL_BATCH, base_lr=LR, mode="ring",
                        device="cpu", params=init)
    for workers, steps, leave in PLANS:
        tr.run_slot(SlotPlan(workers, steps, leave=leave))
    want = jax_out["losses"]
    assert len(tr.losses) == len(want) == 8
    np.testing.assert_allclose(tr.losses, want, rtol=0, atol=1e-5)
    state = {"params": next(iter(tr.params.values())),
             "opt": next(iter(tr.opt_state.values()))}
    leaves = dict(_flatten(state))
    assert int(leaves.pop("opt/step")) == int(jax_out["final/opt/step"]) == 8
    assert sorted(leaves) == sorted(k[len("final/"):] for k in jax_out
                                    if k.startswith("final/") and
                                    k != "final/opt/step")
    for path, v in leaves.items():
        assert rel_norm(v.numpy(), jax_out[f"final/{path}"]) < 2e-4, path
    re_rings, compiles, reshards, step = jax_out["counts"]
    assert tr.re_ring_events == re_rings == 1
    assert tr.group.compile_count == compiles == 2
    assert tr.resharding_events == reshards and tr.step == step


# -- one AdamW step, and the held-out batch, against the reference ----------
#
# The same weights (the reference's init) and batches through both sides:
# the loss on the training batch and every gradient leaf, then one AdamW
# step at chip_smoke.py's phase-6 rate, then the loss on the training batch
# and on the loop's held-out batch before and after it, and the softmax mass
# that the held-out positions give to the training batch's tokens. At
# reduced width below; at full width (d_model 4096, vocab 65536, depth cut)
# by running this file as a script:
#
#     PYTHONPATH=src python tests/test_torch_rwkv.py --width-witness DIR
#
# (two subprocesses, the reference's then the port's, each about 10 GiB of
# host memory at 1 layer; leaves pass through DIR as .npy files).

WITNESS_LR = 3e-4
HELDOUT_STEP = 10 ** 6     # launch/schedule_and_train.py's held-out batch
WITNESS_KEYS = ("loss", "heldout", "seen_mass", "loss_after",
                "heldout_after", "seen_mass_after")


def seen_mass(logits, train_labels) -> float:
    """Mean over positions of the softmax mass on the tokens that
    ``train_labels`` holds."""
    logits = np.asarray(logits, np.float32)
    logits = logits - logits.max(axis=-1, keepdims=True)
    probs = np.exp(logits)
    seen = np.zeros(logits.shape[-1], bool)
    seen[np.unique(train_labels)] = True
    return float((probs[..., seen].sum(-1) / probs.sum(-1)).mean())


def witness_jax(cfg, seq, batch):
    """The reference's side: ``(numbers, init leaves, grad leaves)``."""
    jmodel = jax_build_model(cfg)
    params = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    data = JaxTokens(cfg.vocab, seq, batch, seed=0)
    train, held = data.batch(0), data.batch(HELDOUT_STEP)
    init = dict(_flatten(np_tree(params)))
    loss_fn = jax.jit(jmodel.loss)
    loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(params, train)
    grads = dict(_flatten(np_tree(grads)))
    forward = jax.jit(lambda p, b: jmodel.forward(p, b)[0])
    out = {"loss": float(loss), "heldout": float(loss_fn(params, held)),
           "seen_mass": seen_mass(forward(params, held), train["labels"])}
    # leaf by leaf, so that no second copy of the model is held at once
    flat = dict(_flatten(params))
    del params
    for path, g in grads.items():
        new, _ = jax_adamw_update({"x": jnp.asarray(g)},
                                  jax_adamw_init({"x": flat[path]}),
                                  {"x": flat[path]}, lr=WITNESS_LR)
        flat[path] = new["x"]
    params = _unflatten(flat)
    out.update(loss_after=float(loss_fn(params, train)),
               heldout_after=float(loss_fn(params, held)),
               seen_mass_after=seen_mass(forward(params, held), train["labels"]))
    return out, init, grads


def witness_torch(cfg, seq, batch, init):
    """The port's side from the reference's ``init`` leaves: ``(numbers,
    grad leaves)``."""
    model = build_model(cfg)
    params = params_from_reference(_unflatten(init), "cpu")
    data = SyntheticTokens(cfg.vocab, seq, batch, seed=0)
    train, held = ({k: torch.from_numpy(v) for k, v in data.batch(i).items()}
                   for i in (0, HELDOUT_STEP))
    loss, grads = grads_of(model, params, train)
    with torch.no_grad():
        out = {"loss": loss, "heldout": float(model.loss(params, held)),
               "seen_mass": seen_mass(model.forward(params, held)[0],
                                      train["labels"].numpy())}
        flat = dict(_flatten(params))
        del params
        for path, g in grads.items():
            new, _ = adamw_update({"x": g}, adamw_init({"x": flat[path]}),
                                  {"x": flat[path]}, lr=WITNESS_LR)
            flat[path] = new["x"]
        params = _unflatten(flat)
        out.update(loss_after=float(model.loss(params, train)),
                   heldout_after=float(model.loss(params, held)),
                   seen_mass_after=seen_mass(model.forward(params, held)[0],
                                             train["labels"].numpy()))
    return out, {p: g.numpy() for p, g in grads.items()}


def witness_gaps(got, want, grads, jgrads):
    """Each number's gap and each gradient leaf's relative norm."""
    gaps = {k: abs(got[k] - want[k]) for k in WITNESS_KEYS}
    norms = {p: rel_norm(grads[p], jgrads[p]) for p in jgrads}
    return gaps, norms


def test_adamw_step_and_heldout_match_reference():
    """The witness at reduced width: every number within 1e-5 (the loss
    limit above; the seen mass is a probability), every gradient leaf
    within a relative norm of 1e-5 (measured at most 5.4e-6)."""
    cfg = jax_get_arch(ARCH).reduced()
    want, init, jgrads = witness_jax(cfg, SEQ, 4)
    got, grads = witness_torch(get_arch(ARCH).reduced(), SEQ, 4, init)
    gaps, norms = witness_gaps(got, want, grads, jgrads)
    assert sorted(grads) == sorted(jgrads)
    assert all(g <= 1e-5 * max(1.0, abs(want[k])) for k, g in gaps.items()), gaps
    assert max(norms.values()) <= 1e-5, norms


def _width_witness(root, layers=1, seq=1024, batch=2):
    """Full-width rwkv6-7b cut to ``layers``: the reference's side, then the
    port's, each in a subprocess of its own; prints and writes
    ``witness.json`` in ``root``, then holds them to the reduced test's
    limits."""
    import json
    os.makedirs(root, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    for side in ("--witness-jax", "--witness-torch"):
        subprocess.run([sys.executable, os.path.abspath(__file__), side, root,
                        str(layers), str(seq), str(batch)], env=env, check=True)
    with open(os.path.join(root, "jax.json")) as f:
        want = json.load(f)
    with open(os.path.join(root, "torch.json")) as f:
        got = json.load(f)
    paths = want.pop("paths")
    grads = {p: np.load(os.path.join(root, f"grad_torch_{i}.npy"), mmap_mode="r")
             for i, p in enumerate(paths)}
    jgrads = {p: np.load(os.path.join(root, f"grad_jax_{i}.npy"), mmap_mode="r")
              for i, p in enumerate(paths)}
    gaps, norms = witness_gaps(got, want, grads, jgrads)
    report = {"layers": layers, "seq": seq, "batch": batch, "lr": WITNESS_LR,
              "reference": want, "port": got, "gaps": gaps,
              "grad_rel_norms": norms,
              "grad_norms": {p: float(np.linalg.norm(jgrads[p])) for p in paths}}
    with open(os.path.join(root, "witness.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    assert all(g <= 1e-5 * max(1.0, abs(want[k])) for k, g in gaps.items()), gaps
    assert max(norms.values()) <= 1e-5, norms


def _witness_side(side, root, layers, seq, batch):
    import json
    jcfg = dataclasses.replace(jax_get_arch(ARCH), n_layers=int(layers))
    seq, batch = int(seq), int(batch)
    if side == "--witness-jax":
        out, init, grads = witness_jax(jcfg, seq, batch)
        paths = list(init)
        for i, p in enumerate(paths):
            np.save(os.path.join(root, f"init_{i}.npy"), init[p])
            np.save(os.path.join(root, f"grad_jax_{i}.npy"), grads[p])
        out["paths"] = paths
        name = "jax.json"
    else:
        with open(os.path.join(root, "jax.json")) as f:
            paths = json.load(f)["paths"]
        init = {p: np.load(os.path.join(root, f"init_{i}.npy"), mmap_mode="r")
                for i, p in enumerate(paths)}
        cfg = dataclasses.replace(get_arch(ARCH), n_layers=int(layers))
        out, grads = witness_torch(cfg, seq, batch, init)
        for i, p in enumerate(paths):
            np.save(os.path.join(root, f"grad_torch_{i}.npy"), grads[p])
        name = "torch.json"
    with open(os.path.join(root, name), "w") as f:
        json.dump(out, f)


def _jax_reference(out):
    from repro.training.elastic import ElasticTrainer as JaxTrainer
    from repro.training.elastic import SlotPlan as JaxPlan
    from repro.training.optimizer import make_optimizer as jax_make_optimizer

    cfg = jax_get_arch(ARCH).reduced()
    data = JaxTokens(cfg.vocab, SEQ, GLOBAL_BATCH, seed=0)
    tr = JaxTrainer(jax_build_model(cfg), jax_make_optimizer("adamw"), data,
                    global_batch=GLOBAL_BATCH, base_lr=LR, mode="ring")
    res = {f"init/{p}": np.asarray(v)
           for p, v in _flatten(jax.device_get(tr.params))}
    for workers, steps, leave in PLANS:
        tr.run_slot(JaxPlan(workers, steps, leave=leave))
    res["losses"] = np.array(tr.losses)
    state = {"params": tr.params, "opt": tr.opt_state}
    res.update({f"final/{p}": np.asarray(v)
                for p, v in _flatten(jax.device_get(state))})
    res["counts"] = np.array([tr.re_ring_events, tr.group.compile_count,
                              tr.resharding_events, tr.step])
    np.savez(out, **res)


if __name__ == "__main__":
    if sys.argv[1] == "--width-witness":
        _width_witness(sys.argv[2], *map(int, sys.argv[3:]))
    elif sys.argv[1] in ("--witness-jax", "--witness-torch"):
        _witness_side(*sys.argv[1:])
    else:
        _jax_reference(sys.argv[1])
