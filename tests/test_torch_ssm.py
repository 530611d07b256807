"""The port's Mamba2 and Zamba2 LMs (``repro_torch.models.ssm``) held
against the JAX package's on reduced zamba2-1.2b in f32 (``Zamba2LM``, and
``Mamba2LM`` as ``family="ssm"`` of the same config), with the reference's
own weights carried across by ``params_from_reference``: the config and
its parameter count, the spec trees, the causal conv, logits and loss,
every gradient leaf against ``jax.value_and_grad(model.loss)`` (remat off
and on), the models trained through the SSD autograd function (the path a
CUDA tensor takes, here on its plain versions), one AdamW step, and the
port's ``ElasticTrainer`` in ``ring`` mode across a w=4 -> 2 resize and a
mid-slot re-ring, loss for loss against the reference trainer, which runs
in a subprocess (this file run as a script, on 8 host devices).

The reference's gradient runs its SSD through its sequential oracle
``repro.kernels.ref.ssd_reference`` (patched into ``repro.models.ssm`` in
this process and the subprocess only): the reference's ``ssd_chunked``
masks ``exp(g_t - g_j)`` after the ``exp``, and at these weights g falls
more than 88 within a chunk of 32, so above the diagonal the ``exp`` is
``inf`` and its gradient ``0 * inf`` is NaN in every leaf. Its forward is
unaffected, and is held as it is.

Tolerances. ``Mamba2LM``: loss rtol/atol 1e-5, logits ``1e-4 * max``
(measured 1.2e-5), every gradient leaf to a relative norm of 1e-4
(measured 1.1e-5). ``Zamba2LM`` is far more sensitive to the order of f32
sums: its shared attention has no qk-norm and reaches scores of 159, and
the residual stream grows to 90, so every reordered sum is amplified. The
reference against itself, with only its SSD reordered (``ssd_chunked``
against ``ssd_reference``), differs by 3.6e-4 of the largest logit; the
port against itself, its SSD at chunk 64 instead of 32, by 2.3e-4 of the
largest logit and a gradient relative norm of 1.7e-3 (``mamba/conv_w``).
The port against the reference measures 4.2e-4 and 3.4e-3
(``mamba/conv_b``), and is held to ``2e-3 * max`` for the logits and a
relative norm of 2e-2 per gradient leaf. The loss agrees to its last bit
(limit rtol/atol 1e-5). AdamW atol 1e-6. The trainer: ``Mamba2LM``'s
losses atol 1e-5 (measured at most 1.9e-6), its final parameters and AdamW
moments per leaf to a relative norm of 1e-3 (measured at most 2.5e-4, on
``opt/m/mamba/D``); ``Zamba2LM``'s training is chaotic at these weights:
its first loss is held to 1e-5, and every loss to the largest gap between
two runs of the reference trainer that differ only in the order of its
SSD's sums (the sequential oracle, and its ``ssd_chunked`` at chunks 2, 4
and 8: six pairs, gaps 0.057 to 0.182; the port's largest gap 0.093).
Before that chaos, its first step at w=4 and its step after the re-ring,
each from the reference's state, are held leaf by leaf: every AdamW moment
to 2e-2, and every parameter likewise, apart from the elements where the
two sides' first moments differ in sign (see
``test_hybrid_trainer_steps_match_reference``).
"""

import dataclasses
import functools
import itertools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm as jax_ssm
from repro.configs import get_arch as jax_get_arch
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.kernels.ref import ssd_reference
from repro.models.model import build_model as jax_build_model
from repro.training.optimizer import adamw_init as jax_adamw_init
from repro.training.optimizer import adamw_update as jax_adamw_update
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.kernels import ssd_scan as S
from repro_torch.models import ssm
from repro_torch.models.model import build_model
from repro_torch.models.module import _flatten, _unflatten, params_from_reference
from repro_torch.training.elastic import ElasticTrainer, SlotPlan
from repro_torch.training.optimizer import adamw_init, adamw_update, make_optimizer

ARCH = "zamba2-1.2b"
FULL_PARAMS = 1_170_473_856
SEQ, GLOBAL_BATCH, LR = 40, 8, 1e-3   # 40 tokens: a second, ragged chunk
PLANS = [(4, 2, None), (2, 2, None), (4, 4, (2, 2))]
# one step at w=4, the re-ring, one step at w=2: each held leaf by leaf
FIRST_STEPS_PLAN = (4, 2, (1, 2))
# the chunks of the reference's ssd_chunked that reorder its SSD's sums
REORDER_CHUNKS = (2, 4, 8)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# family -> (logits limit as a share of the largest logit, gradient leaf
# relative norm limit); see the module docstring
LIMITS = {"hybrid": (2e-3, 2e-2), "ssm": (1e-4, 1e-4)}
FAMILIES = ("hybrid", "ssm")
JAX_SSD_CHUNKED = jax_ssm.ssd_chunked


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this file's torch ops on one thread: its ops are small, and when
    test workers share the cores, torch's own thread pool makes them many
    times slower than one thread does."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sequential_ssd(x, dt, A, Bm, Cm, chunk, initial_state=None):
    """The reference's ``ssd_chunked`` through its sequential oracle."""
    return ssd_reference(x, dt, A, Bm, Cm, initial_state=initial_state)


def short_chunked_ssd(x, dt, A, Bm, Cm, chunk, initial_state=None, *, short):
    """The reference's own ``ssd_chunked`` at chunks of ``short`` (one of
    REORDER_CHUNKS), where g spans too little for its unmasked ``exp`` to
    overflow: the same function as ``sequential_ssd``, its sums in another
    order."""
    return JAX_SSD_CHUNKED(x, dt, A, Bm, Cm, short, initial_state=initial_state)


def recorded_states(trainer, snapshot):
    """Wrap ``trainer.group.step`` (the same on both sides) to append
    ``snapshot(params, opt_state)`` of the state after every step to the
    list returned."""
    step, states = trainer.group.step, []

    def recording(params, opt_state, batch):
        out = step(params, opt_state, batch)
        states.append(snapshot(out[0], out[1]))
        return out

    trainer.group.step = recording
    return states


@pytest.fixture
def jax_sequential_ssd(monkeypatch):
    monkeypatch.setattr(jax_ssm, "ssd_chunked", sequential_ssd)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def configs(family, **changes):
    """The reduced config of ``family`` on both sides."""
    return (dataclasses.replace(jax_get_arch(ARCH).reduced(), family=family,
                                **changes),
            dataclasses.replace(get_arch(ARCH).reduced(), family=family,
                                **changes))


@pytest.fixture(scope="module", params=FAMILIES)
def setup(request):
    jcfg, cfg = configs(request.param)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    batch = JaxTokens(jcfg.vocab, SEQ, 4, seed=3).batch(0)
    params = params_from_reference(np_tree(jparams), "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jmodel, jparams, batch, build_model(cfg), params, tbatch


def test_config_and_param_count_match_reference():
    for reduced in (False, True):
        ref, cfg = jax_get_arch(ARCH), get_arch(ARCH)
        if reduced:
            ref, cfg = ref.reduced(), cfg.reduced()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert cfg.n_params() == ref.n_params()
        for family in FAMILIES:
            assert (dataclasses.replace(cfg, family=family).n_params()
                    == dataclasses.replace(ref, family=family).n_params())
    cfg = get_arch(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.n_ssm_heads,
            cfg.ssm_head_dim, cfg.ssm_state, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.ssm_chunk,
            cfg.attn_every) == (38, 2048, 4096, 64, 64, 64, 32, 32, 64, 8192,
                                32000, 256, 6)
    assert cfg.n_params() == FULL_PARAMS
    assert build_model(cfg)._layout() == (6, 2)
    assert cfg.remat and not cfg.reduced().remat


@pytest.mark.parametrize("family", FAMILIES)
def test_param_specs_match_reference(family):
    jcfg, cfg = configs(family)
    want = dict(_flatten(jax_build_model(jcfg).param_specs()))
    got = dict(_flatten(build_model(cfg).param_specs()))
    assert list(got) == list(want)
    assert len(got) == {"hybrid": 21, "ssm": 12}[family]
    for path, spec in want.items():
        assert got[path].shape == spec.shape and got[path].axes == spec.axes
        assert (got[path].init, got[path].scale) == (spec.init, spec.scale)
    if family == "hybrid":     # the shared block's leaves are not stacked
        assert got["shared_attn/wq"].shape == (128, 4, 32)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(11)
    xbc, w, b, state = (rng.standard_normal(shape).astype(np.float32) for shape in
                        ((2, 9, 24), (ssm.CONV_K, 24), (24,), (2, ssm.CONV_K - 1, 24)))
    got, got_state = ssm._causal_conv(
        torch.from_numpy(xbc), torch.from_numpy(w), torch.from_numpy(b),
        state=torch.from_numpy(state) if with_state else None)
    want, want_state = jax_ssm._causal_conv(
        jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b),
        state=jnp.asarray(state) if with_state else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_state.numpy(), np.asarray(want_state))


def test_forward_and_loss_match_reference(setup):
    jmodel, jparams, batch, model, params, tbatch = setup
    jlogits, _ = jmodel.forward(jparams, batch)
    logits, _ = model.forward(params, tbatch)
    jlogits = np.asarray(jlogits)
    assert logits.shape == jlogits.shape
    limit = LIMITS[model.cfg.family][0]
    assert np.abs(logits.numpy() - jlogits).max() <= limit * np.abs(jlogits).max()
    np.testing.assert_allclose(float(model.loss(params, tbatch)),
                               float(jmodel.loss(jparams, batch)),
                               rtol=1e-5, atol=1e-5)


def grads_of(model, params, tbatch):
    leaves = {p: v.clone().requires_grad_(True) for p, v in _flatten(params)}
    loss = model.loss(_unflatten(leaves), tbatch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def assert_grads_match(loss, grads, jloss, jgrads, limit):
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5, atol=1e-5)
    want = dict(_flatten(np_tree(jgrads)))
    assert sorted(grads) == sorted(want)
    for path, g in grads.items():
        assert g.shape == want[path].shape, path
        assert np.isfinite(want[path]).all(), path
        assert rel_norm(g.numpy(), want[path]) <= limit, path


@pytest.mark.parametrize("remat", [False, True])
def test_grads_match_reference(setup, jax_sequential_ssd, remat):
    jmodel, jparams, batch, model, params, tbatch = setup
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(jparams, batch)
    if remat:
        model = build_model(dataclasses.replace(model.cfg, remat=True))
    assert_grads_match(*grads_of(model, params, tbatch), jloss, jgrads,
                       LIMITS[model.cfg.family][1])


@pytest.mark.parametrize("remat", [False, True])
def test_model_trains_through_the_ssd_function(setup, jax_sequential_ssd,
                                               monkeypatch, remat):
    """With the SSD through :func:`ssd_scan` (plain versions on the CPU),
    the loss and gradients are the reference's; with remat the forward runs
    again inside backward, so the function's forward is called twice a
    layer."""
    jmodel, jparams, batch, model, params, tbatch = setup
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(jparams, batch)
    calls = []

    def through_function(x, dt, A, Bm, Cm, chunk, initial_state=None):
        assert chunk == model.cfg.ssm_chunk
        calls.append(x.shape)
        return S.ssd_scan(x, dt, A, Bm, Cm, initial_state)

    monkeypatch.setattr(ssm, "ssd_chunked", through_function)
    model = build_model(dataclasses.replace(model.cfg, remat=remat))
    assert_grads_match(*grads_of(model, params, tbatch), jloss, jgrads,
                       LIMITS[model.cfg.family][1])
    n_layers = model.cfg.n_layers
    assert len(calls) == (2 if remat else 1) * n_layers
    assert calls[0] == (4, SEQ, model.cfg.n_ssm_heads, model.cfg.ssm_head_dim)


def test_mamba2_block_off_the_cpu():
    """Off the CPU the SSD goes to the kernels' wrapper, which raises for a
    device other than CUDA, from an initial state too."""
    cfg = get_arch(ARCH).reduced()
    specs = ssm.mamba2_specs(cfg, 1)
    lp = {k: torch.zeros(s.shape[1:], device="meta") for k, s in specs.items()}
    h = torch.zeros((1, 8, cfg.d_model), device="meta")
    state = torch.zeros((1, cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                        device="meta")
    with pytest.raises(ValueError, match="no SSD kernel for device meta"):
        ssm.mamba2_block(cfg, lp, h, ssm_state=state)
    with pytest.raises(ValueError, match="no SSD kernel for device meta"):
        ssm.mamba2_block(cfg, lp, h)


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
    """The reference trainer's results for each family, from one subprocess
    on 8 host devices."""
    root = tmp_path_factory.mktemp("zamba2_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(root)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = {}
    for family in FAMILIES:
        with np.load(root / f"{family}.npz") as f:
            out[family] = dict(f)
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_trainer_matches_reference_loss_for_loss(jax_out, family):
    """``Mamba2LM`` loss for loss, and its final parameters and moments.
    ``Zamba2LM``'s training is chaotic at these weights: its first loss,
    from the same weights, is held to 1e-5, and every loss to the largest
    gap between two of the reference trainer's runs that differ only in the
    order of its SSD's sums (the sequential oracle, its ``ssd_chunked`` at
    each of REORDER_CHUNKS); the trainer's counts exactly."""
    jax_out = jax_out[family]
    _, cfg = configs(family)
    tr = ElasticTrainer(build_model(cfg), make_optimizer("adamw"),
                        SyntheticTokens(cfg.vocab, SEQ, GLOBAL_BATCH, seed=0),
                        global_batch=GLOBAL_BATCH, base_lr=LR, mode="ring",
                        device="cpu", params=reference_init(jax_out))
    for workers, steps, leave in PLANS:
        tr.run_slot(SlotPlan(workers, steps, leave=leave))
    want = jax_out["losses"]
    assert len(tr.losses) == len(want) == 8
    assert np.isfinite(tr.losses).all()
    np.testing.assert_allclose(tr.losses[0], want[0], rtol=0, atol=1e-5)
    if family == "ssm":
        np.testing.assert_allclose(tr.losses, want, rtol=0, atol=1e-5)
    else:
        orderings = np.concatenate([want[None], jax_out["reordered_losses"]])
        assert orderings.shape == (1 + len(REORDER_CHUNKS), 8)
        assert np.isfinite(orderings).all()
        spread = max(np.abs(a - b).max() for a, b in
                     itertools.combinations(orderings, 2))
        gap = np.abs(np.asarray(tr.losses) - want).max()
        assert 0 < gap <= spread, (gap, spread)
    state = {"params": next(iter(tr.params.values())),
             "opt": next(iter(tr.opt_state.values()))}
    leaves = dict(_flatten(state))
    assert int(leaves.pop("opt/step")) == int(jax_out["final/opt/step"]) == 8
    assert sorted(leaves) == sorted(k[len("final/"):] for k in jax_out
                                    if k.startswith("final/") and
                                    k != "final/opt/step")
    if family == "ssm":
        for path, v in leaves.items():
            assert rel_norm(v.numpy(), jax_out[f"final/{path}"]) < 1e-3, path
    re_rings, compiles, reshards, step = jax_out["counts"]
    assert tr.re_ring_events == re_rings == 1
    assert tr.group.compile_count == compiles == 2
    assert tr.resharding_events == reshards and tr.step == step


def reference_init(jax_out):
    """The reference trainer's initial parameters, on the CPU."""
    return params_from_reference(_unflatten(
        {k[len("init/"):]: v for k, v in jax_out.items()
         if k.startswith("init/")}), "cpu")


def snapshot(params, opt_state):
    """The flat state of a port trainer: its parameters and AdamW state."""
    return {k: v.clone() for k, v in _flatten(
        {"params": next(iter(params.values())),
         "opt": next(iter(opt_state.values()))})}


@pytest.fixture(scope="module")
def hybrid_steps(jax_out):
    """The port's ``Zamba2LM`` trainer's state after each of the reference
    trainer's FIRST_STEPS_PLAN steps, each from the reference's state before
    it: the step at w=4 from its initial weights, and the step after the
    re-ring to w=2 from its parameters and AdamW state after the first (so
    that the chaos of training does not enter)."""
    ref = jax_out["hybrid"]
    _, cfg = configs("hybrid")
    out = []
    for step, plan in ((0, SlotPlan(4, 1)), (1, SlotPlan(4, 1, leave=(0, 2)))):
        tr = ElasticTrainer(build_model(cfg), make_optimizer("adamw"),
                            SyntheticTokens(cfg.vocab, SEQ, GLOBAL_BATCH, seed=0),
                            global_batch=GLOBAL_BATCH, base_lr=LR, mode="ring",
                            device="cpu", params=reference_init(ref))
        if step:
            before = _unflatten({k[len("step0/"):]: v for k, v in ref.items()
                                 if k.startswith("step0/")})
            home = tr.group.devices[0]
            tr.params = {home: params_from_reference(before["params"], home)}
            tr.opt_state = {home: params_from_reference(before["opt"], home)}
            tr.step = 1
        states = recorded_states(tr, snapshot)
        tr.run_slot(plan)
        assert len(states) == 1 and tr.step == step + 1
        assert (tr.re_ring_events, tr.group.workers) == ((0, 4), (1, 2))[step]
        out.append(states[0])
    return out


@pytest.mark.parametrize("step", [0, 1], ids=["w=4", "w=2 after the re-ring"])
def test_hybrid_trainer_steps_match_reference(jax_out, hybrid_steps, step):
    """``Zamba2LM``'s first ring step at w=4, and its step after the re-ring
    to w=2, each from the reference trainer's state before it: every AdamW
    moment leaf against the reference trainer's to a relative norm of 2e-2,
    the limit of one gradient (measured at most 2.3e-3 and 1.0e-2, both on
    ``opt/v``), and every parameter leaf likewise (measured at most 1.5e-4
    and 1.9e-3) once the elements whose first moment has the other sign on
    the two sides are set aside: AdamW's update there, nearly ``lr
    sign(m)``, turns a gradient within its limit of zero into a step of
    ``2 lr`` (at most 0.13% of a leaf measured, 1% allowed)."""
    got = dict(hybrid_steps[step])
    ref = jax_out["hybrid"]
    want = {k[len(f"step{step}/"):]: v for k, v in ref.items()
            if k.startswith(f"step{step}/")}
    assert sorted(got) == sorted(want)
    assert int(got.pop("opt/step")) == int(want.pop("opt/step")) == step + 1
    norms = {}
    for path, v in got.items():
        v, w = v.numpy(), want[path]
        assert np.isfinite(w).all() and np.abs(w).max() > 0, path
        if path.startswith("params/"):
            m = "opt/m/" + path[len("params/"):]
            keep = np.sign(got[m].numpy()) == np.sign(want[m])
            assert keep.mean() >= 0.99, path
            v, w = v[keep], w[keep]
        norms[path] = rel_norm(v, w)
    assert max(norms.values()) <= 2e-2, norms


def _jax_reference(root):
    from repro.training.elastic import ElasticTrainer as JaxTrainer
    from repro.training.elastic import SlotPlan as JaxPlan
    from repro.training.optimizer import make_optimizer as jax_make_optimizer

    jax_ssm.ssd_chunked = sequential_ssd
    for family in FAMILIES:
        cfg, _ = configs(family)
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
        if family == "hybrid":
            tr = JaxTrainer(jax_build_model(cfg), jax_make_optimizer("adamw"),
                            data, global_batch=GLOBAL_BATCH, base_lr=LR,
                            mode="ring")
            for p, v in _flatten(jax.device_get(tr.params)):
                np.testing.assert_array_equal(np.asarray(v), res[f"init/{p}"])
            states = recorded_states(tr, lambda p, o: {
                k: np.asarray(v) for k, v in
                _flatten(jax.device_get({"params": p, "opt": o}))})
            tr.run_slot(JaxPlan(*FIRST_STEPS_PLAN))
            for i, state in enumerate(states):
                res.update({f"step{i}/{k}": v for k, v in state.items()})
            reordered = []
            for chunk in REORDER_CHUNKS:
                jax_ssm.ssd_chunked = functools.partial(short_chunked_ssd,
                                                        short=chunk)
                tr = JaxTrainer(jax_build_model(cfg),
                                jax_make_optimizer("adamw"), data,
                                global_batch=GLOBAL_BATCH, base_lr=LR,
                                mode="ring")
                for workers, steps, leave in PLANS:
                    tr.run_slot(JaxPlan(workers, steps, leave=leave))
                reordered.append(tr.losses)
            res["reordered_losses"] = np.array(reordered)
            jax_ssm.ssd_chunked = sequential_ssd
        np.savez(os.path.join(root, f"{family}.npz"), **res)


# -- how far the first loss moves with the form of the SSD, on both sides --
#
# At full width and random init the model amplifies any reordering of its
# sums. Run as a script, this file computes the first loss of zamba2-1.2b
# (full width, ``layers`` deep) at the reference's weights on one batch,
# through each exact form of the SSD on both sides: the reference's
# ``ssd_chunked`` at the config's chunk and at 64, its sequential
# ``ssd_reference``; the port's ``ssd_chunked`` at the same two chunks and
# the kernels' plain version (f32, and f64 at chunks 64 and 256):
#
#     PYTHONPATH=src python tests/test_torch_ssm.py --sensitivity DIR \
#         [layers seq batch]
#
# (default 38 layers, seq 1024, batch 1; about 10 GiB of host memory);
# ``DIR/sensitivity.json`` has the losses.


def _sensitivity(root, layers=38, seq=1024, batch=1):
    import json
    os.makedirs(root, exist_ok=True)
    jcfg = dataclasses.replace(jax_get_arch(ARCH), n_layers=layers)
    cfg = dataclasses.replace(get_arch(ARCH), n_layers=layers)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    data = JaxTokens(jcfg.vocab, seq, batch, seed=0).batch(0)
    native = jax_ssm.ssd_chunked
    out = {"layers": layers, "seq": seq, "batch": batch, "reference": {},
           "port": {}}
    jax_routes = {f"ssd_chunked {jcfg.ssm_chunk}": (native, jcfg.ssm_chunk),
                  "ssd_chunked 64": (native, 64),
                  "ssd_reference": (sequential_ssd, jcfg.ssm_chunk)}
    for name, (fn, chunk) in jax_routes.items():
        jax_ssm.ssd_chunked = fn
        m = jax_build_model(dataclasses.replace(jcfg, ssm_chunk=chunk))
        out["reference"][name] = float(jax.jit(m.loss)(jparams, data))
        print(name, out["reference"][name], flush=True)
    jax_ssm.ssd_chunked = native
    params = params_from_reference(np_tree(jparams), "cpu")
    del jparams
    tbatch = {k: torch.from_numpy(v) for k, v in data.items()}
    chunked = ssm.ssd_chunked
    port_routes = {
        f"ssd_chunked {cfg.ssm_chunk}": None,
        "ssd_chunked 64": lambda *a, chunk, initial_state=None: chunked(
            *a, 64, initial_state=initial_state),
        "plain 64": lambda *a, chunk, initial_state=None: (
            S.ssd_scan_plain(*a)[0], None),
        **{f"plain f64 {c}": lambda *a, chunk, initial_state=None, c=c: (
            S.ssd_scan_plain(*(t.double() for t in a), chunk=c)[0].float(), None)
           for c in (S.SSD_CHUNK, cfg.ssm_chunk)}}
    with torch.no_grad():
        for name, fn in port_routes.items():
            ssm.ssd_chunked = chunked if fn is None else (
                lambda x, dt, A, Bm, Cm, chunk, initial_state=None, fn=fn:
                fn(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state))
            out["port"][name] = float(model.loss(params, tbatch))
            print(name, out["port"][name], flush=True)
    ssm.ssd_chunked = chunked
    with open(os.path.join(root, "sensitivity.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    if sys.argv[1] == "--sensitivity":
        _sensitivity(sys.argv[2], *map(int, sys.argv[3:]))
    else:
        _jax_reference(sys.argv[1])
