"""The port's dense LM, layers, AdamW and data pipeline held against the
JAX package on reduced qwen3-0.6b, granite-3-2b and h2o-danube-1.8b in f32,
with the reference's own weights carried across by ``params_from_reference``.

Both run on the CPU in this process, JAX with one host device. Tolerances:
loss rtol/atol 1e-5; on qwen3-0.6b logits rtol/atol 1e-5 and grads rtol
1e-4 / atol 1e-6 (the two frameworks sum matrix products in different
orders); AdamW atol 1e-6. Reduced granite-3-2b and h2o-danube-1.8b have no
qk-norm, and their reduced weights give attention scores up to about 144,
where the softmax is nearly one-hot and every reordered sum is amplified:
the reference against itself, with only its attention sums reordered
(chunks of 4), differs by 1.2e-5 of a gradient leaf's largest value
(5.7e-7 on qwen3), and the port by at most 1.35e-4 (``blocks/ln1``). They are
held per leaf to ``max|got - want| <= 1e-4 * max|want|`` for the logits and
``1e-3 * max|want|`` for the grads.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.models import layers as jax_layers
from repro.models.model import build_model as jax_build_model
from repro.training.optimizer import adamw_init as jax_adamw_init
from repro.training.optimizer import adamw_update as jax_adamw_update
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models import layers as L
from repro_torch.models.model import build_model
from repro_torch.models.module import (
    _flatten,
    _unflatten,
    params_from_reference,
    params_to_numpy,
    tree_map,
)
from repro_torch.training.optimizer import adamw_init, adamw_update, make_optimizer

ARCH = "qwen3-0.6b"
DENSE_ARCHS = ("qwen3-0.6b", "granite-3-2b", "h2o-danube-1.8b")
# (arch, full-size parameter count of the reference's specs)
PARAM_COUNTS = {"qwen3-0.6b": 751_632_384, "granite-3-2b": 2_634_713_088,
                "h2o-danube-1.8b": 1_831_201_280}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=DENSE_ARCHS)
def setup(request):
    arch = request.param
    jcfg = jax_get_arch(arch).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    batch = JaxTokens(jcfg.vocab, 16, 4, seed=3).batch(0)
    model = build_model(get_arch(arch).reduced())
    params = params_from_reference(np_tree(jparams), "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jmodel, jparams, batch, model, params, tbatch


def assert_trees_close(got, want, **tol):
    got, want = dict(_flatten(got)), dict(_flatten(want))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(np.asarray(got[path]), np.asarray(want[path]),
                                   err_msg=path, **tol)


def assert_close_to_leaf_max(got, want, rel, name=""):
    """``max|got - want| <= rel * max|want|`` (the module docstring says why
    the configs without qk-norm are held so)."""
    got, want = np.asarray(got), np.asarray(want)
    gap, peak = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert got.shape == want.shape and gap <= rel * peak, (name, gap, peak)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_config_and_param_count_match_reference(arch):
    for reduced in (False, True):
        ref, cfg = jax_get_arch(arch), get_arch(arch)
        if reduced:
            ref, cfg = ref.reduced(), cfg.reduced()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert cfg.n_params() == ref.n_params()
    assert get_arch(arch).n_params() == PARAM_COUNTS[arch]


def test_param_specs_match_reference(setup):
    jmodel, _, _, model, _, _ = setup
    want = dict(_flatten(jmodel.param_specs()))
    got = dict(_flatten(model.param_specs()))
    assert list(got) == list(want)
    assert len(got) == (14 if model.cfg.qk_norm else 12)
    for path, spec in want.items():
        assert got[path].shape == spec.shape and got[path].axes == spec.axes
        assert (got[path].init, got[path].scale) == (spec.init, spec.scale)


def test_forward_and_loss_match_reference(setup):
    jmodel, jparams, batch, model, params, tbatch = setup
    jlogits, _ = jmodel.forward(jparams, batch)
    logits, _ = model.forward(params, tbatch)
    if model.cfg.qk_norm:
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert_close_to_leaf_max(logits.numpy(), jlogits, 1e-4, "logits")
    np.testing.assert_allclose(float(model.loss(params, tbatch)),
                               float(jmodel.loss(jparams, batch)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_grads_match_reference(setup, remat):
    jmodel, jparams, batch, model, params, tbatch = setup
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(jparams, batch)
    if remat:
        model = build_model(dataclasses.replace(model.cfg, remat=True))
    leaves = {p: v.clone().requires_grad_(True) for p, v in _flatten(params)}
    loss = model.loss(_unflatten(leaves), tbatch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5, atol=1e-5)
    got = _unflatten(dict(zip(leaves, grads)))
    if model.cfg.qk_norm:
        assert_trees_close(got, np_tree(jgrads), rtol=1e-4, atol=1e-6)
        return
    want = dict(_flatten(np_tree(jgrads)))
    assert sorted(dict(_flatten(got))) == sorted(want)
    for path, g in _flatten(got):
        assert_close_to_leaf_max(g, want[path], 1e-3, path)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_attention_matches_reference(causal, window):
    rng = np.random.default_rng(7)
    b, s, hq, hkv, d = 2, 70, 4, 2, 16
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for h in (hq, hkv, hkv))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = np.asarray(jax_layers.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    dense = L.attention_reference(tq, tk, tv, causal=causal, window=window)
    chunked = L.attention_chunked(tq, tk, tv, causal=causal, window=window,
                                  chunk=32)   # 70 keys: a padded last chunk
    np.testing.assert_allclose(dense.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(chunked.numpy(), dense.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(L.attention(tq, tk, tv, causal=causal,
                                           window=window).numpy(),
                               dense.numpy(), rtol=0, atol=0)


def test_adamw_step_matches_reference(setup):
    _, jparams, _, _, params, _ = setup
    rng = np.random.default_rng(5)
    jgrads = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)),
        jparams)
    grads = params_from_reference(np_tree(jgrads), "cpu")
    jp, jstate = jparams, jax_adamw_init(jparams)
    p, state = params, adamw_init(params)
    for _ in range(2):   # two steps: the bias corrections move with step
        jp, jstate = jax_adamw_update(jgrads, jstate, jp, lr=1e-3)
        p, state = adamw_update(grads, state, p, lr=1e-3)
    assert_trees_close(p, np_tree(jp), rtol=0, atol=1e-6)
    assert_trees_close(state["m"], np_tree(jstate["m"]), rtol=0, atol=1e-6)
    assert_trees_close(state["v"], np_tree(jstate["v"]), rtol=0, atol=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 2
    assert make_optimizer("adamw").update is adamw_update
    # Adafactor and SGD-momentum are held in tests/test_torch_optimizer.py
    for name in ("adafactor", "sgdm"):
        assert make_optimizer(name).name == name


def test_synthetic_tokens_identical():
    for vocab, seq, gb, seed in [(512, 16, 8, 0), (151936, 1024, 8, 0),
                                 (97, 5, 3, 4)]:
        a, b = SyntheticTokens(vocab, seq, gb, seed), JaxTokens(vocab, seq, gb, seed)
        for step in (0, 1, 17):
            x, y = a.batch(step), b.batch(step)
            assert sorted(x) == sorted(y)
            for key in y:
                assert x[key].dtype == y[key].dtype
                np.testing.assert_array_equal(x[key], y[key])


def test_params_cross_both_ways_including_bf16():
    jmodel = jax_build_model(jax_get_arch(ARCH).reduced())
    jparams = jmodel.init(jax.random.PRNGKey(1))        # the specs' bf16
    bits = jax.tree.map(lambda a: np.asarray(a).view(np.uint16), jparams)
    params = params_from_reference(bits, "cpu")
    for path, t in _flatten(params):
        assert t.dtype == torch.bfloat16, path
    assert_trees_close(params_to_numpy(params), bits, rtol=0, atol=0)
    # bf16 values, not only bits, agree
    assert_trees_close(tree_map(lambda t: t.float(), params),
                       jax.tree.map(lambda a: np.asarray(a, np.float32), jparams),
                       rtol=0, atol=0)


def test_unported_families_raise():
    """Every family of the reference is ported
    (tests/test_torch_configs.py); an unknown one raises ``ValueError``, as
    in the reference."""
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), family="mlp-mixer")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(cfg)
