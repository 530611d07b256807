"""The port's Adafactor and SGD-momentum held against the JAX package's over
three steps on reduced arctic-480b's parameter tree (leaves of one to four
axes; Adafactor factors the last two of every leaf with two or more), with
fresh seeded gradients each step: parameters and every state leaf within
atol 1e-6. ``make_optimizer`` gives all three optimizers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models.model import build_model as jax_build_model
from repro.training import optimizer as jax_opt
from repro_torch.models.module import _flatten, params_from_reference
from repro_torch.training import optimizer as opt

STEPS, ATOL = 3, 1e-6


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_trees_close(got, want):
    got, want = dict(_flatten(got)), dict(_flatten(np_tree(want)))
    assert sorted(got) == sorted(want)
    for path in want:
        g = got[path]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == want[path].shape, path
        np.testing.assert_allclose(g, want[path], rtol=0, atol=ATOL,
                                   err_msg=path)


@pytest.fixture(scope="module")
def tree():
    jmodel = jax_build_model(jax_get_arch("arctic-480b").reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    return jparams, params_from_reference(np_tree(jparams), "cpu")


def run_both(name, kwargs, tree):
    jparams, params = tree
    rng = np.random.default_rng(11)
    jstate = getattr(jax_opt, f"{name}_init")(jparams)
    state = getattr(opt, f"{name}_init")(params)
    jp, p = jparams, params
    for _ in range(STEPS):
        jgrads = jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), jparams)
        grads = params_from_reference(np_tree(jgrads), "cpu")
        jp, jstate = getattr(jax_opt, f"{name}_update")(jgrads, jstate, jp,
                                                        lr=1e-2, **kwargs)
        p, state = getattr(opt, f"{name}_update")(grads, state, p, lr=1e-2,
                                                  **kwargs)
    return jp, jstate, p, state


@pytest.mark.parametrize("kwargs", [{}, {"weight_decay": 0.1},
                                    {"clip_threshold": 0.05}])
def test_adafactor_matches_reference(tree, kwargs):
    jp, jstate, p, state = run_both("adafactor", kwargs, tree)
    assert_trees_close(p, jp)
    assert_trees_close(state["stats"], jstate["stats"])
    assert int(state["step"]) == int(jstate["step"]) == STEPS
    shapes = {path: tuple(v.shape) for path, v in _flatten(state["stats"])}
    assert shapes["blocks/we_gate/vr"] == tuple(p["blocks"]["we_gate"].shape[:-1])
    assert shapes["ln_f/v"] == tuple(p["ln_f"].shape)


@pytest.mark.parametrize("kwargs", [{}, {"momentum": 0.5, "weight_decay": 0.1}])
def test_sgdm_matches_reference(tree, kwargs):
    jp, jstate, p, state = run_both("sgdm", kwargs, tree)
    assert_trees_close(p, jp)
    assert_trees_close(state["mom"], jstate["mom"])
    assert int(state["step"]) == int(jstate["step"]) == STEPS


def test_make_optimizer_gives_all_three():
    for name in ("adamw", "adafactor", "sgdm"):
        o = opt.make_optimizer(name)
        assert (o.name, o.init, o.update) == (
            name, getattr(opt, f"{name}_init"), getattr(opt, f"{name}_update"))
    with pytest.raises(ValueError):
        opt.make_optimizer("lamb")
