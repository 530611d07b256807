"""The port's routed MoE held against the JAX package on the CPU:
``layers.moe_ffn`` alone, and ``MoeLM`` on reduced phi3.5-moe-42b and
reduced arctic-480b (its dense residual MLP in parallel), with the
reference's own weights carried across by ``params_from_reference``.

Limits: ``moe_ffn``'s output and aux loss rtol/atol 1e-5, its gradients
rtol 1e-4 / atol 1e-6. The models' loss and aux loss rtol/atol 1e-5;
neither config has qk-norm, so, as ``tests/test_torch_model.py`` holds
granite-3-2b and h2o-danube-1.8b, their logits are held to ``max|got -
want| <= 1e-4 * max|want|`` and each gradient leaf to ``1e-3 *
max|want|`` (measured: logits 9.0e-6 and 1.2e-5 of their largest value,
gradients at most 1.3e-4 of theirs, ``blocks/ln1`` of phi3.5-moe-42b).
Decode logits 1e-4 of their largest value
(``tests/test_torch_serving.py``'s).

The reduced configs never drop a token (capacity factor 8.0 = E / k x 4),
so every test that needs drops runs at the full configs' 1.25 and asserts
that tokens were dropped: an unstable sort or a wrong capacity would pass
where nothing overflows.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.launch import serve as jax_serve
from repro.models import layers as jax_layers
from repro.models.model import build_model as jax_build_model
from repro.models.module import init_from_specs as jax_init_from_specs
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models.model import build_model
from repro_torch.models.module import _flatten, _unflatten, params_from_reference
from test_torch_model import assert_close_to_leaf_max
from test_torch_serving import _smoke, cache_from_reference, engine_view, rel_gap

MOE_ARCHS = ("phi3.5-moe-42b", "arctic-480b")
FWD, GRAD_RTOL, GRAD_ATOL, DECODE_REL = 1e-5, 1e-4, 1e-6, 1e-4
LOGITS_OF_MAX, GRADS_OF_MAX = 1e-4, 1e-3
FULL_CF = 1.25


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def to_np(t):
    return t.detach().numpy()


def moe_inputs(t_shape=(2, 16), d=32, e=4, f=48, skew=0.0, seed=0):
    """x, router, w_gate, w_up, w_down; ``skew`` pulls every token towards
    expert 0 (a common direction in x that the router's column 0 reads)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(t_shape + (d,)).astype(np.float32)
    router = (rng.standard_normal((d, e)) * 0.3).astype(np.float32)
    if skew:
        u = rng.standard_normal(d).astype(np.float32)
        u /= np.linalg.norm(u)
        x += 2.0 * u
        router[:, 0] += skew * u
    ws = [(rng.standard_normal(s) / math.sqrt(s[-2])).astype(np.float32)
          for s in ((e, d, f), (e, d, f), (e, f, d))]
    return [x, router] + ws


def dropped(x, router, top_k, cf):
    """Token choices beyond their expert's capacity, from the routing."""
    t = x.shape[0] * x.shape[1]
    logits = x.reshape(t, -1) @ router
    ids = np.argsort(-logits, axis=-1)[:, :top_k].reshape(-1)
    counts = np.bincount(ids, minlength=router.shape[1])
    cap = L.moe_capacity(t, router.shape[1], top_k, cf)
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("cf,skew", [(8.0, 0.0), (FULL_CF, 0.0),
                                     (FULL_CF, 6.0), (1.0, 3.0)])
def test_moe_ffn_matches_reference(cf, skew):
    args = moe_inputs(skew=skew)
    top_k = 2
    if skew:
        assert dropped(args[0], args[1], top_k, cf) > 0
    dy = np.random.default_rng(9).standard_normal(args[0].shape).astype(np.float32)

    def jax_obj(*a):
        y, aux = jax_layers.moe_ffn(*a, top_k=top_k, capacity_factor=cf)
        return jnp.sum(y * dy) + aux, (y, aux)

    (_, (jy, jaux)), jgrads = jax.value_and_grad(
        jax_obj, argnums=tuple(range(5)), has_aux=True)(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, aux = L.moe_ffn(*leaves, top_k=top_k, capacity_factor=cf)
    np.testing.assert_allclose(to_np(y), np.asarray(jy), rtol=FWD, atol=FWD)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=FWD, atol=FWD)
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum() + aux, leaves)
    for name, g, jg in zip(("x", "router", "w_gate", "w_up", "w_down"),
                           grads, jgrads):
        np.testing.assert_allclose(to_np(g), np.asarray(jg), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_moe_ffn_drops_the_later_tokens_of_a_full_expert():
    """Capacity overflow in sorted order: of the tokens routed to a full
    expert, the ones with the higher token index get nothing from it."""
    x, router, wg, wu, wd = moe_inputs(skew=6.0)
    t = x.shape[0] * x.shape[1]
    cap = L.moe_capacity(t, router.shape[1], 2, FULL_CF)
    chose0 = np.nonzero((np.argsort(-(x.reshape(t, -1) @ router), axis=-1)
                         [:, :2] == 0).any(-1))[0]
    assert len(chose0) > cap
    full = [torch.from_numpy(a) for a in (x, router, wg, wu, wd)]
    y, _ = L.moe_ffn(*full, top_k=2, capacity_factor=FULL_CF)
    # zero expert 0 entirely: tokens it kept change, tokens it dropped don't
    z = [a.clone() for a in full]
    for w in z[2:]:
        w[0] = 0
    y0, _ = L.moe_ffn(*z, top_k=2, capacity_factor=FULL_CF)
    changed = ((y - y0).abs().reshape(t, -1).amax(-1) > 0).numpy()
    np.testing.assert_array_equal(np.nonzero(changed)[0], chose0[:cap])


def configs(arch, **changes):
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced(), **changes)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **changes)
    return jcfg, cfg


@pytest.fixture(scope="module", params=[(a, cf) for a in MOE_ARCHS
                                        for cf in (None, FULL_CF)],
                ids=lambda p: f"{p[0]}-cf{p[1] or 'reduced'}")
def setup(request):
    arch, cf = request.param
    changes = {} if cf is None else {"moe_capacity": cf}
    jcfg, cfg = configs(arch, **changes)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    batch = JaxTokens(jcfg.vocab, 16, 4, seed=3).batch(0)
    model = build_model(cfg)
    params = params_from_reference(np_tree(jparams), "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jmodel, jparams, batch, model, params, tbatch


def test_param_specs_match_reference(setup):
    jmodel, _, _, model, _, _ = setup
    want = dict(_flatten(jmodel.param_specs()))
    got = dict(_flatten(model.param_specs()))
    assert list(got) == list(want)
    assert len(got) == (16 if model.cfg.dense_residual else 13)
    for path, spec in want.items():
        assert got[path].shape == spec.shape and got[path].axes == spec.axes
        assert (got[path].init, got[path].scale) == (spec.init, spec.scale)


def test_forward_aux_and_loss_match_reference(setup):
    jmodel, jparams, batch, model, params, tbatch = setup
    (jlogits, jaux), (logits, aux) = (jmodel.forward(jparams, batch),
                                      model.forward(params, tbatch))
    assert_close_to_leaf_max(to_np(logits), jlogits, LOGITS_OF_MAX, "logits")
    np.testing.assert_allclose(float(aux["moe_aux"]), float(jaux["moe_aux"]),
                               rtol=FWD, atol=FWD)
    np.testing.assert_allclose(float(model.loss(params, tbatch)),
                               float(jmodel.loss(jparams, batch)),
                               rtol=FWD, atol=FWD)


@pytest.mark.parametrize("remat", [False, True])
def test_grads_match_reference(setup, remat):
    jmodel, jparams, batch, model, params, tbatch = setup
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(jparams, batch)
    model = build_model(dataclasses.replace(model.cfg, remat=remat))
    leaves = {p: v.clone().requires_grad_(True) for p, v in _flatten(params)}
    loss = model.loss(_unflatten(leaves), tbatch)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=FWD,
                               atol=FWD)
    want = dict(_flatten(np_tree(jgrads)))
    assert sorted(grads) == sorted(want)
    for path, g in grads.items():
        assert_close_to_leaf_max(to_np(g), want[path], GRADS_OF_MAX, path)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_lanes_route_each_lane_alone(arch):
    """``decode_step_lanes`` at the full configs' capacity factor against
    the reference's, which vmaps its one-lane ``decode_step`` (routing at
    one token: never a drop); three lanes at their own positions, the
    middle one inactive every other step and kept bit for bit. Each lane
    is also its own batch-1 step, within the same limit: no lane takes
    another's expert slot."""
    jcfg, cfg = configs(arch, moe_capacity=FULL_CF)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    params = params_from_reference(np_tree(jparams), "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (3, 20))
    starts = np.array([0, 3, 7])
    jc = jmodel.steady_decode_cache(jparams, jax_init_from_specs(
        jmodel.cache_specs(3, 24, dtype=jnp.float32), jax.random.PRNGKey(0)))
    c = cache_from_reference(jc)
    lanes_step = jax.jit(jmodel.decode_step_lanes)
    for i in range(6):
        pos = starts + i
        tok = toks[np.arange(3), pos][:, None]
        active = np.array([True, i % 2 == 0, True])
        jl, jnew = lanes_step(jparams, jc, jnp.asarray(tok, jnp.int32),
                              jnp.asarray(pos, jnp.int32))
        jc = jax.tree.map(lambda n, o: jnp.where(jnp.asarray(active).reshape(
            (1, -1) + (1,) * (n.ndim - 2)), n, o).astype(o.dtype), jnew, jc)
        before = {k: v.clone() for k, v in c.items()}
        with torch.no_grad():
            alone = [model.decode_step(
                params, {k: v[:, lane:lane + 1].clone() for k, v in c.items()},
                torch.from_numpy(tok[lane:lane + 1]), int(pos[lane]))[0]
                for lane in range(3)]
            l, new = model.decode_step_lanes(params, c, torch.from_numpy(tok),
                                             torch.from_numpy(pos),
                                             torch.from_numpy(active))
        c = {k: new[k].to(c[k].dtype) for k in c}
        assert rel_gap(to_np(l)[active], np.asarray(jl)[active]) <= DECODE_REL, i
        for lane in np.nonzero(active)[0]:
            assert rel_gap(to_np(l[lane]), to_np(alone[lane][0])) <= DECODE_REL
        if not active[1]:
            for k in c:
                assert torch.equal(c[k][:, 1], before[k][:, 1]), (i, k)


def test_reference_forward_decode_gap_is_the_cards_source():
    """As ``tests/test_torch_serving.py``'s test of the same name, for
    reduced phi3.5-moe-42b (capacity factor 8.0: neither side's forward
    drops a token, so decode and forward compute the same function), with
    an f32 KV cache on both sides: ``chip_smoke.SERVE_REF_GAP_F32_CACHE``
    records the reference's gap. With the specs' bf16 cache the
    reference's own gap is 0.13 (the port's the same): the router at
    random init is near-uniform, and the cache's rounding flips its top-2
    choices."""
    arch = "phi3.5-moe-42b"
    smoke = _smoke()
    jcfg, cfg = configs(arch)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    params = params_from_reference(np_tree(jparams), "cpu")
    seq, b = 64, 2
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (b, seq))
    fwd = np.asarray(jmodel.forward(jparams, {"tokens": jnp.asarray(
        toks, jnp.int32)})[0])
    jc = jmodel.steady_decode_cache(jparams, jax_init_from_specs(
        jmodel.cache_specs(b, seq, dtype=jnp.float32), jax.random.PRNGKey(0)))
    step = jax.jit(jmodel.decode_step)
    dec = []
    for t in range(seq):
        logits, jc = step(jparams, jc, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                          jnp.int32(t))
        dec.append(np.asarray(logits)[:, 0])
    ref_gap = rel_gap(np.stack(dec, 1), fwd)
    with torch.no_grad():
        pfwd = model.forward(params, {"tokens": torch.from_numpy(toks)})[0]
        c = cache_from_reference(jax_init_from_specs(
            jmodel.cache_specs(b, seq, dtype=jnp.float32), jax.random.PRNGKey(0)))
        pdec = []
        for t in range(seq):
            logits, c = model.decode_step(params, c,
                                          torch.from_numpy(toks[:, t:t + 1]), t)
            pdec.append(logits[:, 0])
    port_gap = rel_gap(to_np(torch.stack(pdec, 1)), to_np(pfwd))
    recorded = smoke.SERVE_REF_GAP_F32_CACHE[arch]
    print(f"{arch}: the reference's forward-vs-decode gap {ref_gap:.4g}, "
          f"the port's {port_gap:.4g}, recorded {recorded}")
    assert recorded / 2 < ref_gap <= recorded
    assert port_gap <= recorded


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_identical_to_reference(arch):
    """5 staggered requests through 3 lanes at the full configs' capacity
    factor: tokens, clocks and captures equal the reference engine's."""
    jcfg, cfg = configs(arch, moe_capacity=FULL_CF)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    params = params_from_reference(np_tree(jparams), "cpu")
    out = {}
    for side, mod, engine in (
            ("ref", jax_serve, jax_serve.ServingEngine(
                jmodel, jparams, max_batch=3, max_seq=32, prefill_chunk=4)),
            ("port", serve, serve.ServingEngine(
                model, params, max_batch=3, max_seq=32, prefill_chunk=4))):
        rng = np.random.default_rng(3)
        reqs = [mod.Request(id=i, prompt=rng.integers(
            0, cfg.vocab, size=5 + i, dtype=np.int32), max_new=6,
            arrival=3 * i) for i in range(5)]
        with torch.no_grad():
            mod.serve_requests(engine, reqs)
        assert mod.audit_serving_engine(engine) == []
        out[side] = engine_view(engine, reqs)
    assert out["port"] == out["ref"]
