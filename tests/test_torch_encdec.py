"""The port's encoder-decoder and VLM families held against the JAX package
on the CPU: ``layers.layer_norm`` and ``gelu_mlp``; ``WhisperLM`` on
reduced whisper-large-v3; ``DenseLM`` as a VLM on reduced internvl2-26b
(patch embeddings prepended to the tokens) and as the dense phi3-medium-14b,
with the reference's own weights carried across by
``params_from_reference``.

Limits: ``layer_norm`` and ``gelu_mlp`` rtol/atol 1e-6; the models' loss
rtol/atol 1e-5, the limit of ``tests/test_torch_model.py``. None of these
configs has qk-norm, so, as that file holds granite-3-2b, the logits are
held to ``max|got - want| <= rel * max|want|`` and each gradient leaf
likewise (:data:`LIMITS`): internvl2-26b and phi3-medium-14b to
granite-3-2b's 1e-4 and 1e-3 (measured: logits 9.2e-6 and 8.8e-6, leaves
at most 9.4e-5 and 1.3e-4). Reduced whisper-large-v3 at random init is far
more sensitive: the reference against itself with every weight moved by
one f32 ulp (random signs) moves its logits by 2.9e-4 of their largest
value and a gradient leaf by up to 2.2e-3 of its own (``enc_blocks/wk``),
where the port differs from it by 2.2e-4 and 1.3e-3 (each decoder layer
alone, from the reference's inputs, by 4e-6); it is held to 1e-3 and
3e-3. Decode logits 1e-4 of their largest value
(``tests/test_torch_serving.py``'s).
Decode against the forward is not compared for these two families, as in
the reference (``tests/test_models_smoke.py``): the VLM's forward sees
patches that decode never does, and the engine's cross K/V are zeros
(decode attends to them), not the encoder's.
"""

import dataclasses

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
from test_torch_serving import cache_from_reference, engine_view, rel_gap

ARCHS = ("whisper-large-v3", "internvl2-26b", "phi3-medium-14b")
FWD, DECODE_REL = 1e-5, 1e-4
# arch -> (logits, each gradient leaf): max|got - want| over max|want|
LIMITS = {"whisper-large-v3": (1e-3, 3e-3), "internvl2-26b": (1e-4, 1e-3),
          "phi3-medium-14b": (1e-4, 1e-3)}


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


def make_batch(cfg, batch=4, seq=16, seed=3):
    """The pipeline's tokens and labels, and the family's stub inputs
    (``tests/test_models_smoke.py``'s scale, 0.02) from numpy."""
    out = dict(JaxTokens(cfg.vocab, seq, batch, seed=seed).batch(0))
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        out["patch_embeds"] = (rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = (rng.standard_normal(
            (batch, cfg.n_frames, cfg.d_model)) * 0.02).astype(np.float32)
    return out


@pytest.mark.parametrize("shape", [(3, 5, 24), (2, 7)])
def test_layer_norm_and_gelu_mlp_match_reference(shape):
    rng = np.random.default_rng(1)
    d, f = shape[-1], 40
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    w, b = (rng.standard_normal(d).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        to_np(L.layer_norm(*map(torch.from_numpy, (x, w, b)))),
        np.asarray(jax_layers.layer_norm(*map(jnp.asarray, (x, w, b)))),
        rtol=1e-6, atol=1e-6)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.3
          for s in ((d, f), (f,), (f, d), (d,))]
    np.testing.assert_allclose(
        to_np(L.gelu_mlp(*map(torch.from_numpy, [x] + ws))),
        np.asarray(jax_layers.gelu_mlp(*map(jnp.asarray, [x] + ws))),
        rtol=1e-6, atol=1e-6)
    # the tanh form, which is jax.nn.gelu's default, and not the exact one
    exact = torch.nn.functional.gelu(torch.tensor([1.5]))
    assert float(exact) != float(jax.nn.gelu(jnp.float32(1.5)))


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg = jax_get_arch(arch).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    batch = make_batch(jcfg)
    model = build_model(get_arch(arch).reduced())
    params = params_from_reference(np_tree(jparams), "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jmodel, jparams, batch, model, params, tbatch


def test_param_specs_match_reference(setup):
    jmodel, _, _, model, _, _ = setup
    want = dict(_flatten(jmodel.param_specs()))
    got = dict(_flatten(model.param_specs()))
    assert list(got) == list(want)
    assert len(got) == {"encdec": 37, "vlm": 12, "dense": 12}[model.cfg.family]
    for path, spec in want.items():
        assert got[path].shape == spec.shape and got[path].axes == spec.axes
        assert (got[path].init, got[path].scale) == (spec.init, spec.scale)


def test_forward_and_loss_match_reference(setup):
    jmodel, jparams, batch, model, params, tbatch = setup
    jlogits, _ = jmodel.forward(jparams, batch)
    logits, aux = model.forward(params, tbatch)
    assert logits.shape == (4, 16, model.cfg.padded_vocab) and aux == {}
    limit = LIMITS[model.cfg.name.replace("-reduced", "")][0]
    assert_close_to_leaf_max(to_np(logits), jlogits, limit, "logits")
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
    limit = LIMITS[model.cfg.name.replace("-reduced", "")][1]
    for path, g in grads.items():
        assert_close_to_leaf_max(to_np(g), want[path], limit, path)


def test_vlm_logits_cover_the_text_only():
    """Patches shift every text position's context, and no logit is given
    for a patch position."""
    cfg = get_arch("internvl2-26b").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg).items()}
    with torch.no_grad():
        with_patches = model.forward(params, batch)[0]
        text = model.forward(params, {"tokens": batch["tokens"]})[0]
    assert with_patches.shape == text.shape == (4, 16, cfg.padded_vocab)
    assert not torch.allclose(with_patches, text)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-26b"])
def test_decode_lanes_match_reference(arch):
    """``decode_step_lanes`` against the reference's vmapped one, three
    lanes at their own positions, the middle one inactive every other step
    and kept bit for bit (whisper's cross K/V included); the cache f32 on
    both sides, its cross K/V random rather than the engine's zeros."""
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    params = params_from_reference(np_tree(jparams), "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (3, 20))
    starts = np.array([0, 3, 7])
    rng = np.random.default_rng(5)
    jc = jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape) * 0.5, jnp.float32)
        if s.shape[2] == cfg.n_frames else jnp.zeros(s.shape, jnp.float32),
        jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype),
                     jmodel.abstract_cache(3, 24)))
    assert sorted(jc) == (["k", "v", "xk", "xv"] if cfg.family == "encdec"
                          else ["k", "v"])
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
            l, new = model.decode_step_lanes(params, c, torch.from_numpy(tok),
                                             torch.from_numpy(pos),
                                             torch.from_numpy(active))
        c = {k: new[k].to(c[k].dtype) for k in c}
        assert rel_gap(to_np(l)[active], np.asarray(jl)[active]) <= DECODE_REL, i
        for k in c:
            if not active[1]:
                assert torch.equal(c[k][:, 1], before[k][:, 1]), (i, k)
            if k in ("xk", "xv"):
                assert torch.equal(c[k], before[k])


def test_whisper_cache_specs_and_steady_dtypes_match_reference():
    jcfg, cfg = jax_get_arch("whisper-large-v3").reduced(), \
        get_arch("whisper-large-v3").reduced()
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    params = params_from_reference(np_tree(jparams), "cpu")
    jabstract, abstract = jmodel.abstract_cache(2, 8), model.abstract_cache(2, 8)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[1], v.device.type)
            for k, v in abstract.items()} == \
        {k: (tuple(v.shape), jnp.dtype(v.dtype).name, "meta")
         for k, v in jabstract.items()}
    want = jmodel.steady_decode_cache(jparams, jax_init_from_specs(
        jmodel.cache_specs(2, 8), jax.random.PRNGKey(0)))
    got = model.steady_decode_cache(params, model.init_cache(2, 8, "cpu"))
    assert {k: str(v.dtype).split(".")[1] for k, v in got.items()} == \
        {k: jnp.dtype(v.dtype).name for k, v in want.items()}


@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-26b"])
def test_engine_identical_to_reference(arch):
    """5 staggered requests through 3 lanes: tokens, clocks and captures
    equal the reference engine's (whisper's decode attends to the zero
    cross K/V on both sides)."""
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
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


def _cross_kv(enc_out, xk, xv):
    """Every decoder layer's cross K and V of ``enc_out`` (B, F, D), stacked
    as the cache lays them out: (layers, B, F, Hkv, hd)."""
    return (np.einsum("bsd,ldhk->lbshk", enc_out, xk),
            np.einsum("bsd,ldhk->lbshk", enc_out, xv))


def test_reference_forward_decode_gap_with_the_encoders_cross_kv():
    """Decode with the encoder's cross K/V in an f32 cache computes the
    training forward's function, token by token. The reference's own gap,
    max |decode - forward| over max |forward| at every position, is what
    ``chip_smoke.SERVE_REF_GAP_F32_CACHE`` records for whisper-large-v3;
    as it does the MoE's, here the larger of the reference's and the
    port's own gaps (2.1e-5 and 3.4e-5: this model at random init amplifies
    reordered sums, module docstring). (The engine leaves the cross K/V at zero, as
    the reference's does; with the specs' bf16 cache the reference's decode
    moves by 0.098 of the largest logit against an f32 cache, which is why
    the cache here is f32.)"""
    from test_torch_serving import _smoke

    arch = "whisper-large-v3"
    smoke = _smoke()
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    params = params_from_reference(np_tree(jparams), "cpu")
    batch = make_batch(jcfg, batch=2, seq=32)
    toks, frames = batch["tokens"], batch["frames"]
    seq = toks.shape[1]
    fwd = np.asarray(jmodel.forward(jparams, {"tokens": toks, "frames": frames})[0])
    enc = np.asarray(jmodel.encode(jparams, jnp.asarray(frames)))
    xk, xv = _cross_kv(enc, np.asarray(jparams["dec_blocks"]["xk"]),
                       np.asarray(jparams["dec_blocks"]["xv"]))
    jc = dict(jax_init_from_specs(jmodel.cache_specs(2, seq, dtype=jnp.float32),
                                  jax.random.PRNGKey(0)))
    c = cache_from_reference(jc)
    jc["xk"], jc["xv"] = jnp.asarray(xk), jnp.asarray(xv)
    with torch.no_grad():   # the port's cross K/V from its own encoder
        c["xk"], c["xv"] = smoke.encoder_cross_kv(model, params,
                                                  torch.from_numpy(frames))
    step = jax.jit(jmodel.decode_step)
    dec, pdec = [], []
    for t in range(seq):
        logits, jc = step(jparams, jc, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                          jnp.int32(t))
        dec.append(np.asarray(logits)[:, 0])
        with torch.no_grad():
            logits, c = model.decode_step(params, c,
                                          torch.from_numpy(toks[:, t:t + 1]), t)
        pdec.append(to_np(logits[:, 0]))
    with torch.no_grad():
        pfwd = to_np(model.forward(params, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})[0])
    ref_gap, port_gap = rel_gap(np.stack(dec, 1), fwd), rel_gap(np.stack(pdec, 1), pfwd)
    recorded = smoke.SERVE_REF_GAP_F32_CACHE[arch]
    print(f"{arch}: the reference's forward-vs-decode gap {ref_gap:.4g}, "
          f"the port's {port_gap:.4g}, recorded {recorded}")
    assert recorded / 2 < max(ref_gap, port_gap) <= recorded
