"""The port's serving half held against the JAX package's at reduced size:
``decode_attention``, every family's ``decode_step`` and cache, chunked
prefill and greedy generation, the continuous-batching engine, and serve
jobs scheduled beside training through ``ServingBackend``.

Weights are the reference's own, carried across by
``params_from_reference``; the cache starts at zero on both sides. The
limits:

  * ``decode_attention`` and every family's one-step decode from the
    reference's own cache, at every position of a 20-token sequence, with
    bf16 K/V and with an f32 cache: logits ``max|got - want| <= 1e-4 *
    max|want|`` (reduced zamba2-1.2b with bf16 K/V 1e-3: the test says
    why); every cache leaf to 1e-4 of its largest value, bf16 leaves plus
    one bf16 rounding (relative 2^-7: the two sides round f32 values that
    differ in their last bits).
  * Free-running decode (each side carrying its own cache) at every
    position to ``1e-4 * max|want|`` for qwen3-0.6b, h2o-danube-1.8b (its
    window cut to 8 so that the ring buffer wraps) and rwkv6-7b (measured:
    3.7e-6, 1.2e-5, 1.9e-6). Reduced zamba2-1.2b is not held so: at random
    init it amplifies any one-ulp difference of its bf16 K/V (its step 0 is
    3.5e-7 of the reference, later steps up to 4.4e-3, and 2.3e-4 with an
    f32 cache on both sides), which is why every family is also held one
    step at a time from the reference's cache.
  * Greedy tokens identical to the reference's on ``tests/test_serving.py``'s
    seeds with f32 weights for every family, and with the specs' bf16
    weights for qwen3-0.6b. With bf16 weights reduced zamba2-1.2b's second
    prompt leaves the reference's tokens at its second generated token (the
    reference: 1, 377, 102, ...; the port: 1, 122, 486, ...): bf16 products
    round differently in the two frameworks, and this model amplifies it.
  * The engine: per-request tokens, clocks, TTFT and completion clocks and
    step counts identical to the reference's engine on the same trace; the
    co-scheduled GADGET run's event log, ``z``, slot records and backend
    reports identical to the reference's.
  * The reference's own gap between its training forward and its decode
    (the bf16 KV cache rounds each K and V) is the source of the card's
    limits on the port's: ``chip_smoke.SERVE_REF_GAP`` holds what this file
    measures, and the card's limit is that times ``SERVE_GAP_FACTOR``.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sched as jax_sched
from repro.analysis.sanitize import SanitizerError as JaxSanitizerError
from repro.cluster.topology import Link as JaxLink
from repro.cluster.topology import Server as JaxServer
from repro.cluster.topology import SubstrateGraph as JaxGraph
from repro.configs import get_arch as jax_get_arch
from repro.core.problem import DDLJSInstance as JaxInstance
from repro.core.problem import Job as JaxJob
from repro.core.utility import sqrt_utility as jax_sqrt_utility
from repro.launch import serve as jax_serve
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models.model import build_model as jax_build_model
from repro.models.module import init_from_specs as jax_init_from_specs
import repro_torch.sched as sched
from repro_torch.analysis.sanitize import SanitizerError
from repro_torch.cluster.topology import Link, Server, SubstrateGraph
from repro_torch.configs import get_arch
from repro_torch.core.problem import DDLJSInstance, Job
from repro_torch.core.utility import sqrt_utility
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models.model import (
    build_model,
    cache_lane,
    set_cache_lane,
    zero_cache_lane,
)
from repro_torch.models.module import params_from_reference
from test_torch_sched import plain

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("qwen3-0.6b", "h2o-danube-1.8b", "rwkv6-7b", "zamba2-1.2b")
# the window of h2o-danube-1.8b's reduced config is 4096: cut to 8 so that a
# 24-slot cache is a ring buffer that wraps
WINDOW = {"h2o-danube-1.8b": 8}
# Mamba2LM: zamba2-1.2b's config with family="ssm", as tests/test_torch_ssm.py
# builds it
MAMBA2 = "zamba2-1.2b/ssm"
REL = 1e-4
ZAMBA_BF16_STEP = 1e-3
B, S, MAX_SEQ = 2, 20, 24
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This file's torch ops are small: one thread each, since test workers
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def configs(arch):
    """Both sides' reduced configs of ``arch``; ``MAMBA2`` is Mamba2LM."""
    name, _, family = arch.partition("/")
    jcfg, cfg = jax_get_arch(name).reduced(), get_arch(name).reduced()
    if family:
        jcfg = dataclasses.replace(jcfg, family=family)
        cfg = dataclasses.replace(cfg, family=family)
    if arch in WINDOW:
        jcfg = dataclasses.replace(jcfg, sliding_window=WINDOW[arch])
        cfg = dataclasses.replace(cfg, sliding_window=WINDOW[arch])
    return jcfg, cfg


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def bits_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a).view(np.uint16), tree)


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    """(reference model, its f32 weights, port model, the same weights)."""
    jcfg, cfg = configs(request.param)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    model = build_model(cfg)
    return jmodel, jparams, model, params_from_reference(np_tree(jparams), "cpu")


def rel_gap(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def jax_cache(jmodel, jparams, batch, max_seq):
    return jmodel.steady_decode_cache(jparams, jax_init_from_specs(
        jmodel.cache_specs(batch, max_seq), jax.random.PRNGKey(0)))


def cache_from_reference(jcache):
    out = {}
    for k, v in jcache.items():
        a = np.asarray(v)
        out[k] = (torch.from_numpy(a.view(np.uint16).view(np.int16).copy())
                  .view(torch.bfloat16) if a.dtype == jnp.bfloat16
                  else torch.from_numpy(a.copy()))
    return out


def _as_reference(cache):
    """A port cache as the reference's arrays (bf16 through its bits)."""
    out = {}
    for k, v in cache.items():
        out[k] = (jnp.asarray(v.view(torch.int16).numpy().view(np.uint16)
                              ).view(jnp.bfloat16)
                  if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy()))
    return out


def tokens(vocab, batch=B, length=S, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (batch, length))


# ---------------------------------------------------------------------------
# decode attention and the families' decode steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("q_dtype", [jnp.float32, jnp.bfloat16])
def test_decode_attention_matches_reference(window, q_dtype):
    rng = np.random.default_rng(7)
    b, sc, hq, hkv, d = 3, 12, 4, 2, 16
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sc, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sc, hkv, d)).astype(np.float32)
    jq = jnp.asarray(q).astype(q_dtype)
    jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    tq = torch.from_numpy(q).to(TORCH_DTYPE[jnp.dtype(q_dtype).name])
    tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (k, v))
    for cur in (0, 4, sc - 1):
        want = jax_layers.decode_attention(jq, jk, jv, jnp.int32(cur),
                                           window=window)
        got = L.decode_attention(tq, tk, tv, cur, window=window)
        assert got.dtype == tq.dtype
        assert rel_gap(to_np(got), want) <= REL
    # one position a lane: each lane as the reference at its own position
    positions = [2, 7, 11]
    got = L.decode_attention(tq, tk, tv, torch.tensor(positions),
                             window=window)
    for lane, pos in enumerate(positions):
        want = jax_layers.decode_attention(
            jq[lane:lane + 1], jk[lane:lane + 1], jv[lane:lane + 1],
            jnp.int32(pos), window=window)
        assert rel_gap(to_np(got[lane:lane + 1]), want) <= REL


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
def test_decode_step_from_the_reference_cache(pair, cache_dtype):
    """Every position, one step of each side from the *reference's* cache:
    the logits and the new cache leaves (so nothing accumulates), with the
    specs' bf16 K/V and with every leaf f32. Reduced zamba2-1.2b with bf16
    K/V is held to ``ZAMBA_BF16_STEP``: one K or V element that rounds to
    the other bf16 neighbour moves its logits by up to 1.3e-4 within the
    step (its position 1), where the reference's own logits move by 6.8e-4
    to 0.16 when its cache is not rounded at all."""
    jmodel, jparams, model, params = pair
    limit = (ZAMBA_BF16_STEP if model.cfg.family == "hybrid"
             and cache_dtype == "bfloat16" else REL)
    toks = tokens(model.cfg.vocab)
    jc = jmodel.steady_decode_cache(jparams, jax_init_from_specs(
        jmodel.cache_specs(B, MAX_SEQ, dtype=jnp.dtype(cache_dtype)),
        jax.random.PRNGKey(0)))
    step = jax.jit(jmodel.decode_step)
    for t in range(S):
        tok = toks[:, t:t + 1]
        jl, jnew = step(jparams, jc, jnp.asarray(tok, jnp.int32), jnp.int32(t))
        with torch.no_grad():
            l, new = model.decode_step(params, cache_from_reference(jc),
                                       torch.from_numpy(tok), t)
        assert rel_gap(to_np(l), jl) <= limit, t
        for k, want in jnew.items():
            assert new[k].dtype == TORCH_DTYPE[jnp.dtype(want.dtype).name], k
            got, want_f = to_np(new[k]), np.asarray(want, np.float32)
            # bf16: one rounding of values that differ by REL of the leaf
            ulp = 2.0**-7 * np.abs(want_f) if want.dtype == jnp.bfloat16 else 0
            assert np.all(np.abs(got - want_f) <= ulp + REL * np.abs(want_f).max()
                          ), (t, k)
        jc = jnew


@pytest.mark.parametrize("pair", [a for a in FAMILIES if a != "zamba2-1.2b"],
                         indirect=True)
def test_free_running_decode_every_position(pair):
    """Each side carrying its own cache (reduced zamba2-1.2b is held one
    step at a time instead: module docstring)."""
    jmodel, jparams, model, params = pair
    toks = tokens(model.cfg.vocab)
    jc = jax_cache(jmodel, jparams, B, MAX_SEQ)
    c = model.steady_decode_cache(params, model.init_cache(B, MAX_SEQ, "cpu"))
    step = jax.jit(jmodel.decode_step)
    for t in range(S):
        jl, jc = step(jparams, jc, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                      jnp.int32(t))
        with torch.no_grad():
            l, c = model.decode_step(params, c,
                                     torch.from_numpy(toks[:, t:t + 1]), t)
        assert rel_gap(to_np(l), jl) <= REL, t


def test_decode_lanes_at_their_own_positions(pair):
    """``decode_step_lanes``, lanes at positions 0, 3 and 7 apart, against
    the reference's vmapped ``decode_step_lanes``; lane 1 inactive every
    other step, masked on the reference's side as its engine masks
    (``where(active, new, old)`` in the old dtype) and kept bit for bit on
    the port's; active lanes' logits compared. The cache is f32 on both
    sides (bf16 K/V: one rounding apart, which reduced zamba2-1.2b
    amplifies)."""
    jmodel, jparams, model, params = pair
    toks = tokens(model.cfg.vocab, batch=3)
    starts = np.array([0, 3, 7])
    jc = jmodel.steady_decode_cache(jparams, jax_init_from_specs(
        jmodel.cache_specs(3, MAX_SEQ, dtype=jnp.float32),
        jax.random.PRNGKey(0)))
    c = cache_from_reference(jc)
    lanes_step = jax.jit(jmodel.decode_step_lanes)
    for i in range(6):
        pos = starts + i
        tok = toks[np.arange(3), pos][:, None]
        active = np.array([True, i % 2 == 0, True])
        jl, jnew = lanes_step(jparams, jc, jnp.asarray(tok, jnp.int32),
                              jnp.asarray(pos, jnp.int32))
        jc = jax.tree.map(
            lambda n, o: jnp.where(jnp.asarray(active).reshape(
                (1, -1) + (1,) * (n.ndim - 2)), n, o).astype(o.dtype), jnew, jc)
        before = {k: v.clone() for k, v in c.items()}
        with torch.no_grad():
            l, new = model.decode_step_lanes(params, c, torch.from_numpy(tok),
                                             torch.from_numpy(pos),
                                             torch.from_numpy(active))
        c = {k: new[k].to(c[k].dtype) for k in c}
        # an inactive lane's logits are garbage on both sides, and unused
        assert rel_gap(to_np(l)[active], np.asarray(jl)[active]) <= REL, i
        if not active[1]:
            for k in c:
                assert torch.equal(c[k][:, 1], before[k][:, 1]), (i, k)
    with pytest.raises(ValueError, match="one a lane"):
        model.decode_step_lanes(params, c, torch.from_numpy(tok),
                                torch.from_numpy(pos[:2]))


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("f32", [True, False])
def test_steady_decode_cache_dtypes_and_abstract_cache(arch, f32):
    jcfg, cfg = configs(arch)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          dtype=jnp.float32 if f32 else None)
    params = params_from_reference(np_tree(jparams) if f32
                                   else bits_tree(jparams), "cpu")
    want = jax_cache(jmodel, jparams, 2, 8)
    got = model.steady_decode_cache(params, model.init_cache(2, 8, "cpu"))
    assert {k: str(v.dtype).split(".")[1] for k, v in got.items()} == \
        {k: jnp.dtype(v.dtype).name for k, v in want.items()}
    abstract = model.abstract_cache(2, 8)
    jabstract = jmodel.abstract_cache(2, 8)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[1], v.device.type)
            for k, v in abstract.items()} == \
        {k: (tuple(v.shape), jnp.dtype(v.dtype).name, "meta")
         for k, v in jabstract.items()}


def test_lane_helpers_match_reference():
    jcfg, cfg = configs("zamba2-1.2b")
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    rng = np.random.default_rng(4)
    jc = jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape), s.dtype),
        jmodel.abstract_cache(3, 6))
    c = cache_from_reference(jc)
    for lane in (0, 2):
        assert plain(np_tree(jax_model.cache_lane(jc, lane))) == plain(
            np_tree(_as_reference(cache_lane(c, lane))))
    one = cache_lane(c, 0)
    set_cache_lane(c, one, 1)
    jc = jax_model.set_cache_lane(jc, jax_model.cache_lane(jc, 0), 1)
    zero_cache_lane(c, 2)
    jc = jax_model.zero_cache_lane(jc, 2)
    assert plain(np_tree(jc)) == plain(np_tree(_as_reference(c)))
    assert model.cfg.family == "hybrid"


# ---------------------------------------------------------------------------
# chunked prefill and greedy generation
# ---------------------------------------------------------------------------

def _prompts(vocab, batch, length, seed=1):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                         (batch, length), 0, vocab))


@pytest.mark.parametrize("arch,f32", [(a, True) for a in FAMILIES]
                         + [("qwen3-0.6b", False)])
def test_greedy_tokens_identical_to_reference(arch, f32):
    """``tests/test_serving.py::TestChunkedPrefill``'s seeds: the port's
    chunked ``greedy_generate`` (chunks 1, 4, 8) and its token-by-token loop
    give the reference loop's tokens."""
    jcfg, cfg = configs(arch)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          dtype=jnp.float32 if f32 else None)
    params = params_from_reference(np_tree(jparams) if f32
                                   else bits_tree(jparams), "cpu")
    prompts = _prompts(jcfg.vocab, 2, 9)
    want = np.asarray(jax_serve.greedy_generate_reference(
        jmodel, jparams, jnp.asarray(prompts), 6, 24))
    with torch.no_grad():
        got = serve.greedy_generate_reference(model, params, prompts, 6, 24)
        np.testing.assert_array_equal(got.numpy(), want)
        for chunk in (1, 4, 8):
            got = serve.greedy_generate(model, params, prompts, 6, 24,
                                        prefill_chunk=chunk)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"chunk={chunk}")


def test_zero_max_new_and_oracle_logits():
    jcfg, cfg = configs("qwen3-0.6b")
    model = build_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)
    prompts = _prompts(cfg.vocab, 1, 5)
    with torch.no_grad():
        out = serve.greedy_generate(model, params, prompts, 0, 16)
        np.testing.assert_array_equal(out.numpy(), prompts)
        logits = []
        out = serve.greedy_generate_reference(model, params, prompts, 3, 16,
                                              logits=logits)
    assert len(logits) == 3
    np.testing.assert_array_equal(
        out[:, 5:].numpy(),
        torch.stack([lg.argmax(-1) for lg in logits], 1).numpy())


# ---------------------------------------------------------------------------
# the continuous-batching engine
# ---------------------------------------------------------------------------

def engines(arch, **kw):
    """The reference's engine and the port's on the same f32 weights."""
    jcfg, cfg = configs(arch)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    params = params_from_reference(np_tree(jparams), "cpu")
    return {"ref": (jax_serve, jax_serve.ServingEngine(jmodel, jparams, **kw)),
            "port": (serve, serve.ServingEngine(model, params, **kw))}


def engine_view(engine, reqs):
    return plain({"tokens": [r.tokens for r in reqs],
                  "clocks": [(r.submit_clock, r.first_token_clock,
                              r.done_clock, r.ttft_clock, r.tpot_clock,
                              r.truncated) for r in reqs],
                  "clock": engine.clock, "steps": engine.decode_steps,
                  "counts": (engine.compile_count,
                             engine.prefill_compile_count,
                             engine.aux_compile_count),
                  "finished": [r.id for r in engine.finished]})


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-1.2b", "rwkv6-7b"])
def test_lane_reuse_identical_to_reference_and_solo(arch):
    """5 staggered requests on 3 lanes: tokens, clocks and counts equal the
    reference engine's, and each request's tokens equal its solo
    generation."""
    out = {}
    for side, (mod, engine) in engines(arch, max_batch=3, max_seq=32,
                                       prefill_chunk=4).items():
        rng = np.random.default_rng(3)
        reqs = [mod.Request(id=i, prompt=rng.integers(
            0, engine.model.cfg.vocab, size=5 + i, dtype=np.int32),
            max_new=6, arrival=3 * i) for i in range(5)]
        with torch.no_grad():
            mod.serve_requests(engine, reqs)
        assert mod.audit_serving_engine(engine) == []
        assert engine.compile_count == 1
        out[side] = engine_view(engine, reqs)
        if side == "port":
            with torch.no_grad():
                for req in reqs:
                    solo = serve.greedy_generate(
                        engine.model, engine.params, req.prompt[None, :],
                        req.max_new, 32, prefill_chunk=4)
                    np.testing.assert_array_equal(
                        np.asarray(req.tokens),
                        solo[0, len(req.prompt):].numpy(),
                        err_msg=f"request {req.id} diverged from solo")
    assert out["port"] == out["ref"]


def test_eos_retires_and_lane_is_reused():
    out = {}
    for side, (mod, engine) in engines("zamba2-1.2b", max_batch=1, max_seq=32,
                                       prefill_chunk=4).items():
        rng = np.random.default_rng(9)
        vocab = engine.model.cfg.vocab
        a = mod.Request(id=0, prompt=rng.integers(0, vocab, size=6,
                                                  dtype=np.int32), max_new=20)
        with torch.no_grad():
            mod.serve_requests(engine, [a], max_steps=4)
            mod.serve_requests(engine, [])
            b = mod.Request(id=1, prompt=rng.integers(0, vocab, size=6,
                                                      dtype=np.int32),
                            max_new=6)
            mod.serve_requests(engine, [b])
            # the second token of b as an EOS: a third request stops there
            c = mod.Request(id=2, prompt=b.prompt, max_new=6,
                            eos_token=b.tokens[1])
            mod.serve_requests(engine, [c])
        eos = b.tokens[1]
        assert c.tokens == b.tokens[:b.tokens.index(eos) + 1]
        assert mod.audit_serving_engine(engine) == []
        out[side] = engine_view(engine, [a, b, c])
    assert out["port"] == out["ref"]


def test_continuous_vs_static_clocks_identical_to_reference():
    clocks = {}
    for static in (False, True):
        for side, (mod, engine) in engines("qwen3-0.6b", max_batch=3,
                                           max_seq=32,
                                           prefill_chunk=4).items():
            rng = np.random.default_rng(11)
            reqs = [mod.Request(id=i, prompt=rng.integers(
                0, engine.model.cfg.vocab, size=6, dtype=np.int32),
                max_new=int(rng.integers(2, 13)), arrival=(i // 3) * 6)
                for i in range(9)]
            with torch.no_grad():
                mod.serve_requests(engine, reqs, static=static)
            assert len(engine.finished) == 9 and engine.compile_count == 1
            clocks[side, static] = (engine_view(engine, reqs), engine.clock)
        assert clocks["port", static] == clocks["ref", static]
    assert clocks["port", False][1] < clocks["port", True][1]


def test_audit_fires_on_corruption():
    jcfg, cfg = configs("qwen3-0.6b")
    model = build_model(cfg)
    engine = serve.ServingEngine(model, model.init(0, device="cpu",
                                                   dtype=torch.float32),
                                 max_batch=2, max_seq=32, prefill_chunk=4)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        serve.serve_requests(engine, [serve.Request(
            id=0, prompt=rng.integers(0, cfg.vocab, size=5), max_new=4)])
    assert serve.audit_serving_engine(engine) == []
    assert (engine.compile_count, engine.prefill_compile_count,
            engine.aux_compile_count) == (1, 1, 1)
    # built once each and run eagerly: nothing is captured on the CPU
    assert engine.graphs() == {"decode": None, "prefill": None, "zero": None}
    engine.compile_count = 2
    assert any("compile" in p for p in serve.audit_serving_engine(engine))
    engine.compile_count = 1
    engine.prefill_compile_count = 2
    assert any("prefill" in p for p in serve.audit_serving_engine(engine))
    engine.prefill_compile_count = 1
    engine.max_seq = 64
    assert any("fingerprint" in p or "static" in p
               for p in serve.audit_serving_engine(engine))
    engine.max_seq = 32
    req = engine.finished[0]
    engine.active[:] = True
    engine.positions[:] = 1
    engine.lane_req = [req, req]
    assert any("alias" in p for p in serve.audit_serving_engine(engine))
    engine.lane_req = [req, None]
    assert any("no request" in p for p in serve.audit_serving_engine(engine))
    engine.active[:] = False
    assert any("inactive lane 0" in p
               for p in serve.audit_serving_engine(engine))


def test_prompt_too_long_rejected():
    for side, (mod, engine) in engines("qwen3-0.6b", max_batch=1, max_seq=8,
                                       prefill_chunk=4).items():
        with pytest.raises(ValueError, match="cannot fit"):
            engine.submit(mod.Request(id=0, prompt=np.zeros(8, np.int32),
                                      max_new=2))


def test_engine_keeps_logits_of_named_requests():
    jcfg, cfg = configs("qwen3-0.6b")
    model = build_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)
    engine = serve.ServingEngine(model, params, max_batch=2, max_seq=32,
                                 prefill_chunk=4)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, size=7)
    engine.keep_logits[5] = []
    req = serve.Request(id=5, prompt=prompt, max_new=4)
    with torch.no_grad():
        serve.serve_requests(engine, [req, serve.Request(
            id=6, prompt=prompt[:3], max_new=2)])
        oracle = []
        serve.greedy_generate_reference(model, params, prompt[None, :], 4, 32,
                                        logits=oracle)
    kept = engine.keep_logits[5]
    assert len(kept) == 4 and 6 not in engine.keep_logits
    assert req.tokens == [int(lg.argmax()) for lg in kept]
    for got, want in zip(kept, oracle):
        assert rel_gap(to_np(got), to_np(want[0])) <= REL


# ---------------------------------------------------------------------------
# serve jobs in GADGET's loop
# ---------------------------------------------------------------------------

def co_setup(side, *, weight=80.0, horizon=16, burst_start=6):
    """``tests/test_serving.py::_co_setup`` on either side, with the
    reference's f32 weights carried to the port's engine."""
    mod, engine = engines("qwen3-0.6b", max_batch=4, max_seq=32,
                          prefill_chunk=4)[side]
    srv, link, graph_t, job_t, inst_t, util, ns = (
        (Server, Link, SubstrateGraph, Job, DDLJSInstance, sqrt_utility, sched)
        if side == "port" else
        (JaxServer, JaxLink, JaxGraph, JaxJob, JaxInstance, jax_sqrt_utility,
         jax_sched))
    servers = [srv(i, 0, {"gpus": 2.0, "mem": 8.0}) for i in range(2)]
    links = []
    for s in servers:
        links += [link(s.node, "r0", 100.0), link("r0", s.node, 100.0)]
    graph = graph_t(servers, links, n_racks=1, n_core=0)
    train = job_t(id=0, arrival=0, max_workers=4,
                  demands={"gpus": 1.0, "mem": 1.0}, budgets={"gpus": 500.0},
                  bandwidth=5.0, zeta=1.0, utility=util(4.0))
    slo = ns.ServeSLO(ttft_slots=2, tpot_slots=1.0, weight=weight)
    job = ns.make_serve_job(1, arrival=burst_start, offered_tokens=800.0,
                            slo=slo, tokens_per_worker_slot=64.0,
                            max_workers=3, bandwidth=5.0)
    inst = inst_t(graph=graph, jobs=[train, job], horizon=horizon)
    stream = ns.DiurnalRequestStream(ns.RequestStreamConfig(
        job_id=1, start=burst_start, base_rate=2.0, burst_prob=0.6,
        burst_size=4, prompt_len=(4, 8), max_new=(3, 6), seed=7))
    backend = ns.ServingBackend({1: engine}, tokens_per_worker_slot=64.0)
    return ns, inst, stream, backend, engine, slo


def test_co_scheduled_run_identical_to_reference():
    """The burst reclaims workers from the training ring and hands them
    back; under the sanitizer (SLO attainment against the log every slot)
    the event log, ``z``, slot records and backend reports are the
    reference's."""
    runs = {}
    for side in ("ref", "port"):
        ns, inst, stream, backend, engine, slo = co_setup(side)
        with torch.no_grad():
            res = ns.OnlineDriver(inst, events=stream, backend=backend,
                                  sanitize=True).run("gadget")
        att = ns.slo_attainment_from_events(res.events, 1, slo)
        assert backend.reports[-1]["slo_attainment"] == att
        assert engine.compile_count == 1
        runs[side] = (res, backend)
    res, backend = runs["port"]
    assert plain(res.events) == plain(runs["ref"][0].events)
    assert plain(dict(res.state.z)) == plain(dict(runs["ref"][0].state.z))
    assert plain(res.records) == plain(runs["ref"][0].records)
    assert plain(backend.reports) == plain(runs["ref"][1].reports)
    per = {0: dict.fromkeys(range(16), 0), 1: dict.fromkeys(range(16), 0)}
    for e in res.events:
        if isinstance(e, sched.EmbeddingCommitted):
            per[e.job_id][e.t] += e.n_workers
    assert all(per[0][t] == 4 and per[1][t] == 0 for t in range(6))
    assert min(per[0][t] for t in range(6, 16)) <= 2
    assert max(per[1][t] for t in range(6, 16)) >= 2
    assert per[0][15] == 4
    assert any(isinstance(e, sched.RequestFirstToken) for e in res.events)
    assert any(isinstance(e, sched.RequestCompletion) for e in res.events)


def test_sanitizer_catches_attainment_misreport():
    for side, err in (("port", SanitizerError), ("ref", JaxSanitizerError)):
        ns, inst, stream, backend, engine, slo = co_setup(side)

        class Misreporting:
            name = "misreporting"

            def execute_slot(self, decision, execution):
                out = backend.execute_slot(decision, execution)
                for row in out.measured.values():
                    if "slo_attainment" in row:
                        row["slo_attainment"] = 0.123  # lie about the SLO
                return out

        with torch.no_grad(), pytest.raises(err, match="slo_attainment"):
            ns.OnlineDriver(inst, events=stream, backend=Misreporting(),
                            sanitize=True).run("gadget")


def test_sanitizer_needs_an_slo_for_a_reported_attainment():
    ns, inst, stream, backend, engine, slo = co_setup("port")
    inst.jobs[1] = Job(**{f.name: getattr(inst.jobs[1], f.name)
                          for f in dataclasses.fields(Job)})
    with torch.no_grad(), pytest.raises(SanitizerError, match="carries no SLO"):
        ns.OnlineDriver(inst, events=stream, backend=backend,
                        sanitize=True).run("gadget")


def test_training_only_fleet_unaffected():
    out = {}
    for side in ("ref", "port"):
        srv, link, graph_t, job_t, inst_t, util, ns = (
            (Server, Link, SubstrateGraph, Job, DDLJSInstance, sqrt_utility,
             sched) if side == "port" else
            (JaxServer, JaxLink, JaxGraph, JaxJob, JaxInstance,
             jax_sqrt_utility, jax_sched))
        servers = [srv(i, 0, {"gpus": 2.0, "mem": 8.0}) for i in range(2)]
        links = []
        for s in servers:
            links += [link(s.node, "r0", 100.0), link("r0", s.node, 100.0)]
        graph = graph_t(servers, links, n_racks=1, n_core=0)
        jobs = [job_t(id=i, arrival=i, max_workers=3,
                      demands={"gpus": 1.0, "mem": 1.0},
                      budgets={"gpus": 30.0}, bandwidth=5.0, zeta=1.0,
                      utility=util(2.0 + i)) for i in range(3)]
        inst = inst_t(graph=graph, jobs=jobs, horizon=10)
        base = ns.OnlineDriver(inst).run("gadget")
        served = ns.OnlineDriver(inst, backend=ns.ServingBackend({})
                                 ).run("gadget")
        assert plain(base.events) == plain(served.events)
        assert plain(dict(base.state.z)) == plain(dict(served.state.z))
        assert plain(base.records) == plain(served.records)
        out[side] = plain((served.events, dict(served.state.z)))
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("utility_case", ["front_loaded", "tighter_ttft"])
def test_serve_job_utility_identical(utility_case):
    grid = (0.0, 32.0, 64.0, 500.0, 1000.0)
    views = []
    for ns in (sched, jax_sched):
        if utility_case == "front_loaded":
            job = ns.make_serve_job(3, arrival=0, offered_tokens=500.0,
                                    slo=ns.ServeSLO(ttft_slots=2),
                                    tokens_per_worker_slot=32.0)
        else:
            job = ns.make_serve_job(1, arrival=0, offered_tokens=500.0,
                                    slo=ns.ServeSLO(ttft_slots=8))
        views.append(plain((job.budgets, job.zeta, job.worker_time_budget(),
                            [job.utility(k) for k in grid],
                            [job.utility.marginal(k, 64.0) for k in grid])))
    assert views[0] == views[1]
    prompt = sched.serving.synth_prompt(7, 3, 11, 512)
    np.testing.assert_array_equal(
        prompt, jax_sched.serving.synth_prompt(7, 3, 11, 512))


# ---------------------------------------------------------------------------
# the source of the card's limits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-7b", "zamba2-1.2b",
                                  MAMBA2])
def test_reference_forward_decode_gap_is_the_cards_source(arch):
    """The reference's own gap between its training forward and its decode
    (bf16 cache; 2 sequences of 64 tokens; every position) at reduced
    size, and the port's on the CPU: ``chip_smoke.SERVE_REF_GAP`` records
    the reference's, and the port's is within it."""
    smoke = _smoke()
    jcfg, cfg = configs(arch)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    params = params_from_reference(np_tree(jparams), "cpu")
    seq = 64
    toks = tokens(jcfg.vocab, length=seq)
    fwd = np.asarray(jmodel.forward(jparams, {"tokens": jnp.asarray(
        toks, jnp.int32)})[0])
    jc = jax_cache(jmodel, jparams, B, seq)
    step = jax.jit(jmodel.decode_step)
    dec = []
    for t in range(seq):
        logits, jc = step(jparams, jc, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                          jnp.int32(t))
        dec.append(np.asarray(logits)[:, 0])
    ref_gap = rel_gap(np.stack(dec, 1), fwd)
    with torch.no_grad():
        pfwd = model.forward(params, {"tokens": torch.from_numpy(toks)})[0]
        c = model.steady_decode_cache(params, model.init_cache(B, seq, "cpu"))
        pdec = []
        for t in range(seq):
            logits, c = model.decode_step(params, c,
                                          torch.from_numpy(toks[:, t:t + 1]), t)
            pdec.append(logits[:, 0])
    port_gap = rel_gap(to_np(torch.stack(pdec, 1)), to_np(pfwd))
    recorded = smoke.SERVE_REF_GAP[arch]
    print(f"{arch}: the reference's forward-vs-decode gap {ref_gap:.4g}, "
          f"the port's {port_gap:.4g}, recorded {recorded}")
    assert recorded / 2 < ref_gap <= recorded
    if arch != "zamba2-1.2b":  # chaotic at random init: printed, not held
        assert port_gap <= recorded
    assert smoke.SERVE_GAP_FACTOR > 1
