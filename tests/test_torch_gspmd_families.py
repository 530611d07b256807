"""The GSPMD path of the MoE, encoder-decoder, RWKV6 and Mamba2/Zamba2
families: their steps on DTensors against the same steps on plain tensors,
and the plain steps against the reference's.

On DTensors (``_mesh_rank``, this file run as a script: eight gloo
processes on the CPU, a 2x4 ("data", "model") mesh, ``activate(rules)``),
three steps of ``make_train_step`` on each reduced config of
:data:`CASES`, each against the same three steps on plain tensors:

  * phi3.5-moe-42b at the full config's capacity factor 1.25 with a skewed
    router (every token's embedding shares a direction that the router's
    expert 0 reads, and the router is scaled up so that no gate sits within
    rounding of a tie), under the default layout (experts over "model")
    and under ``moe_tp`` (their hidden dim over "model"); tokens are
    dropped, and the mesh drops exactly the plain step's (every kept
    (token, expert) of every MoE call of the first step, gathered over the
    ranks);
  * arctic-480b (its dense residual MLP, Adafactor), whisper-large-v3
    (FSDP and sequence parallelism, as its config), rwkv6-7b and
    zamba2-1.2b (FSDP, as theirs).

The mesh runs B4, B8 and B9 through their plain versions shard by shard,
and so does the plain step here (:func:`mesh_kernels`, in place of
``attention_reference``, ``wkv6_chunked`` and ``ssd_chunked``): the two
differ in their layout alone, the mesh summing partial products across
shards. Each step's loss and ``grad_norm`` are held within rtol
``METRIC_TOL`` and every parameter and optimizer-state leaf within
``MESH_TOL`` (1e-3, ``tests/test_torch_gspmd_step.py``'s limit without
qk-norm: none of these configs has it) of its largest value, after the
three steps. Measured: at most 2.5e-5 (phi3.5-moe, ``mom/wk``), 1.9e-5
(``moe_tp``), 7.6e-5 (arctic, Adafactor's ``vr`` of ``wk``), 1.6e-5
(whisper), 7.8e-6 (rwkv6), 1.0e-5 (zamba2).

Two properties of the reduced models at random init would hide the mesh
behind noise, and the inputs are set against them. Reduced whisper and
zamba2 turn one f32 rounding into gradient gaps of 3e-3 of a leaf's
largest value (the attention form alone, reference or blockwise, moves
whisper's by 2.2e-3; f32 against f64 by 1.7e-2), so their attention's
query and key weights are scaled by ``CALM`` (measured with them: 3e-6).
AdamW's first steps move an element by about lr times the sign of its
gradient, so an element whose gradient is within rounding of 0 moves by
up to 2 lr either way and the next steps' gradients follow (zamba2's
momenta 1.4e-3 apart after three steps): the steps take SGD-momentum,
arctic its Adafactor. A near-uniform router flips top-k choices on
rounding (arctic's Adafactor statistics 5e-2 apart after three steps), so
both MoE configs take the skewed router.

The same ranks then run each family's prefill (the forward alone under
the dry run's prefill layout: sequence parallelism) and
``DECODE_STEPS`` ``decode_step``s into an f32 cache, lanes at different
positions, some inactive on some steps, against plain ``forward`` and
``decode_step``: logits and the final cache within ``MESH_TOL`` of their
largest value (bf16 leaves beyond one bf16 ulp of each element). Measured:
at most 1.3e-6 (prefill logits); the bf16 shift states of RWKV6 within
one ulp since the decode step reduces the residual's partial sums before
it casts them (7.3e-3 of their largest value, five ulps, before).

Against the reference (in this process): the plain step of each case from
the reference's own weights (``params_from_reference``, the skew applied
to both) against ``repro.training.train_step.make_train_step``'s, three
steps, each loss within rtol ``REF_LOSS_TOL`` (1e-5, the models' loss
limit against the reference in ``tests/test_torch_model.py``; measured at
most 4.3e-7, whisper).
"""

import contextlib
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.rwkv6_wkv import wkv6
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import layers as L
from repro_torch.models import rwkv, ssm
from repro_torch.models.model import build_model
from repro_torch.models.module import _flatten
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_step import make_train_step

SEQ, BATCH, STEPS = 64, 8, 3
LR = {"sgdm": 1e-2, "adafactor": 1e-3}
MESH_TOL, METRIC_TOL, REF_LOSS_TOL = 1e-3, 1e-5, 1e-5
# name -> (arch, config fields, layout flags). SGD-momentum but for arctic
# (Adafactor, as its config): AdamW's first steps move an element by about
# lr times the sign of its gradient, so a gradient within rounding of 0
# moves it by up to 2 lr either way, and the next steps' gradients follow
CASES = {
    "phi3.5-moe": ("phi3.5-moe-42b", {"moe_capacity": 1.25, "optimizer": "sgdm"},
                   {}),
    "phi3.5-moe-tp": ("phi3.5-moe-42b", {"moe_capacity": 1.25, "optimizer": "sgdm"},
                      {"moe_tp": True}),
    "arctic": ("arctic-480b", {}, {"fsdp": True}),
    "whisper": ("whisper-large-v3", {"optimizer": "sgdm"},
                {"fsdp": True, "sequence_parallel": True}),
    "rwkv6": ("rwkv6-7b", {"optimizer": "sgdm"}, {"fsdp": True}),
    "zamba2": ("zamba2-1.2b", {"optimizer": "sgdm"}, {"fsdp": True}),
}
SKEWED = ("phi3.5-moe", "phi3.5-moe-tp", "arctic")
DROPPING = ("phi3.5-moe", "phi3.5-moe-tp")
# the skew: the shared direction's weight in every embedding, the router's
# scale, the router's expert-0 weight on the direction
SKEW = (1.0, 10.0, 10.0)
# the families' prefill and decode cases
SERVED = ("phi3.5-moe", "arctic", "whisper", "rwkv6", "zamba2")
DECODE_BATCH, CACHE_LEN, DECODE_STEPS = 4, 16, 4
DECODE_START = (0, 3, 5, 2)      # each lane's first position
MESH = (2, 4)


def case_config(name: str):
    arch, fields, _ = CASES[name]
    return dataclasses.replace(get_arch(arch).reduced(), **fields)


def skew(params: dict, seed: int = 11) -> dict:
    """A direction every token's embedding shares, read by the router's
    expert 0, and the router scaled up: the skewed router of
    ``tests/test_torch_moe.py`` in a model."""
    blocks = params["blocks"]
    d = params["embed"].shape[-1]
    u = torch.from_numpy(np.random.default_rng(seed).standard_normal(d)
                         .astype(np.float32))
    u /= u.norm()
    out = dict(params, embed=params["embed"] + SKEW[0] * u,
               blocks=dict(blocks, router=blocks["router"] * SKEW[1]))
    out["blocks"]["router"][:, :, 0] += SKEW[2] * u
    return out


# the attentions whose query and key weights are scaled by CALM
CALMED = {"whisper": (("enc_blocks", "wq"), ("enc_blocks", "wk"),
                      ("dec_blocks", "wq"), ("dec_blocks", "wk"),
                      ("dec_blocks", "xq"), ("dec_blocks", "xk")),
          "zamba2": (("shared_attn", "wq"), ("shared_attn", "wk"))}
CALM = 0.1


def calm(params: dict, leaves) -> dict:
    """The attention scores scaled by ``CALM ** 2``: reduced whisper and
    zamba2 at random init turn one f32 rounding into gradient gaps of 3e-3
    of a leaf's largest value (module docstring)."""
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in params.items()}
    for block, w in leaves:
        out[block][w] = out[block][w] * CALM
    return out


def initial(name: str, model) -> dict:
    params = model.init(0, device="cpu", dtype=torch.float32)
    if name in CALMED:
        params = calm(params, CALMED[name])
    return skew(params) if name in SKEWED else params


def make_batch(cfg, model, seq: int, batch: int, step: int = 0) -> dict:
    """Tokens and labels of the pipeline, and a modality's stub inputs
    (whisper's frames) from a seeded normal."""
    out = {k: torch.from_numpy(v) for k, v in
           SyntheticTokens(cfg.vocab, seq, batch, seed=3).batch(step).items()}
    rng = np.random.default_rng(100 + step)
    for k, v in model.extra_input_specs(batch).items():
        out[k] = torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
    return out


def decode_inputs(cfg):
    """Each decode step's ``(tokens (B, 1), positions (B,), active (B,) or
    None)``: lane 2 inactive on step 1, lanes 0 and 3 on step 2."""
    rng = np.random.default_rng(7)
    inactive = {1: (2,), 2: (0, 3)}
    out = []
    for t in range(DECODE_STEPS):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (DECODE_BATCH, 1),
                                               dtype=np.int32))
        cur = torch.tensor(DECODE_START) + t
        active = None
        if t in inactive:
            active = torch.ones(DECODE_BATCH, dtype=torch.bool)
            active[list(inactive[t])] = False
        out.append((tokens, cur, active))
    return out


def to_np(t: torch.Tensor) -> np.ndarray:
    """A tensor's values, bf16 widened to f32 (numpy has no bf16)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class KeptRecorder:
    """Wraps ``layers._assign`` to record, for every MoE call, the (global
    token, expert) pairs each call keeps: ``token_offset`` is the global
    index of this process's first token."""

    def __init__(self, token_offset: int = 0):
        self.calls, self.offset, self._assign = [], token_offset, L._assign

    def __enter__(self):
        def assign(gate_ids, **kw):
            order, slot = self._assign(gate_ids, **kw)
            dump = kw["el"] * kw["slots"]
            t, k = gate_ids.shape
            tokens = torch.arange(t)[:, None].expand(t, k).reshape(-1)[order]
            experts = gate_ids.reshape(-1)[order]
            kept = slot != dump
            self.calls.append(sorted(zip((tokens[kept] + self.offset).tolist(),
                                         experts[kept].tolist())))
            return order, slot

        L._assign = assign
        return self

    def __exit__(self, *exc):
        L._assign = self._assign


@contextlib.contextmanager
def mesh_kernels():
    """The plain step's attention, WKV and SSD through B4's, B8's and B9's
    operators (their plain versions on the CPU), as the mesh runs them
    shard by shard, in place of ``attention_reference``, ``wkv6_chunked``
    and ``ssd_chunked``: the two runs then differ in their layout alone."""
    saved = L.attention, rwkv.wkv6_chunked, ssm.ssd_chunked

    def attention(q, k, v, *, causal=True, window=None, q_offset=0, chunk=1024):
        assert q_offset == 0
        return fa.flash_attention(q, k, v, causal=causal, window=window)

    def wkv(r, k, v, logw, u, initial_state=None):
        assert initial_state is None
        return wkv6(r, k, v, logw, u), None

    def ssd(x, dt, A, Bm, Cm, chunk, initial_state=None):
        assert initial_state is None
        return ssd_scan(x, dt, A, Bm, Cm), None

    L.attention, rwkv.wkv6_chunked, ssm.ssd_chunked = attention, wkv, ssd
    try:
        yield
    finally:
        L.attention, rwkv.wkv6_chunked, ssm.ssd_chunked = saved


def plain_steps(name: str) -> dict:
    """The case's three plain steps: each step's metrics, the final
    parameters and optimizer state, and (MoE) the kept pairs of step 0."""
    cfg = case_config(name)
    model = build_model(cfg)
    opt = make_optimizer(cfg.optimizer)
    params = initial(name, model)
    state = opt.init(params)
    step = make_train_step(model, opt, lr=LR[cfg.optimizer])
    out = {}
    for t in range(STEPS):
        with KeptRecorder() as rec, mesh_kernels():
            params, state, m = step(params, state, make_batch(cfg, model, SEQ, BATCH, t))
        if t == 0:
            out["kept"] = rec.calls
        for k, v in m.items():
            out[f"metrics{t}/{k}"] = float(v)
    out.update({path: to_np(v) for path, v in
                _flatten({"params": params, "state": state})})
    return out


def plain_served(name: str):
    """The family's prefill logits, each decode step's logits and the final
    cache, on plain tensors; and the names of the bf16 leaves."""
    cfg = case_config(name)
    model = build_model(cfg)
    params = initial(name, model)
    out = {}
    with torch.no_grad(), mesh_kernels():
        out["prefill"] = model.forward(params, make_batch(cfg, model, SEQ, BATCH))[0]
        cache = {k: torch.zeros(s.shape) for k, s in
                 model.cache_specs(DECODE_BATCH, CACHE_LEN).items()}
        for t, (tokens, cur, active) in enumerate(decode_inputs(cfg)):
            out[f"logits{t}"], cache = model.decode_step(params, cache, tokens,
                                                         cur, active)
    out.update({f"cache_{k}": v for k, v in cache.items()})
    bf16 = {k for k, v in out.items() if v.dtype == torch.bfloat16}
    return {k: to_np(v) for k, v in out.items()}, bf16


# -- the mesh side: eight gloo processes ----------------------------------------

def _mesh_rank(rank: int, port: int, out: str) -> None:
    """One of the eight gloo ranks: every case on the 2x4 mesh; rank 0
    writes the full tensors of the outputs (and every rank's kept pairs,
    gathered) to ``out``."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.dist.sharding import activate, make_rules, param_shardings
    from repro_torch.launch.dryrun import _redistribute, opt_state_shardings
    from repro_torch.launch.mesh import make_dev_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=8)
    mesh = make_dev_mesh(*MESH)
    data_coord = mesh.get_coordinate()[0]
    results, kept = {}, {}

    def on_mesh(tree, placements):
        if isinstance(tree, dict):
            return {k: on_mesh(v, placements[k]) for k, v in tree.items()}
        return distribute_tensor(tree, mesh, list(placements))

    def full(v):
        return to_np(v.full_tensor() if isinstance(v, DTensor) else v)

    def rows(batch, rules):
        return {k: distribute_tensor(v, mesh, list(rules.placements_for(
            ("batch",) + (None,) * (v.dim() - 1)))) for k, v in batch.items()}

    for name, (_, _, layout) in CASES.items():
        cfg = case_config(name)
        model = build_model(cfg)
        opt = make_optimizer(cfg.optimizer)
        rules = make_rules(mesh, **layout)
        specs = model.param_specs()
        params = initial(name, model)
        psh = param_shardings(rules, specs)
        osh = opt_state_shardings(cfg.optimizer, rules, specs)
        p, s = on_mesh(params, psh), on_mesh(opt.init(params), osh)
        step = make_train_step(model, opt, lr=LR[cfg.optimizer])
        for t in range(STEPS):
            b = rows(make_batch(cfg, model, SEQ, BATCH, t), rules)
            offset = data_coord * (BATCH // MESH[0]) * SEQ
            with activate(rules), KeptRecorder(offset) as rec:
                p, s, m = step(p, s, b)
            # the next step takes the layout the step started from, as the
            # dry run's cells return it
            p, s = _redistribute(p, psh), _redistribute(s, osh)
            if t == 0:
                kept[name] = rec.calls
            for k, v in m.items():
                results[f"{name}/metrics{t}/{k}"] = full(v)
        for path, v in _flatten({"params": p, "state": s}):
            results[f"{name}/{path}"] = full(v)
    for name in SERVED:
        cfg = case_config(name)
        model = build_model(cfg)
        specs = model.param_specs()
        params = initial(name, model)
        rules = make_rules(mesh, fsdp=cfg.fsdp, sequence_parallel=True)
        with activate(rules), torch.no_grad():
            logits, _ = model.forward(on_mesh(params, param_shardings(rules, specs)),
                                      rows(make_batch(cfg, model, SEQ, BATCH), rules))
        results[f"served/{name}/prefill"] = full(logits)
        rules = make_rules(mesh, fsdp=cfg.fsdp)
        p = on_mesh(params, param_shardings(rules, specs))
        cache_specs = model.cache_specs(DECODE_BATCH, CACHE_LEN)
        cache = on_mesh({k: torch.zeros(s.shape) for k, s in cache_specs.items()},
                        param_shardings(rules, cache_specs))
        for t, (tokens, cur, active) in enumerate(decode_inputs(cfg)):
            tok = distribute_tensor(tokens, mesh,
                                    list(rules.placements_for(("batch", None))))
            with activate(rules), torch.no_grad():
                logits, cache = model.decode_step(p, cache, tok, cur, active)
            results[f"served/{name}/logits{t}"] = full(logits)
        for k, v in cache.items():
            results[f"served/{name}/cache_{k}"] = full(v)
    every = [None] * 8
    dist.all_gather_object(every, kept)
    if rank == 0:
        for name in DROPPING:
            calls = zip(*(r[name] for r in every))
            for i, call in enumerate(calls):
                pairs = np.array(sorted(set().union(*map(set, map(tuple, call)))))
                results[f"{name}/kept{i}"] = pairs.reshape(-1, 2)
        np.savez(out, **results)
    dist.barrier()
    dist.destroy_process_group()


def _mesh_side(out: str) -> None:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.multiprocessing.start_processes(_mesh_rank, args=(port, out), nprocs=8,
                                          start_method="fork")


@pytest.fixture(scope="module", autouse=True)
def mesh_proc(tmp_path_factory):
    """The mesh side, started before the file's first test."""
    out = str(tmp_path_factory.mktemp("gspmd_families") / "mesh.npz")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, __file__, out], env=env)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def mesh_run(mesh_proc):
    proc, out = mesh_proc
    assert proc.wait(timeout=900) == 0
    return dict(np.load(out))


def of_case(run: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in run.items()
            if k.startswith(prefix + "/")}


def leaf_gap(got: np.ndarray, want: np.ndarray, bf16: bool = False) -> float:
    """``max|got - want|`` over ``max|want|``; for a bf16 leaf, beyond one
    bf16 ulp of each element (two runs whose f32 values agree within
    rounding can round to neighbouring bf16 values)."""
    peak = float(np.abs(want).max())
    gap = np.abs(got.astype(np.float64) - want)
    if bf16:
        gap = np.maximum(gap - bf16_ulp(want), 0.0)
    return float(gap.max()) / (peak or 1.0)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp of each element: 2^(exponent - 7)."""
    return np.ldexp(1.0, np.frexp(np.abs(x).astype(np.float64))[1] - 8)


@pytest.mark.parametrize("name", list(CASES))
def test_step_on_2x4_mesh_equals_plain_step(mesh_run, name):
    cfg = case_config(name)
    want = plain_steps(name)
    got = of_case(mesh_run, name)
    for t in range(STEPS):
        for k in ("loss", "grad_norm"):
            path = f"metrics{t}/{k}"
            np.testing.assert_allclose(float(got[path]), want[path], rtol=METRIC_TOL,
                                       err_msg=path)
    leaves = [k for k in want if k.startswith(("params/", "state/"))]
    assert sorted(k for k in got if k.startswith(("params/", "state/"))) == sorted(leaves)
    for path in leaves:
        assert leaf_gap(got[path], want[path]) <= MESH_TOL, (path, leaf_gap(
            got[path], want[path]))


@pytest.mark.parametrize("name", DROPPING)
def test_moe_mesh_drops_the_plain_steps_tokens(mesh_run, name):
    cfg = case_config(name)
    want = plain_steps(name)["kept"]
    got = of_case(mesh_run, name)
    assert len(want) == cfg.n_layers
    assignments = BATCH * SEQ * cfg.top_k
    for i, pairs in enumerate(want):
        assert len(pairs) < assignments, "no token dropped: the test proves nothing"
        assert sorted(map(tuple, got[f"kept{i}"].tolist())) == pairs, i


@pytest.mark.parametrize("name", SERVED)
def test_prefill_and_decode_on_2x4_mesh_equal_plain(mesh_run, name):
    want, bf16 = plain_served(name)
    got = of_case(mesh_run, f"served/{name}")
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        gap = leaf_gap(got[path], w, bf16=path in bf16)
        assert gap <= MESH_TOL, (path, gap)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_step_matches_reference(name, monkeypatch):
    """The plain step from the reference's weights against the reference's
    ``make_train_step`` (jitted), three steps: each loss within rtol
    ``REF_LOSS_TOL``. The reference's SSD runs through its sequential
    oracle, as in ``tests/test_torch_ssm.py``: its ``ssd_chunked`` gives
    NaN gradients at init."""
    import jax
    import jax.numpy as jnp

    import repro.models.ssm as jax_ssm
    from test_torch_ssm import sequential_ssd
    from repro.configs import get_arch as jax_get_arch
    from repro.models.model import build_model as jax_build_model
    from repro.training.optimizer import make_optimizer as jax_make_optimizer
    from repro.training.train_step import make_train_step as jax_make_train_step
    from repro_torch.models.module import params_from_reference

    arch, fields, _ = CASES[name]
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced(), **fields)
    cfg = case_config(name)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                   dtype=jnp.float32))
    monkeypatch.setattr(jax_ssm, "ssd_chunked", sequential_ssd)
    params = params_from_reference(jparams, "cpu")
    if name in CALMED:
        params = calm(params, CALMED[name])
    if name in SKEWED:
        params = skew(params)
    jparams = jax.tree.map(lambda t: t.numpy(), params)
    jopt, opt = jax_make_optimizer(cfg.optimizer), make_optimizer(cfg.optimizer)
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, lr=LR[cfg.optimizer]))
    step = make_train_step(model, opt, lr=LR[cfg.optimizer])
    jparams = jax.tree.map(jnp.asarray, jparams)
    jstate, state = jopt.init(jparams), opt.init(params)
    for t in range(STEPS):
        batch = make_batch(cfg, model, SEQ, BATCH, t)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
        params, state, m = step(params, state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=REF_LOSS_TOL, err_msg=f"step {t}")


if __name__ == "__main__":
    _mesh_side(sys.argv[1])
