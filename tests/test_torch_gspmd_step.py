"""The port's GSPMD train step (``repro_torch.training.train_step.
make_train_step``, ``repro_torch.dist.overlap.microbatch_grads``) against
the reference's, and the step on DTensors against the step on plain
tensors.

Against the reference (both on the CPU in this process, f32, the
reference's own weights carried across by ``params_from_reference``):

  * ``microbatch_grads`` at 1, 2 and 4 microbatches on reduced qwen3-0.6b:
    the loss within rtol 1e-5 and every gradient leaf within rtol 1e-4 /
    atol 1e-6, ``test_torch_model``'s limits for this model (the two
    frameworks sum products in different orders); its two ``ValueError``s
    with the reference's text;
  * ``make_train_step`` on reduced qwen3-0.6b and internvl2-26b: AdamW for
    three steps, and SGD-momentum in 4 microbatches for three steps; each
    step's loss within rtol 1e-5, ``grad_norm`` within ``NORM_TOL`` and
    every parameter leaf after the last step within ``PARAM_TOL`` of its
    largest value. Reduced internvl2-26b has no qk-norm: as in
    ``test_torch_model``, its gradients are held to 1e-3 of their largest
    value, not 1e-4 (measured: ``grad_norm`` 5.3e-4 apart at step 3, the
    SGD-momentum parameters 8.8e-4 of a leaf's largest value; qwen3-0.6b
    1.3e-7 and 1.3e-7). AdamW's first steps move an element by about lr
    times the sign of its gradient, so an element whose gradient is within
    rounding of 0 can move by up to 2 lr either way: its limit adds 2 lr
    (measured: 3.5e-5 and 1.3e-3 of lr 1e-3).

On DTensors (``_mesh_side``, this file run as a script: eight gloo
processes on the CPU, a 2x4 ("data", "model") mesh, ``activate(rules)``):
reduced qwen3-0.6b under the default layout and under FSDP with sequence
parallelism in 2 microbatches, and reduced internvl2-26b under the
default layout, each against the same step on plain tensors. The mesh
step's attention runs flash attention's plain version shard by shard, the
plain step ``attention_reference``, and the mesh sums partial products
across shards: the loss and ``grad_norm`` are held within rtol 1e-5
(measured: 1.4e-6 at most), SGD-momentum's parameters and momenta and
AdamW's moments within ``MESH_TOL`` of each leaf's largest value: 1e-5 for
qwen3-0.6b (measured: 9.5e-7), 1e-3 for internvl2-26b, which has no
qk-norm (measured: 2.1e-5, its second moment of ``wv``).

The same gloo processes then serve reduced qwen3-0.6b on the mesh
(``DECODE_CASES``): a prefill, the forward alone under the dry run's
prefill layout (sequence parallelism: the logits split on the sequence),
then ``DECODE_STEPS`` ``decode_step``s into an f32 cache, the lanes at
different positions that cross the cache's sequence blocks, some lanes
inactive on some steps. The cases: kv heads (2) that do not divide the
4-way "model" axis, the same with the cache's sequence split over "model"
(the dry run's ``cache_seq_shard``), and 4 kv heads, which split as the q
heads do. Every step's logits and the final cache are held to plain
``forward`` and ``decode_step`` within ``MESH_TOL`` of their largest value,
the train-step cases' limit.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.dist.overlap import microbatch_grads as jax_microbatch_grads
from repro.models.model import build_model as jax_build_model
from repro.training.optimizer import make_optimizer as jax_make_optimizer
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import get_arch
from repro_torch.dist.overlap import microbatch_grads
from repro_torch.models.model import build_model
from repro_torch.models.module import _flatten, params_from_reference
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_step import make_train_step

ARCHS = ("qwen3-0.6b", "internvl2-26b")
SEQ, BATCH = 16, 8
LR = {"adamw": 1e-3, "sgdm": 1e-2}
# by qk-norm: the relative limits of grad_norm and of a parameter leaf
NORM_TOL = {True: 1e-4, False: 1e-3}
PARAM_TOL = {True: 1e-5, False: 1e-3}
MESH_TOL = {True: 1e-5, False: 1e-3}     # by qk-norm
# (arch, layout flags, optimizer, microbatches) of the 2x4 mesh cases
MESH_CASES = [("qwen3-0.6b", {}, "sgdm", 1),
              ("qwen3-0.6b", {"fsdp": True, "sequence_parallel": True}, "sgdm", 2),
              ("internvl2-26b", {}, "adamw", 1)]
# (kv heads, cache_seq_shard) of reduced qwen3-0.6b's decode cases on 2x4
DECODE_CASES = [(2, False), (2, True), (4, False)]
DECODE_BATCH, CACHE_LEN, DECODE_STEPS = 4, 16, 4
DECODE_START = (0, 3, 5, 2)      # each lane's first position


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def make_batch(cfg, seq: int, batch: int, step: int = 0) -> dict:
    """Tokens and labels of the reference's pipeline, and a VLM's patch
    embeddings from a seeded normal."""
    out = JaxTokens(cfg.vocab, seq, batch, seed=3).batch(step)
    if cfg.family == "vlm":
        rng = np.random.default_rng(step)
        out["patch_embeds"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def both_models(arch: str):
    jcfg = jax_get_arch(arch).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    model = build_model(get_arch(arch).reduced())
    return jcfg, jmodel, jparams, model, params_from_reference(np_tree(jparams), "cpu")


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def decode_model(n_kv_heads: int):
    import dataclasses

    cfg = dataclasses.replace(get_arch("qwen3-0.6b").reduced(),
                              n_kv_heads=n_kv_heads)
    return cfg, build_model(cfg)


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


def plain_decode(n_kv_heads: int) -> dict:
    """The decode case's prefill logits, each step's logits and the final
    cache, on plain tensors."""
    cfg, model = decode_model(n_kv_heads)
    params = model.init(0, device="cpu", dtype=torch.float32)
    out = {}
    with torch.no_grad():
        out["prefill"] = model.forward(params, to_torch(make_batch(cfg, SEQ * 2, BATCH)))[0]
        cache = {k: torch.zeros(s.shape) for k, s in
                 model.cache_specs(DECODE_BATCH, CACHE_LEN).items()}
        for t, (tokens, cur, active) in enumerate(decode_inputs(cfg)):
            out[f"logits{t}"], cache = model.decode_step(params, cache, tokens,
                                                         cur, active)
    out.update({f"cache_{k}": v for k, v in cache.items()})
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def qwen3():
    return both_models("qwen3-0.6b")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_microbatch_grads_match_reference(qwen3, n):
    jcfg, jmodel, jparams, model, params = qwen3
    batch = make_batch(jcfg, SEQ, BATCH)
    jloss, jgrads = jax_microbatch_grads(jmodel.loss, jparams,
                                         jax.tree.map(jnp.asarray, batch), n)
    loss, grads = microbatch_grads(model.loss, params, to_torch(batch), n)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = dict(_flatten(np_tree(jgrads)))
    got = dict(_flatten(grads))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path].numpy(), want[path], rtol=1e-4,
                                   atol=1e-6, err_msg=path)


@pytest.mark.parametrize("rows,n", [(2, 4), (6, 4)])
def test_microbatch_grads_errors_match_reference(qwen3, rows, n):
    jcfg, jmodel, jparams, model, params = qwen3
    batch = make_batch(jcfg, SEQ, rows)
    with pytest.raises(ValueError) as want:
        jax_microbatch_grads(jmodel.loss, jparams, jax.tree.map(jnp.asarray, batch), n)
    with pytest.raises(ValueError) as got:
        microbatch_grads(model.loss, params, to_torch(batch), n)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("opt_name,n_mb", [("adamw", 1), ("sgdm", 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, opt_name, n_mb):
    jcfg, jmodel, jparams, model, params = both_models(arch)
    lr = LR[opt_name]
    jopt, opt = jax_make_optimizer(opt_name), make_optimizer(opt_name)
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, lr=lr, n_microbatches=n_mb))
    step = make_train_step(model, opt, lr=lr, n_microbatches=n_mb)
    jstate, state = jopt.init(jparams), opt.init(params)
    for t in range(3):
        batch = make_batch(jcfg, SEQ, BATCH, t)
        jparams, jstate, jm = jstep(jparams, jstate, jax.tree.map(jnp.asarray, batch))
        params, state, m = step(params, state, to_torch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=NORM_TOL[jcfg.qk_norm])
    want = dict(_flatten(np_tree(jparams)))
    for path, p in _flatten(params):
        peak = float(np.abs(want[path]).max())
        tol = PARAM_TOL[jcfg.qk_norm] + (2 * lr / peak if opt_name == "adamw" else 0.0)
        gap = float(np.abs(p.numpy() - want[path]).max())
        assert gap <= tol * peak, (path, gap, peak)


# -- the step on DTensors over a 2x4 mesh ------------------------------------

def _mesh_rank(rank: int, port: int, out: str) -> None:
    """One of the eight gloo ranks: every case's step on the 2x4 mesh;
    rank 0 writes the full tensors of its outputs to ``out``."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.dist.sharding import activate, make_rules, param_shardings
    from repro_torch.launch.dryrun import opt_state_shardings
    from repro_torch.launch.mesh import make_dev_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=8)
    mesh = make_dev_mesh(2, 4)
    results = {}

    def on_mesh(tree, placements):
        if isinstance(tree, dict):
            return {k: on_mesh(v, placements[k]) for k, v in tree.items()}
        return distribute_tensor(tree, mesh, list(placements))

    def full(v):
        return (v.full_tensor() if isinstance(v, DTensor) else v).detach().numpy()

    for i, (arch, flags, opt_name, n_mb) in enumerate(MESH_CASES):
        cfg = get_arch(arch).reduced()
        model = build_model(cfg)
        opt = make_optimizer(opt_name)
        rules = make_rules(mesh, **flags)
        specs = model.param_specs()
        params = model.init(0, device="cpu", dtype=torch.float32)
        state = opt.init(params)
        batch = to_torch(make_batch(cfg, SEQ * 2, BATCH))
        p = on_mesh(params, param_shardings(rules, specs))
        s = on_mesh(state, opt_state_shardings(opt_name, rules, specs))
        b = {k: distribute_tensor(v, mesh, list(rules.placements_for(
            ("batch",) + (None,) * (v.dim() - 1)))) for k, v in batch.items()}
        step = make_train_step(model, opt, lr=LR[opt_name], n_microbatches=n_mb)
        with activate(rules):
            p, s, m = step(p, s, b)
        for path, v in _flatten({"params": p, "state": s, "metrics": m}):
            results[f"{i}/{path}"] = full(v)
    for i, (n_kv_heads, seq_shard) in enumerate(DECODE_CASES):
        cfg, model = decode_model(n_kv_heads)
        specs = model.param_specs()
        params = model.init(0, device="cpu", dtype=torch.float32)
        # the prefill: the forward alone, under the dry run's prefill layout
        rules = make_rules(mesh, sequence_parallel=True)
        batch = to_torch(make_batch(cfg, SEQ * 2, BATCH))
        b = {k: distribute_tensor(v, mesh, list(rules.placements_for(
            ("batch",) + (None,) * (v.dim() - 1)))) for k, v in batch.items()}
        with activate(rules), torch.no_grad():
            logits, _ = model.forward(on_mesh(params, param_shardings(rules, specs)), b)
        results[f"decode{i}/prefill"] = full(logits)
        # the decode steps, under the dry run's decode layout
        rules = make_rules(mesh)
        if seq_shard:
            rules.rules["seq"] = "model"
        p = on_mesh(params, param_shardings(rules, specs))
        cache_specs = model.cache_specs(DECODE_BATCH, CACHE_LEN)
        cache = on_mesh({k: torch.zeros(s.shape) for k, s in cache_specs.items()},
                        param_shardings(rules, cache_specs))
        for t, (tokens, cur, active) in enumerate(decode_inputs(cfg)):
            tok = distribute_tensor(tokens, mesh,
                                    list(rules.placements_for(("batch", None))))
            with activate(rules), torch.no_grad():
                logits, cache = model.decode_step(p, cache, tok, cur, active)
            results[f"decode{i}/logits{t}"] = full(logits)
        for k, v in cache.items():
            results[f"decode{i}/cache_{k}"] = full(v)
    if rank == 0:
        np.savez(out, **results)
    dist.barrier()
    dist.destroy_process_group()


def _mesh_side(out: str) -> None:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    # forked before this process runs anything: the ranks start in a second
    torch.multiprocessing.start_processes(_mesh_rank, args=(port, out), nprocs=8,
                                          start_method="fork")


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("gspmd") / "mesh.npz")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, __file__, out], check=True, env=env,
                   timeout=600)
    return dict(np.load(out))


@pytest.mark.parametrize("case", range(len(MESH_CASES)))
def test_step_on_2x4_mesh_equals_plain_step(mesh_run, case):
    arch, flags, opt_name, n_mb = MESH_CASES[case]
    cfg = get_arch(arch).reduced()
    model = build_model(cfg)
    opt = make_optimizer(opt_name)
    params = model.init(0, device="cpu", dtype=torch.float32)
    batch = to_torch(make_batch(cfg, SEQ * 2, BATCH))
    p, s, m = make_train_step(model, opt, lr=LR[opt_name])(params, opt.init(params), batch)
    want = {path: v.detach().numpy()
            for path, v in _flatten({"params": p, "state": s, "metrics": m})}
    got = {k.split("/", 1)[1]: v for k, v in mesh_run.items()
           if k.startswith(f"{case}/")}
    assert sorted(got) == sorted(want)
    for path in ("metrics/loss", "metrics/grad_norm"):
        np.testing.assert_allclose(got[path], want[path], rtol=1e-5)
    for path, w in want.items():
        if path.startswith("metrics/"):
            continue
        if opt_name == "adamw" and path.startswith("params/"):
            continue    # each element moves by about lr sign(g): the moments hold
        peak = float(np.abs(w).max())
        gap = float(np.abs(got[path].astype(np.float64) - w).max())
        assert gap <= MESH_TOL[cfg.qk_norm] * peak, (path, gap, peak)



@pytest.mark.parametrize("case", range(len(DECODE_CASES)))
def test_decode_on_2x4_mesh_equals_plain_decode(mesh_run, case):
    n_kv_heads, _ = DECODE_CASES[case]
    want = plain_decode(n_kv_heads)
    got = {k.split("/", 1)[1]: v for k, v in mesh_run.items()
           if k.startswith(f"decode{case}/")}
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        peak = float(np.abs(w).max())
        gap = float(np.abs(got[path].astype(np.float64) - w).max())
        assert gap <= MESH_TOL[True] * peak, (path, gap, peak)


if __name__ == "__main__":
    _mesh_side(sys.argv[1])
