"""The port's state-carrying forms held against the JAX package: attention
at a query offset (B4), and the WKV6 and SSD scans from an initial state,
each returning its final state (B8, B9), on plain tensors and on DTensors.

  * B4's plain versions (:func:`flash_attention` on the CPU, forward and
    backward) at query offsets 0, 5 and Sq, causal, windowed and GQA, and
    with the offset as a 0-d integer tensor, against the reference's
    ``layers.attention_reference`` and ``attention_chunked`` (its dense and
    chunked branches) and ``jax.vjp`` of each;
  * :func:`ssd_scan` and the model's ``ssd_chunked`` from a state, y and
    the final state, and the gradients of a loss on both in all six inputs,
    against the reference's ``ssd_chunked`` and ``jax.grad`` of it (at a
    decay where its unmasked ``exp`` stays finite, ROADMAP C6);
    :func:`wkv6` and the model's ``wkv6_chunked`` likewise against the
    reference's ``wkv6_chunked``;
  * ``mamba2_block(ssm_state=, conv_state=, decode=False)`` and
    ``Rwkv6LM._time_mix(wkv_state=)`` against the reference's, on reduced
    zamba2-1.2b and rwkv6-7b, one layer of weights drawn with numpy; and a
    sequence split in two halves, the second from the first's states,
    against the whole. Outside decode ``shift_state`` is not read, on both
    sides (the token shift starts from zeros);
  * one DTensor case of each block from a state (this file run as a script:
    four gloo processes, a 2x2 ("data", "model") mesh under
    ``activate(rules)``, batch rows over "data" and heads over "model"),
    its outputs and the gradients of a loss on them in the block's input
    and both states, against the same block on plain tensors here.

Tolerances: forward outputs ``max |got - want| <= 2e-5 max |want|`` (B4's
forward limit, ``chip_smoke.FA_FWD_TOL``); gradients a relative norm of
1e-4 (B4's backward limit); the mesh against plain tensors, the same. Both
sides sum in f32 in other orders; measured at most 8.5e-7 (forward) and
2.8e-6 (gradients) against the reference, 2.8e-7 and 3.3e-7 on the mesh.
"""

import functools
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
from repro.models import layers as jax_layers
from repro.models import rwkv as jax_rwkv
from repro.models import ssm as jax_ssm
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rwkv6_wkv as W
from repro_torch.kernels import ssd_scan as S
from repro_torch.models import rwkv, ssm
from repro_torch.models.model import build_model
from repro_torch.models.module import _flatten, _unflatten

FWD_TOL, BWD_TOL = 2e-5, 1e-4
MESH = (2, 2)


def close_to_max(got, want, tol=FWD_TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * top, (
        what, np.abs(got - want).max() / top)


def rel_norm(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# -- B4 at a query offset ------------------------------------------------------

B, SQ, SKV, HQ, HKV, D = 2, 12, 30, 4, 2, 16
# (causal, window): causal, causal in a window, a window alone
MASKS = {"causal": (True, None), "causal window": (True, 7),
         "window": (False, 9)}


def attention_inputs(seed: int):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, SQ, HQ, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, SKV, HKV, D)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal((B, SQ, HQ, D)).astype(np.float32)
    return q, k, v, g


# every mask at every offset through the dense branch; the chunked branch
# (a scan of online-softmax blocks) at every offset in its widest mask
CASES = ([(offset, mask, "dense") for offset in (0, 5, SQ) for mask in MASKS]
         + [(offset, "causal window", "chunked") for offset in (0, 5, SQ)])


@pytest.mark.parametrize("offset,mask,branch", CASES)
def test_plain_attention_at_offset_matches_reference(offset, mask, branch):
    causal, window = MASKS[mask]
    q, k, v, g = attention_inputs(offset + 3 * len(mask))
    if branch == "dense":
        ref = jax_layers.attention_reference
    else:
        def ref(*a, **kw):
            return jax_layers.attention_chunked(*a, chunk=8, **kw)
    want, vjp = jax.vjp(lambda q, k, v: ref(q, k, v, causal=causal, window=window,
                                            q_offset=offset),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    wants = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = fa.flash_attention(*leaves, causal=causal, window=window, q_offset=offset)
    got.backward(torch.from_numpy(g))
    close_to_max(to_np(got), want, what="O")
    for name, leaf, w in zip("qkv", leaves, wants):
        assert rel_norm(to_np(leaf.grad), w) <= BWD_TOL, name


def test_attention_offset_as_a_tensor():
    """A 0-d integer tensor offset (the reference's ``jax.Array``) is read
    once and gives the int's result, through ``layers.attention`` too."""
    q, k, v, _ = attention_inputs(1)
    ins = [torch.from_numpy(a) for a in (q, k, v)]
    as_int = fa.flash_attention(*ins, q_offset=7)
    assert torch.equal(fa.flash_attention(*ins, q_offset=torch.tensor(7)), as_int)
    want = jax_layers.attention(*map(jnp.asarray, (q, k, v)), q_offset=jnp.asarray(7))
    close_to_max(to_np(as_int), want)
    close_to_max(to_np(ssm.L.attention(*ins, q_offset=torch.tensor(7))), want)
    with pytest.raises(TypeError, match="0-d integer"):
        fa.flash_attention(*ins, q_offset=torch.tensor(7.0))


@pytest.mark.parametrize("offset,window", [(-1, None), (SKV + 3 - SQ, 3)])
def test_kernel_arguments_refuse_rows_without_a_key(offset, window):
    """The kernels skip masked tiles, which is B4 only where every query
    row sees a key: a causal offset below 0, and rows past ``Skv + window -
    1``, are refused before a launch."""
    q, k = torch.zeros(1, SQ, 2, 32), torch.zeros(1, SKV, 2, 32)
    ins = [q, k, k]
    with pytest.raises(ValueError, match="see no key"):
        fa._kernel_args(*ins, True, window, offset)
    fa._kernel_args(*ins, True, window, offset + (1 if offset < 0 else -1))


# -- B8 and B9 from a state -----------------------------------------------------

def ssd_inputs(seed: int, b=2, s=100, h=3, p=8, n=4):
    """x, dt, A, B, C, the initial state, and cotangents of y and of the
    final state. The decay keeps g within 30 over a chunk of 32, where the
    reference's unmasked ``exp(g_t - g_j)`` stays finite."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, s, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f)
    A = (-0.5 * np.exp(0.5 * rng.standard_normal(h))).astype(f)
    Bm, Cm = (rng.standard_normal((b, s, n)).astype(f) for _ in range(2))
    s0 = rng.standard_normal((b, h, n, p)).astype(f)
    gy = rng.standard_normal((b, s, h, p)).astype(f)
    gs = rng.standard_normal((b, h, n, p)).astype(f)
    return [x, dt, A, Bm, Cm, s0], gy, gs


def wkv_inputs(seed: int, b=2, s=75, h=3, p=8):
    """r, k, v, logw (a slow decay, so that the carried state weighs), u,
    the initial state, and cotangents of y and of the final state."""
    rng = np.random.default_rng(seed)
    f = np.float32
    r, k, v = (rng.standard_normal((b, s, h, p)).astype(f) for _ in range(3))
    logw = (-0.1 * np.exp(rng.standard_normal((b, s, h, p)))).clip(-2.5).astype(f)
    u = (0.3 * rng.standard_normal((h, p))).astype(f)
    s0 = rng.standard_normal((b, h, p, p)).astype(f)
    gy = rng.standard_normal((b, s, h, p)).astype(f)
    gs = rng.standard_normal((b, h, p, p)).astype(f)
    return [r, k, v, logw, u, s0], gy, gs


def ssd_reference(*a, initial_state):
    return jax_ssm.ssd_chunked(*a, 32, initial_state=initial_state)


SCANS = {"ssd": (ssd_inputs, 5, ssd_reference),
         "wkv6": (wkv_inputs, 6, jax_rwkv.wkv6_chunked)}


@functools.lru_cache(maxsize=None)
def reference_grads(scan: str):
    """The scan's inputs (``SCANS``), and ``(y, final)`` of the reference's
    function from the initial state with ``jax.grad`` of ``<y, gy> +
    <final, gs>`` in all its inputs; once for the routes that share them."""
    inputs, seed, fn = SCANS[scan]
    arrs, gy, gs = inputs(seed)

    def loss(*a):
        y, final = fn(*a[:-1], initial_state=a[-1])
        return jnp.sum(y * gy) + jnp.sum(final * gs), (y, final)

    grads, (y, final) = jax.jit(jax.grad(loss, argnums=tuple(range(len(arrs))),
                                         has_aux=True))(*map(jnp.asarray, arrs))
    return (arrs, gy, gs), (y, final, grads)


def check_against_reference(fn, scan: str):
    (arrs, gy, gs), (wy, wfinal, wgrads) = reference_grads(scan)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y, final = fn(*leaves)
    (torch.sum(y * torch.from_numpy(gy)) + torch.sum(final * torch.from_numpy(gs))
     ).backward()
    close_to_max(to_np(y), wy, what="y")
    close_to_max(to_np(final), wfinal, what="final state")
    for i, (leaf, want) in enumerate(zip(leaves, wgrads)):
        assert rel_norm(to_np(leaf.grad), want) <= BWD_TOL, i


@pytest.mark.parametrize("route", ["ssd_scan", "ssd_chunked"])
def test_ssd_from_state_matches_reference(route):
    if route == "ssd_scan":
        def fn(*a):
            return S.ssd_scan(*a)
    else:
        def fn(*a):
            return ssm.ssd_chunked(*a[:-1], 32, initial_state=a[-1])
    check_against_reference(fn, "ssd")


@pytest.mark.parametrize("route", ["wkv6", "wkv6_chunked"])
def test_wkv6_from_state_matches_reference(route):
    if route == "wkv6":
        fn = W.wkv6
    else:
        def fn(*a):
            return rwkv.wkv6_chunked(*a[:-1], initial_state=a[-1])
    check_against_reference(fn, "wkv6")


@pytest.mark.parametrize("scan", ["ssd", "wkv6"])
def test_backward_from_a_state_gives_the_initial_states_gradient_alone(scan):
    """The backward's initial-state gradient is formed only when the state
    was given and wants one; from no state the function's gradients are
    its zero-state ones."""
    if scan == "ssd":
        arrs, gy, _ = ssd_inputs(7, s=40)
        fn = S.ssd_scan
    else:
        arrs, gy, _ = wkv_inputs(7, s=40)
        fn = W.wkv6
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs[:-1]]
    y, _ = fn(*leaves)
    y.backward(torch.from_numpy(gy))
    zero = torch.zeros(arrs[-1].shape, requires_grad=True)
    again = [torch.from_numpy(a).requires_grad_(True) for a in arrs[:-1]]
    fn(*again, zero)[0].backward(torch.from_numpy(gy))
    for a, b in zip(leaves, again):
        assert torch.equal(a.grad, b.grad)
    assert zero.grad is not None and zero.grad.shape == zero.shape


# -- the blocks: mamba2_block and the time-mix from a state -----------------------

def layer_params(specs, seed: int) -> dict:
    """One layer's weights drawn with numpy (specs with the layer dim
    dropped): norms near 1, mixes in [0, 1), projections scaled by their
    fan-in, slow decays (Mamba2's A in [-0.5, -0.05], RWKV6's logw near
    -0.05), so that the carried states weigh in every output."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, spec in sorted(_flatten(specs)):
        shape = spec.shape[1:]
        name = path.split("/")[-1]
        if name in ("ln", "gate_ln", "gn"):
            a = 1 + 0.1 * rng.standard_normal(shape)
        elif name.startswith("mu_"):
            a = rng.uniform(0, 1, shape)
        elif name == "A_log":
            a = np.log(rng.uniform(0.05, 0.5, shape))
        elif name == "dt_bias":
            a = -1 + 0.5 * rng.standard_normal(shape)
        elif name == "decay_base":
            a = -3 + 0.5 * rng.standard_normal(shape)
        elif name in ("conv_b", "bonus_u", "D"):
            a = 0.3 * rng.standard_normal(shape)
        elif name == "conv_w":
            a = 0.5 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) * (spec.scale or 1.0) / np.sqrt(shape[0])
        out[path] = a.astype(np.float32)
    return _unflatten(out)


def zamba_case():
    cfg = get_arch("zamba2-1.2b").reduced()
    lp = layer_params(ssm.mamba2_specs(cfg, 1), 1)
    rng = np.random.default_rng(2)
    b, s = 2, 40
    f = np.float32
    h = rng.standard_normal((b, s, cfg.d_model)).astype(f)
    s0 = rng.standard_normal((b, cfg.n_ssm_heads, cfg.ssm_state,
                              cfg.ssm_head_dim)).astype(f)
    c0 = rng.standard_normal((b, ssm.CONV_K - 1, cfg.d_inner + 2 * cfg.ssm_state)
                             ).astype(f)
    return cfg, lp, h, s0, c0


def rwkv_case():
    cfg = get_arch("rwkv6-7b").reduced()
    lp = layer_params(build_model(cfg).param_specs()["time_mix"], 3)
    rng = np.random.default_rng(4)
    b, s, d = 2, 40, cfg.d_model
    p = cfg.rwkv_head_dim
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    s0 = rng.standard_normal((b, d // p, p, p)).astype(np.float32)
    return cfg, lp, h, s0


def torch_tree(tree):
    return {k: torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def jax_tree(tree):
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def test_mamba2_block_from_state_matches_reference():
    cfg, lp, h, s0, c0 = zamba_case()
    jcfg = jax_get_arch("zamba2-1.2b").reduced()
    got = ssm.mamba2_block(cfg, torch_tree(lp), torch.from_numpy(h),
                           ssm_state=torch.from_numpy(s0),
                           conv_state=torch.from_numpy(c0))
    want = jax.jit(lambda lp, h, s0, c0: jax_ssm.mamba2_block(
        jcfg, lp, h, ssm_state=s0, conv_state=c0))(
            jax_tree(lp), jnp.asarray(h), jnp.asarray(s0), jnp.asarray(c0))
    for what, g, w in zip(("h", "ssm state", "conv state"), got, want):
        close_to_max(to_np(g), w, what=what)


def test_time_mix_from_state_matches_reference():
    """The reference's time-mix runs the WKV from ``wkv_state`` and returns
    its final state; so does the port's, on the CPU too."""
    cfg, lp, h, s0 = rwkv_case()
    jmodel = jax_build_model(jax_get_arch("rwkv6-7b").reduced())
    got = build_model(cfg)._time_mix(torch_tree(lp), torch.from_numpy(h),
                                     wkv_state=torch.from_numpy(s0))
    want = jax.jit(lambda lp, h, s0: jmodel._time_mix(lp, h, wkv_state=s0))(
        jax_tree(lp), jnp.asarray(h), jnp.asarray(s0))
    for what, g, w in zip(("h", "shift state", "wkv state"), got, want):
        close_to_max(to_np(g), w, what=what)


def test_shift_state_is_not_read_outside_decode():
    """Outside decode the time-mix's token shift starts from zeros on both
    sides: a ``shift_state`` passed there changes nothing."""
    cfg, lp, h, s0 = rwkv_case()
    shift = np.random.default_rng(9).standard_normal((h.shape[0], h.shape[2])
                                                     ).astype(np.float32)
    mix = build_model(cfg)._time_mix
    plain = mix(torch_tree(lp), torch.from_numpy(h))
    shifted = mix(torch_tree(lp), torch.from_numpy(h), shift_state=torch.from_numpy(shift))
    for a, b in zip(plain, shifted):
        assert torch.equal(a, b)
    jmix = jax_build_model(jax_get_arch("rwkv6-7b").reduced())._time_mix
    jplain, jshifted = jax.jit(lambda lp, h, sh: (jmix(lp, h), jmix(lp, h, shift_state=sh)))(
        jax_tree(lp), jnp.asarray(h), jnp.asarray(shift))
    for a, b in zip(jplain, jshifted):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("block", ["mamba2", "wkv6", "attention"])
def test_two_halves_equal_the_whole(block):
    """A sequence in two halves, the second from the states the first
    returns (attention: the second half's queries at ``q_offset`` over the
    keys of both), equals the whole sequence on its second half, and the
    final states are the whole's. (The time-mix's token shift starts from
    zeros outside decode, so its WKV is split here.)"""
    cut = 24
    if block == "mamba2":
        cfg, lp, h, _, _ = zamba_case()
        tlp, th = torch_tree(lp), torch.from_numpy(h)
        whole = ssm.mamba2_block(cfg, tlp, th)
        first = ssm.mamba2_block(cfg, tlp, th[:, :cut])
        second = ssm.mamba2_block(cfg, tlp, th[:, cut:], ssm_state=first[1],
                                  conv_state=first[2])
        outs = [(second[0], whole[0][:, cut:]), (second[1], whole[1]),
                (second[2], whole[2])]
    elif block == "wkv6":
        arrs, _, _ = wkv_inputs(11, s=40, h=4, p=32)
        ins = [torch.from_numpy(a) for a in arrs[:5]]
        whole = W.wkv6(*ins)
        first = W.wkv6(*(t[:, :cut] for t in ins[:4]), ins[4])
        second = W.wkv6(*(t[:, cut:] for t in ins[:4]), ins[4], first[1])
        outs = [(second[0], whole[0][:, cut:]), (second[1], whole[1])]
    else:
        q, k, v, _ = attention_inputs(12)
        q, k, v = (torch.from_numpy(a) for a in (q, k, v))
        whole = fa.flash_attention(q, k[:, :SQ], v[:, :SQ])
        half = fa.flash_attention(q[:, 5:], k[:, :SQ], v[:, :SQ], q_offset=5)
        outs = [(half, whole[:, 5:])]
    for got, want in outs:
        close_to_max(to_np(got), to_np(want))


# -- the blocks from a state on DTensors -----------------------------------------

def mesh_cases():
    """name -> (the layer's weights and the block's inputs on plain tensors,
    a function of the weights, h and the states giving the block's outputs
    (DTensors or not), the layer's specs (the layer dim first), the logical
    axes of h and of each state)."""
    zcfg, zlp, zh, zs0, zc0 = zamba_case()
    rcfg, rlp, rh, rs0 = rwkv_case()
    rmodel = build_model(rcfg)

    def mamba2(lp, h, s0, c0):
        return ssm.mamba2_block(zcfg, lp, h, ssm_state=s0, conv_state=c0)

    def time_mix(lp, h, s0):
        return rmodel._time_mix(lp, h, wkv_state=s0)

    act = ("batch", "seq", "act_embed")
    heads = ("batch", "ssm_heads", None, None)
    return {
        "mamba2": ((zlp, zh, zs0, zc0), mamba2, ssm.mamba2_specs(zcfg, 1),
                   (act, heads, ("batch", None, "ssm_heads"))),
        "time_mix": ((rlp, rh, rs0), time_mix, rmodel.param_specs()["time_mix"],
                     (act, heads)),
    }


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole, differentiably; a tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def block_run(fn, lp, ins, wrap):
    """The block's outputs, each whole, and the gradients of ``sum(out *
    cotangent)`` over them in ``ins`` (h and the states, laid out by
    ``wrap``), each whole, as numpy."""
    leaves = [wrap(torch.from_numpy(a), i).requires_grad_(True)
              for i, a in enumerate(ins)]
    outs = [whole(o) for o in fn(lp, *leaves) if o is not None]
    rng = np.random.default_rng(13)
    loss = sum(torch.sum(o * torch.from_numpy(rng.standard_normal(
        tuple(o.shape)).astype(np.float32))) for o in outs)
    loss.backward()
    return [to_np(o) for o in outs], [None if leaf.grad is None else
                                      to_np(whole(leaf.grad)) for leaf in leaves]


def _mesh_rank(rank: int, port: int, out: str) -> None:
    """One of the four gloo ranks: each case on the 2x2 mesh; rank 0
    writes the full outputs and gradients to ``out``."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist.sharding import activate, make_rules
    from repro_torch.launch.mesh import make_dev_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=MESH[0] * MESH[1])
    mesh = make_dev_mesh(*MESH)
    rules = make_rules(mesh)
    results = {}
    for name, (arrs, fn, specs, axes) in mesh_cases().items():
        specs = dict(_flatten(specs))
        lp = _unflatten({k: distribute_tensor(torch.from_numpy(v), mesh, list(
            rules.placements_for(specs[k].axes[1:], v.shape)))
            for k, v in _flatten(arrs[0])})

        def wrap(t, i):
            return distribute_tensor(t, mesh, list(rules.placements_for(axes[i])))

        with activate(rules):
            outs, grads = block_run(fn, lp, arrs[1:], wrap)
        for i, o in enumerate(outs):
            results[f"{name}/out{i}"] = o
        for i, g in enumerate(grads):
            results[f"{name}/grad{i}"] = g
    if rank == 0:
        np.savez(out, **results)
    dist.barrier()
    dist.destroy_process_group()


def _mesh_side(out: str) -> None:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.multiprocessing.start_processes(_mesh_rank, args=(port, out),
                                          nprocs=MESH[0] * MESH[1],
                                          start_method="fork")


@pytest.fixture(scope="module", autouse=True)
def mesh_proc(tmp_path_factory):
    """The mesh side, started before the file's first test."""
    out = str(tmp_path_factory.mktemp("state_carry") / "mesh.npz")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, __file__, out], env=env)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.mark.parametrize("name", ["mamba2", "time_mix"])
def test_block_from_state_on_mesh_equals_plain(mesh_proc, name):
    proc, out = mesh_proc
    assert proc.wait(timeout=600) == 0
    run = dict(np.load(out))
    arrs, fn, _, _ = mesh_cases()[name]
    outs, grads = block_run(fn, torch_tree(arrs[0]), arrs[1:], lambda t, i: t)
    for i, want in enumerate(outs):
        close_to_max(run[f"{name}/out{i}"], want, what=f"out{i}")
    for i, want in enumerate(grads):
        assert rel_norm(run[f"{name}/grad{i}"], want) <= BWD_TOL, i


if __name__ == "__main__":
    _mesh_side(sys.argv[1])
