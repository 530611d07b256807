"""The port's RWKV6 WKV (``repro_torch.kernels.rwkv6_wkv``) held against the
JAX package: the plain forward against ``wkv6_pallas`` in interpret mode and
against the sequential oracle ``wkv6_reference`` (chunk 8 and 32, P 16, 32
and 64, ragged S, and a hypothesis sweep like ``tests/test_kernels.py``'s);
the plain backward against ``jax.vjp`` of ``models/rwkv.py::wkv6_chunked``
and of ``wkv6_reference``, every input's gradient; the autograd function by
``gradcheck`` in f64; and the wrappers' routing and argument checks.

Inputs are made with numpy from a seed and handed to both sides. On the CPU
the wrappers take their plain versions; the CUDA kernels are held against
those on the card by ``chip_smoke.py``. Tolerances: the forward keeps the
reference's own limits (``tests/test_kernels.py:160``: atol 1e-4, rtol 1e-3;
``:186``, the sweep: atol 2e-4, rtol 2e-3) and is held tighter as well, to
``max|got - want| <= 1e-5 * max|want|`` (measured at most 2.4e-6); the
backward per input to a relative norm of 1e-5 (measured at most 1.9e-6, on
dlogw): both sides sum in f32, in other orders.

W1's and W2's order of work, with every product in split TF32 on the tensor
cores and each chunk's pair decays referred to its middle row, is emulated
at the matrix level (``split_wkv6``) and held against the plain versions
within the smoke's limits, and against the JAX package within this file's
tolerances; plain TF32 (one term) misses the smoke's limits, and every
rebased operand stays within ``e^((L/2) 2.5)`` of |r| and |k|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.ref import wkv6_reference
from repro.kernels.rwkv6_wkv import wkv6_pallas
from repro.models.rwkv import DECAY_CLAMP as JAX_DECAY_CLAMP
from repro.models.rwkv import WKV_CHUNK as JAX_WKV_CHUNK
from repro.models.rwkv import wkv6_chunked as jax_wkv6_chunked
from repro_torch.kernels import rwkv6_wkv as W
from repro_torch.models import rwkv
from test_torch_flash_attention import tf32_mm


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this file's torch ops on one thread: its ops are small, and when
    test workers share the cores, torch's own thread pool makes them many
    times slower than one thread does."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def wkv_inputs(seed, b=2, s=80, h=3, p=16, weak=False):
    """``r, k, v, logw, u`` as f32 numpy arrays, as the reference's
    ``wkv_inputs`` scales them; logw within the model's clamp, or with
    ``weak`` ``-0.02 exp(N)`` (mostly within [-0.05, 0]: a chunk of 32
    keeps ``exp(cum_L)`` near 1/3 to 1, so the state carried across
    chunks, and its gradient, weigh in every output)."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, s, h, p)) for _ in range(3))
    if weak:
        logw = -0.02 * np.exp(rng.standard_normal((b, s, h, p)))
    else:
        logw = -np.minimum(np.exp(0.7 * rng.standard_normal((b, s, h, p))),
                           rwkv.DECAY_CLAMP)
    u = 0.3 * rng.standard_normal((h, p))
    return [a.astype(np.float32) for a in (r, k, v, logw, u)]


def torch_of(arrs):
    return [torch.from_numpy(a.copy()) for a in arrs]


def jax_of(arrs):
    return [jnp.asarray(a) for a in arrs]


def assert_close_to_max(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    gap, peak = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert np.isfinite(gap) and gap <= rel * peak, (gap, peak)


def rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_constants_match_reference():
    assert rwkv.DECAY_CLAMP == JAX_DECAY_CLAMP
    assert W.WKV_CHUNK == rwkv.WKV_CHUNK == JAX_WKV_CHUNK


# each head_dim with each chunk, ragged (37) and whole (80) under both
# chunks; then weak decay over many chunks: 10 of 8, 5 of 32 (ragged), 8 of 32
@pytest.mark.parametrize("chunk,p,s,weak", [
    pytest.param(8, 16, 80, False, id="8-16-80"),
    pytest.param(8, 32, 37, False, id="8-32-37"),
    pytest.param(8, 64, 80, False, id="8-64-80"),
    pytest.param(32, 16, 37, False, id="32-16-37"),
    pytest.param(32, 32, 80, False, id="32-32-80"),
    pytest.param(32, 64, 37, False, id="32-64-37"),
    pytest.param(8, 16, 80, True, id="8-16-80-weak"),
    pytest.param(32, 32, 150, True, id="32-32-150-weak"),
    pytest.param(32, 64, 256, True, id="32-64-256-weak")])
def test_plain_forward_matches_pallas_and_reference(chunk, p, s, weak):
    arrs = wkv_inputs(p + s + chunk, s=s, p=p, weak=weak)
    y, states, _ = W.wkv6_plain(*torch_of(arrs), chunk=chunk)
    lc = min(chunk, s)
    assert y.shape == (2, s, 3, p) and y.dtype == torch.float32
    assert states.shape == (2, 3, -(-s // lc), p, p)
    pallas = wkv6_pallas(*jax_of(arrs), chunk=chunk, interpret=True)
    ref, _ = wkv6_reference(*jax_of(arrs))
    for want in (pallas, ref):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-3)
        assert_close_to_max(y.numpy(), want, 1e-5)
    assert not states[:, :, 0].any()     # the first chunk starts from zero
    # the last chunk's start state, carried over every chunk before it
    last = (s - 1) // lc * lc
    _, want = wkv6_reference(*(jnp.asarray(a[:, :last]) if a.ndim == 4
                               else jnp.asarray(a) for a in arrs))
    assert_close_to_max(states[:, :, -1].numpy(), want, 1e-5)


def test_plain_states_match_reference_prefix_states():
    """``states[:, :, c]`` is the oracle's state after ``c * L`` steps."""
    arrs = wkv_inputs(5, s=96, p=32)
    _, states, _ = W.wkv6_plain(*torch_of(arrs))
    for c in (1, 2):
        _, want = wkv6_reference(*(jnp.asarray(a[:, :32 * c]) if a.ndim == 4
                                   else jnp.asarray(a) for a in arrs))
        assert_close_to_max(states[:, :, c].numpy(), want, 1e-5)


@given(s=st.integers(4, 120), h=st.integers(1, 3),
       p=st.sampled_from([8, 16, 32]), chunk=st.sampled_from([8, 16, 32]))
@settings(max_examples=10, deadline=None)
def test_plain_forward_shape_sweep(s, h, p, chunk):
    arrs = wkv_inputs(s, b=1, s=s, h=h, p=p)
    y, _, _ = W.wkv6_plain(*torch_of(arrs), chunk=chunk)
    pallas = wkv6_pallas(*jax_of(arrs), chunk=chunk, interpret=True)
    ref, _ = wkv6_reference(*jax_of(arrs))
    for want in (pallas, ref):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=2e-4,
                                   rtol=2e-3)


# the last three with weak decay over 3 to 8 chunks, where dS carried back
# across chunks (exp(cum_L) dS, and exp(cum_L) S . dS in dlogw) is a large
# part of every gradient
@pytest.mark.parametrize("b,s,h,p,weak", [
    pytest.param(2, 80, 3, 16, False, id="2-80-3-16"),
    pytest.param(1, 64, 2, 32, False, id="1-64-2-32"),
    pytest.param(2, 37, 2, 64, False, id="2-37-2-64"),
    pytest.param(1, 5, 1, 32, False, id="1-5-1-32"),
    pytest.param(2, 80, 3, 16, True, id="2-80-3-16-weak"),
    pytest.param(2, 150, 2, 32, True, id="2-150-2-32-weak"),
    pytest.param(1, 256, 2, 64, True, id="1-256-2-64-weak")])
def test_plain_backward_matches_jax_vjp(b, s, h, p, weak):
    arrs = wkv_inputs(3 * s + p, b=b, s=s, h=h, p=p, weak=weak)
    dy = np.random.default_rng(s).standard_normal((b, s, h, p)).astype(np.float32)
    _, states, _ = W.wkv6_plain(*torch_of(arrs))
    got = W.wkv6_bwd_plain(*torch_of(arrs), states, torch.from_numpy(dy))
    for oracle in (lambda *a: jax_wkv6_chunked(*a)[0],
                   lambda *a: wkv6_reference(*a)[0]):
        _, vjp = jax.vjp(oracle, *jax_of(arrs))
        for name, g, want in zip(("dr", "dk", "dv", "dlogw", "du"), got,
                                 vjp(jnp.asarray(dy))):
            assert g.shape == want.shape and g.dtype == torch.float32, name
            assert rel_norm(g.numpy(), want) <= 1e-5, name


def test_autograd_function_uses_the_plain_backward():
    arrs = wkv_inputs(8, s=40, p=16)
    dy = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 40, 3, 16)).astype(np.float32))
    leaves = [t.requires_grad_(True) for t in torch_of(arrs)]
    y, _ = W.wkv6(*leaves)
    _, states, _ = W.wkv6_plain(*torch_of(arrs))
    np.testing.assert_array_equal(y.detach().numpy(),
                                  W.wkv6_plain(*torch_of(arrs))[0].numpy())
    y.backward(dy)
    wants = W.wkv6_bwd_plain(*torch_of(arrs), states, dy)
    for leaf, want in zip(leaves, wants):
        np.testing.assert_array_equal(leaf.grad.numpy(), want.numpy())


# the weak-decay case checks the gradient through the carried state where
# it is not negligible
@pytest.mark.parametrize("s,chunk_note,weak", [
    pytest.param(7, "one ragged chunk", False, id="7-one ragged chunk"),
    pytest.param(35, "a second, ragged chunk", False,
                 id="35-a second, ragged chunk"),
    pytest.param(70, "three chunks, weak decay", True,
                 id="70-three chunks, weak decay")])
def test_autograd_function_gradcheck_f64(s, chunk_note, weak):
    rng = np.random.default_rng(s)
    r, k, v = (torch.from_numpy(0.5 * rng.standard_normal((1, s, 2, 4)))
               for _ in range(3))
    n = rng.standard_normal((1, s, 2, 4))
    logw = torch.from_numpy(-0.02 * np.exp(n) if weak else
                            -np.minimum(np.exp(0.5 * n), 2.5))
    u = torch.from_numpy(0.3 * rng.standard_normal((2, 4)))
    ins = [t.requires_grad_(True) for t in (r, k, v, logw, u)]
    assert torch.autograd.gradcheck(W.wkv6, ins), chunk_note


def test_model_wkv6_chunked_matches_reference_with_state():
    """The model's plain recurrence, with an initial state and the final
    state out, against the reference's ``wkv6_chunked``."""
    arrs = wkv_inputs(2, s=70, p=32)
    state0 = np.random.default_rng(4).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    y, final = rwkv.wkv6_chunked(*torch_of(arrs),
                                 initial_state=torch.from_numpy(state0))
    jy, jfinal = jax_wkv6_chunked(*jax_of(arrs), initial_state=jnp.asarray(state0))
    assert_close_to_max(y.numpy(), jy, 1e-5)
    assert_close_to_max(final.numpy(), jfinal, 1e-5)
    y0, _ = rwkv.wkv6_chunked(*torch_of(arrs))
    assert_close_to_max(W.wkv6_plain(*torch_of(arrs))[0].numpy(), y0.numpy(),
                        1e-5)


def test_other_devices_raise_and_cpu_launches_nothing():
    meta = [torch.empty((1, 8, 2, 32), device="meta") for _ in range(4)]
    meta_u = torch.empty((2, 32), device="meta")
    with pytest.raises(ValueError, match="meta"):
        W.wkv6(*meta, meta_u)
    cpu = torch_of(wkv_inputs(0, b=1, s=8, h=2, p=32))
    with pytest.raises(ValueError, match="devices"):
        W.wkv6(*cpu[:4], meta_u)
    W.reset_launches()
    W.wkv6(*[t.requires_grad_(True) for t in cpu])[0].sum().backward()
    assert set(W.LAUNCHES) == {"wkv6_fwd", "wkv6_bwd"}
    assert not any(W.LAUNCHES.values())


@pytest.mark.parametrize("shape,u_shape,dtype,match", [
    ((1, 8, 2, 16), (2, 16), torch.float32, "head_dim"),
    ((1, 8, 2, 128), (2, 128), torch.float32, "head_dim"),
    ((1, 8, 2, 32), (2, 32), torch.float16, "f32 or bf16"),
    ((1, 8, 2, 32), (2, 32), torch.float64, "f32 or bf16"),
    ((1, 8, 2, 32), (3, 32), torch.float32, "u must be"),
    ((1, 0, 2, 32), (2, 32), torch.float32, "S >= 1"),
])
def test_kernel_arguments_refused(shape, u_shape, dtype, match):
    """What the CUDA route checks before a launch (the checks run on any
    tensor, so they are tested here)."""
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        W._kernel_inputs(x, x, x, x, torch.zeros(u_shape, dtype=dtype))


def test_kernel_arguments_of_the_main_path():
    x = torch.zeros(2, 1024, 64, 64)
    ins, u, args = W._kernel_inputs(x, x, x, x, torch.zeros(64, 64))
    assert args == [2, 1024, 64, 64, 32, 0] and u.dtype == torch.float32
    assert all(t is x for t in ins)
    bf = torch.zeros(4, 1000, 8, 32, dtype=torch.bfloat16)
    ins, _, args = W._kernel_inputs(bf, bf, bf, bf, torch.zeros(8, 32))
    assert args == [4, 1000, 8, 32, 32, 1] and ins[0].dtype == torch.bfloat16
    # a mixed set is widened to f32, exactly
    ins, _, args = W._kernel_inputs(bf, bf, bf, bf.float(), torch.zeros(8, 32))
    assert args[-1] == 0 and all(t.dtype == torch.float32 for t in ins)
    short = torch.zeros(8, 5, 4, 32)
    assert W._kernel_inputs(short, short, short, short,
                            torch.zeros(4, 32))[2][4] == 5


# ---------------------------------------------------------------------------
# W1's and W2's order on the tensor cores in split TF32, emulated
# ---------------------------------------------------------------------------

# chip_smoke.py's limits: y and the states (FA_FWD_TOL) as the largest gap
# over the largest value, each gradient (FA_BWD_TOL) as a relative norm
SMOKE_FWD_TOL, SMOKE_BWD_TOL = 2e-5, 1e-4


def split_wkv6(r, k, v, logw, u, dy, terms):
    """``(y, states)``, ``(dr, dk, dv, dlogw, du)`` and the largest exponent
    of a rebased factor, in the order of W1's and W2's stages, every
    product through :func:`tf32_mm` (``terms`` 3: the split the kernels
    run; 1: plain TF32). cum is the plain version's (a sequential f32 sum
    down each column); m is the cum of the chunk's middle row, row
    ``ceil(L/2) - 1``; r' = r exp(cumprev - m), k' = k exp(m - cum). W1:
    the chunk summaries ``(k exp(cum_L - cum))^T v``, the state pass,
    ``y = (r' k'^T below the diagonal) v + bonus v + r' (exp(m) S)``. W2:
    the dS summaries ``(r exp(cumprev))^T dy``, the dS pass, then with
    ``dS'' = exp(cum_L - m) dS``: ``dr_dec = exp(cumprev - m) (dA k' + dy
    (exp(m) S)^T)``, ``dk = exp(m - cum) (dA^T r') + exp(m - cum) (v
    dS''^T)`` (+ the bonus terms), ``dv = A^T dy + bonus dy + k' dS''``, and
    dlogw from dcum. The kernels' sums over 16 k a fresh accumulator are not
    emulated."""
    b, s, h, p = W._dims(r, k, v, logw, u)
    lc = min(W.WKV_CHUNK, s)
    rc, kc, vc, lw, dyc = (W._chunks(t, lc, torch.float32) for t in (r, k, v, logw, dy))
    nc = rc.shape[2]

    def mm(a, b_):
        return tf32_mm(a, b_, terms)

    def t(x):
        return x.transpose(-1, -2)

    cum = torch.cumsum(lw, dim=3)
    cumprev = cum - lw
    mid = (lc + 1) // 2 - 1
    m, cum_l = cum[..., mid:mid + 1, :], cum[..., -1:, :]     # (B, H, nc, 1, P)
    fr, fk = torch.exp(cumprev - m), torch.exp(m - cum)
    spread = float(torch.maximum((cumprev - m).abs().max(), (m - cum).abs().max()))
    rp, kp = rc * fr, kc * fk
    s_rows, ds_rows = t(torch.exp(m)), t(torch.exp(cum_l - m))  # (B, H, nc, P, 1)
    el = torch.exp(cum_l[..., 0, :])                            # (B, H, nc, P)
    lower = W._strictly_lower(lc, r.device)
    uf = u.float()[None, :, None, None, :]
    # W1
    summary = mm(t(kc * torch.exp(cum_l - cum)), vc)            # (B, H, nc, P, P)
    states = [torch.zeros(b, h, p, p)]
    for c in range(1, nc):
        states.append(el[:, :, c - 1, :, None] * states[-1] + summary[:, :, c - 1])
    st = torch.stack(states, dim=2)
    s_m = s_rows * st
    a = torch.where(lower, mm(rp, t(kp)), 0.0)
    bonus = torch.sum(rc * uf * kc, dim=-1)
    y = (mm(a, vc) + bonus[..., None] * vc) + mm(rp, s_m)
    # W2
    read = mm(t(rc * torch.exp(cumprev)), dyc)
    d_ends = [torch.zeros(b, h, p, p)]
    for c in range(nc - 2, -1, -1):
        d_ends.append(el[:, :, c + 1, :, None] * d_ends[-1] + read[:, :, c + 1])
    ds = torch.stack(d_ends[::-1], dim=2)
    ds_m = ds_rows * ds
    d_a = torch.where(lower, mm(dyc, t(vc)), 0.0)
    d_bonus = torch.sum(dyc * vc, dim=-1)[..., None]
    dr_dec = fr * (mm(d_a, kp) + mm(dyc, t(s_m)))
    dkb, dkt = fk * mm(t(d_a), rp), fk * mm(vc, t(ds_m))
    dr = dr_dec + d_bonus * uf * kc
    dk = (dkb + dkt) + d_bonus * uf * rc
    dv = (mm(t(a), dyc) + bonus[..., None] * dyc) + mm(kp, ds_m)
    d_cumprev = rc * dr_dec
    d_cum = (d_cumprev - kc * dkb) - kc * dkt
    d_cum[..., -1, :] += torch.sum(kc * dkt, dim=3) + el * torch.sum(st * ds, dim=-1)
    dlw = torch.flip(torch.cumsum(torch.flip(d_cum, [3]), dim=3), [3]) - d_cumprev
    du = torch.sum(d_bonus * rc * kc, dim=3).sum(dim=(0, 2))
    grads = tuple(W._unchunk(g, s, torch.float32) for g in (dr, dk, dv, dlw)) + (du,)
    return (W._unchunk(y, s, torch.float32), st), grads, spread


def split_inputs(seed, b, s, h, p, decay):
    """``wkv_inputs`` with the logw of ``decay``: "model" (within the
    model's clamp), "weak", or "clamp" (every step at -2.5, the widest span
    of the decays: k exp(-cum) reaches |k| e^80 over a chunk)."""
    arrs = wkv_inputs(seed, b=b, s=s, h=h, p=p, weak=decay == "weak")
    if decay == "clamp":
        arrs[3] = np.full_like(arrs[3], -rwkv.DECAY_CLAMP)
    return arrs


def split_errors(arrs, dy, terms):
    """The emulation's errors against the plain versions, as the smoke
    measures the kernels': y and the states as their largest gap over their
    largest value (the largest value itself where the plain one is all 0:
    one chunk's states), each gradient as its relative norm; and the
    largest rebased exponent."""
    ins = torch_of(arrs)
    want_fwd = W.wkv6_plain(*ins)
    want_bwd = W.wkv6_bwd_plain(*ins, want_fwd[1], dy)
    got_fwd, got_bwd, spread = split_wkv6(*ins, dy, terms)
    fwd = [float((a - w_).abs().max() / w_.abs().max()) if bool(w_.abs().max() > 0)
           else float(a.abs().max()) for a, w_ in zip(got_fwd, want_fwd)]
    bwd = [rel_norm(a.numpy(), w_.numpy()) for a, w_ in zip(got_bwd, want_bwd)]
    return fwd, bwd, spread


# the loop's reduced model (one chunk of 32, P 32); a chunk shorter than 32;
# ragged lengths over several chunks; every logw at the clamp; the weak
# decay, where the carried state weighs in every output; both head dims
@pytest.mark.parametrize("b,s,h,p,decay", [
    pytest.param(2, 32, 4, 32, "model", id="reduced-32-model"),
    pytest.param(2, 20, 2, 32, "model", id="short-20-model"),
    pytest.param(1, 100, 2, 64, "model", id="64-100-model"),
    pytest.param(1, 96, 2, 64, "clamp", id="64-96-clamp"),
    pytest.param(1, 75, 2, 32, "clamp", id="32-75-clamp"),
    pytest.param(1, 160, 2, 64, "weak", id="64-160-weak"),
    pytest.param(2, 70, 3, 32, "weak", id="32-70-weak")])
def test_split_tf32_order_within_plain(b, s, h, p, decay):
    """W1's and W2's order with every product in split TF32, referred to
    the chunk's middle row, stays within the smoke's limits of the plain
    versions: y and the states within ``FA_FWD_TOL`` (2e-5) of their
    largest value, every gradient within 1e-4 relative norm."""
    arrs = split_inputs(s + p + 7, b, s, h, p, decay)
    dy = torch.from_numpy(np.random.default_rng(s).standard_normal(
        (b, s, h, p)).astype(np.float32))
    fwd, bwd, _ = split_errors(arrs, dy, terms=3)
    assert max(fwd) < SMOKE_FWD_TOL and max(bwd) < SMOKE_BWD_TOL, (fwd, bwd)


@pytest.mark.parametrize("b,s,h,p,decay", [
    pytest.param(1, 96, 2, 64, "clamp", id="64-96-clamp"),
    pytest.param(2, 20, 2, 32, "clamp", id="short-20-clamp"),
    pytest.param(1, 100, 2, 64, "model", id="64-100-model"),
    pytest.param(1, 160, 2, 64, "weak", id="64-160-weak")])
def test_split_rebased_operands_stay_within_the_clamp_span(b, s, h, p, decay):
    """Every rebased factor, exp(cumprev - m) of r and exp(m - cum) of k, is
    within e^((L/2) 2.5) of 1: the operands stay within e^40 of |r| and |k|
    at chunk 32 (referred to row 0, k exp(-cum) reaches e^80), and at the
    clamp the bound is reached to within f32's rounding of cum."""
    arrs = split_inputs(s + p, b, s, h, p, decay)
    dy = torch.zeros((b, s, h, p))
    _, _, spread = split_wkv6(*torch_of(arrs), dy, terms=3)
    lc = min(W.WKV_CHUNK, s)
    bound = (lc // 2) * rwkv.DECAY_CLAMP
    assert spread <= bound * (1 + 1e-6), (spread, bound)
    if decay == "clamp":
        assert spread >= bound * (1 - 1e-6) - rwkv.DECAY_CLAMP, (spread, bound)


def test_split_tf32_one_term_misses_the_limits():
    """Plain TF32 (hi.hi alone) puts y beyond the smoke's forward limit and
    every gradient that a product forms (dr, dk, dv, dlogw; du is a sum of
    elementwise terms) beyond 1e-4, at the weak decay over five chunks: a
    product left unsplit fails the smoke. The split stays ten times inside
    both."""
    arrs = split_inputs(11, 1, 160, 2, 64, "weak")
    dy = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 160, 2, 64)).astype(np.float32))
    fwd, bwd, _ = split_errors(arrs, dy, terms=1)
    split_fwd, split_bwd, _ = split_errors(arrs, dy, terms=3)
    assert fwd[0] > SMOKE_FWD_TOL and min(bwd[:4]) > SMOKE_BWD_TOL, (fwd, bwd)
    assert max(split_fwd) < SMOKE_FWD_TOL / 10 and max(split_bwd) < SMOKE_BWD_TOL / 10, (
        split_fwd, split_bwd)


@pytest.mark.parametrize("s,p,decay", [
    pytest.param(80, 32, "model", id="80-32-model"),
    pytest.param(100, 64, "clamp", id="100-64-clamp"),
    pytest.param(150, 32, "weak", id="150-32-weak")])
def test_split_tf32_order_against_pallas_and_jax(s, p, decay):
    """The emulated order against the JAX package, with this file's
    tolerances: y against ``wkv6_pallas`` in interpret mode and against
    ``wkv6_reference`` (atol 1e-4, rtol 1e-3, and 1e-5 of the largest
    value), every gradient against ``jax.vjp`` of ``wkv6_reference`` (1e-5
    relative norm)."""
    arrs = split_inputs(s + p + 1, 2, s, 2, p, decay)
    dy = np.random.default_rng(s).standard_normal((2, s, 2, p)).astype(np.float32)
    (y, _), grads, _ = split_wkv6(*torch_of(arrs), torch.from_numpy(dy), terms=3)
    pallas = wkv6_pallas(*jax_of(arrs), interpret=True)
    ref, _ = wkv6_reference(*jax_of(arrs))
    for want in (pallas, ref):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-4, rtol=1e-3)
        assert_close_to_max(y.numpy(), want, 1e-5)
    _, vjp = jax.vjp(lambda *a: wkv6_reference(*a)[0], *jax_of(arrs))
    for name, got, want in zip(("dr", "dk", "dv", "dlogw", "du"), grads,
                               vjp(jnp.asarray(dy))):
        assert rel_norm(got.numpy(), want) <= 1e-5, name
