"""The port's SSD scan (``repro_torch.kernels.ssd_scan``) held against the
JAX package: the plain forward against ``ssd_scan_pallas`` in interpret
mode and against the sequential oracle ``ssd_reference`` (chunk 16, 32, 64
and 96, ragged S, the model's init decay and a weak decay), the chunk
states against the oracle's prefix states; the plain backward against
``jax.vjp`` of ``models/ssm.py::ssd_chunked`` and of ``ssd_reference``,
every input's gradient; the autograd function by ``gradcheck`` in f64; the
model's ``ssd_chunked`` with an initial and a final state against the
reference's; and the wrappers' routing and argument checks.

Inputs are made with numpy from a seed and handed to both sides. On the CPU
the wrappers take their plain versions; the CUDA kernels are held against
those on the card by ``chip_smoke.py``. Decay: "init" is the model's at
initialization (``A = -e``, A_log = 1, and dt = softplus(N(0, 1)), about
0.7: g falls about 2 a step, so ``exp(g)`` underflows within a few dozen
steps and the state carried across chunks weighs nothing); "model" is
``ssd_inputs``'s of ``tests/test_kernels.py`` (``A = -exp(0.5 N)``);
"weak" is ``A = -0.01``, where a chunk of 16 to 64 steps keeps
``exp(g_L)`` between about 0.5 and 0.9, so the carried state and its
gradient weigh in every output. Tolerances: the forward keeps the
reference's own limits (``tests/test_kernels.py:108``: atol 1e-4, rtol
1e-3) and is held to ``max|got - want| <= 1e-5 * max|want|`` as well
(measured at most 3.4e-6); the backward per input to a relative norm of
1e-4 (measured at most 6.1e-6, dA at init decay): both sides sum in f32,
in other orders.

S1's and S2's order of work, with every product in split TF32 on the tensor
cores, is emulated at the matrix level (``split_ssd``) and held against the
plain versions within the smoke's limits, and at one shape against the JAX
package; plain TF32 (one term) misses those limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_reference
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models.ssm import CONV_K as JAX_CONV_K
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import ssd_scan as S
from repro_torch.models import ssm
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


def ssd_inputs(seed, b=2, s=96, h=3, p=16, n=8, decay="model"):
    """``x, dt, A, Bm, Cm`` as f32 numpy arrays, scaled as the reference's
    ``ssd_inputs`` scales them; A by ``decay`` (module docstring)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0.0)
    A = {"model": -np.exp(0.5 * rng.standard_normal(h)),
         "init": np.full(h, -np.e),
         "weak": np.full(h, -0.01)}[decay]
    Bm, Cm = (0.5 * rng.standard_normal((b, s, n)) for _ in range(2))
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]


def torch_of(arrs):
    return [torch.from_numpy(a.copy()) for a in arrs]


def jax_of(arrs):
    return [jnp.asarray(a) for a in arrs]


def prefix(arrs, t):
    """The inputs cut to their first ``t`` steps (A stays whole)."""
    return [a[:, :t] if a.ndim > 1 else a for a in arrs]


def assert_close_to_max(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    gap, peak = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert np.isfinite(gap) and gap <= rel * peak, (gap, peak)


def rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_constants():
    assert ssm.CONV_K == JAX_CONV_K
    # the kernels' chunk: an L x L f32 tile at 64 is 16 KB of shared memory
    assert S.SSD_CHUNK == 64 and S.STATE_HEAD_DIMS == ((16, 32), (64, 64))


# the reference's chunks (16, 32, 96) and the kernels' (64), whole (96) and
# ragged (100) S; then init-like decay, where g spans up to ~190 over a
# chunk of 96, and weak decay over 2 to 7 chunks
@pytest.mark.parametrize("chunk,s,decay", [
    pytest.param(16, 96, "model", id="16-96"),
    pytest.param(32, 100, "model", id="32-100"),
    pytest.param(96, 96, "model", id="96-96"),
    pytest.param(64, 100, "model", id="64-100"),
    pytest.param(96, 100, "init", id="96-100-init"),
    pytest.param(16, 100, "weak", id="16-100-weak"),
    pytest.param(64, 150, "weak", id="64-150-weak")])
def test_plain_forward_matches_pallas_and_reference(chunk, s, decay):
    arrs = ssd_inputs(chunk + s, s=s, decay=decay)
    y, states, _ = S.ssd_scan_plain(*torch_of(arrs), chunk=chunk)
    lc = min(chunk, s)
    assert y.shape == (2, s, 3, 16) and y.dtype == torch.float32
    assert states.shape == (2, 3, -(-s // lc), 8, 16)
    pallas = ssd_scan_pallas(*jax_of(arrs), chunk=chunk, interpret=True)
    ref, _ = ssd_reference(*jax_of(arrs))
    for want in (pallas, ref):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-3)
        assert_close_to_max(y.numpy(), want, 1e-5)
    assert not states[:, :, 0].any()     # the first chunk starts from zero
    # the last chunk's start state, carried over every chunk before it
    if states.shape[2] > 1:
        _, want = ssd_reference(*jax_of(prefix(arrs, (s - 1) // lc * lc)))
        assert_close_to_max(states[:, :, -1].numpy(), want, 1e-5)


def test_weak_decay_keeps_the_carried_state():
    """The weak-decay inputs really carry the state: each chunk's decay
    ``exp(g_L)`` is between 0.4 and 0.95, and the readout of the carried
    state is a large part of y."""
    arrs = ssd_inputs(7, s=150, decay="weak")
    x, dt, A, Bm, Cm = torch_of(arrs)
    g_l = (dt[:, :64] * A).sum(dim=1)
    assert 0.4 < float(torch.exp(g_l).min()) and float(torch.exp(g_l).max()) < 0.95
    y, states, _ = S.ssd_scan_plain(x, dt, A, Bm, Cm)
    alone, _, _ = S.ssd_scan_plain(*(t[:, 64:128] if t.dim() > 1 else t
                                  for t in (x, dt, A, Bm, Cm)))
    gap = (y[:, 64:128] - alone).abs().max() / y[:, 64:128].abs().max()
    assert gap > 0.3 and states[:, :, 1].abs().max() > 1


def test_plain_states_match_reference_prefix_states():
    """``states[:, :, c]`` is the oracle's state after ``c * L`` steps."""
    arrs = ssd_inputs(5, s=96, decay="weak")
    _, states, _ = S.ssd_scan_plain(*torch_of(arrs), chunk=32)
    for c in (1, 2):
        _, want = ssd_reference(*jax_of(prefix(arrs, 32 * c)))
        assert_close_to_max(states[:, :, c].numpy(), want, 1e-5)


# the last three with weak decay over 2 to 7 chunks, where dS carried back
# across chunks (exp(g_L) dS, and exp(g_L) <S, dS> in dg) is a large part
# of every gradient; the reference's ssd_chunked runs at chunk 32, which
# keeps its unmasked exp(g_t - g_j) finite at init decay
@pytest.mark.parametrize("b,s,h,p,n,chunk,decay", [
    pytest.param(2, 96, 3, 16, 8, 64, "model", id="2-96-3-16-8-64"),
    pytest.param(1, 70, 2, 32, 16, 32, "init", id="1-70-2-32-16-32-init"),
    pytest.param(2, 37, 2, 8, 8, 16, "model", id="2-37-2-8-8-16"),
    pytest.param(1, 5, 1, 16, 8, 64, "model", id="1-5-1-16-8-64"),
    pytest.param(2, 96, 3, 16, 8, 16, "weak", id="2-96-3-16-8-16-weak"),
    pytest.param(2, 150, 2, 32, 16, 64, "weak", id="2-150-2-32-16-64-weak"),
    pytest.param(1, 100, 2, 16, 8, 32, "weak", id="1-100-2-16-8-32-weak")])
def test_plain_backward_matches_jax_vjp(b, s, h, p, n, chunk, decay):
    arrs = ssd_inputs(3 * s + p, b=b, s=s, h=h, p=p, n=n, decay=decay)
    dy = np.random.default_rng(s).standard_normal((b, s, h, p)).astype(np.float32)
    _, states, _ = S.ssd_scan_plain(*torch_of(arrs), chunk=chunk)
    got = S.ssd_scan_bwd_plain(*torch_of(arrs), states, torch.from_numpy(dy),
                               chunk=chunk)
    for oracle in (lambda *a: jax_ssd_chunked(*a, chunk=32)[0],
                   lambda *a: ssd_reference(*a)[0]):
        _, vjp = jax.vjp(oracle, *jax_of(arrs))
        for name, g, want in zip(("dx", "ddt", "dA", "dB", "dC"), got,
                                 vjp(jnp.asarray(dy))):
            assert g.shape == want.shape and g.dtype == torch.float32, name
            assert rel_norm(g.numpy(), want) <= 1e-4, name


def test_autograd_function_uses_the_plain_versions():
    arrs = ssd_inputs(8, s=80, decay="weak")
    dy = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 80, 3, 16)).astype(np.float32))
    leaves = [t.requires_grad_(True) for t in torch_of(arrs)]
    y, _ = S.ssd_scan(*leaves)
    want_y, states, _ = S.ssd_scan_plain(*torch_of(arrs))
    np.testing.assert_array_equal(y.detach().numpy(), want_y.numpy())
    y.backward(dy)
    wants = S.ssd_scan_bwd_plain(*torch_of(arrs), states, dy)
    for leaf, want in zip(leaves, wants):
        np.testing.assert_array_equal(leaf.grad.numpy(), want.numpy())


# the weak-decay case checks the gradient through the carried state where
# it is not negligible: over three chunks, so that dS is carried across one
# chunk into another (with two, the carried term multiplies a zero dS)
@pytest.mark.parametrize("s,note,decay", [
    pytest.param(7, "one ragged chunk", "init", id="7-one ragged chunk"),
    pytest.param(40, "one chunk", "model", id="40-one chunk"),
    pytest.param(140, "three chunks, the last ragged, weak decay", "weak",
                 id="140-three chunks, the last ragged, weak decay")])
def test_autograd_function_gradcheck_f64(s, note, decay):
    arrs = ssd_inputs(s, b=1, s=s, h=2, p=3, n=2, decay=decay)
    ins = [torch.from_numpy(a.astype(np.float64)).requires_grad_(True)
           for a in arrs]
    assert torch.autograd.gradcheck(S.ssd_scan, ins), note


def test_model_ssd_chunked_matches_reference_with_state():
    """The model's plain SSD, with an initial state and the final state
    out, against the reference's ``ssd_chunked``; and from a zero state
    against the kernels' plain version."""
    arrs = ssd_inputs(2, s=70, decay="weak")
    state0 = np.random.default_rng(4).standard_normal((2, 3, 8, 16)).astype(
        np.float32)
    y, final = ssm.ssd_chunked(*torch_of(arrs), chunk=32,
                               initial_state=torch.from_numpy(state0))
    jy, jfinal = jax_ssd_chunked(*jax_of(arrs), chunk=32,
                                 initial_state=jnp.asarray(state0))
    assert_close_to_max(y.numpy(), jy, 1e-5)
    assert_close_to_max(final.numpy(), jfinal, 1e-5)
    y0, final0 = ssm.ssd_chunked(*torch_of(arrs), chunk=32)
    _, jfinal0 = ssd_reference(*jax_of(arrs))
    assert_close_to_max(final0.numpy(), jfinal0, 1e-5)
    assert_close_to_max(S.ssd_scan_plain(*torch_of(arrs))[0].numpy(),
                        y0.numpy(), 1e-5)


def test_model_ssd_chunked_gradients_stay_finite_at_init_decay():
    """At the model's chunk of 256 and init decay g spans about 500 over a
    chunk: the masked exponent keeps every gradient finite, and they match
    the sequential oracle's."""
    arrs = ssd_inputs(9, b=1, s=256, h=2, p=8, n=4, decay="init")
    leaves = [t.requires_grad_(True) for t in torch_of(arrs)]
    y, _ = ssm.ssd_chunked(*leaves, chunk=256)
    dy = np.random.default_rng(2).standard_normal(tuple(y.shape)).astype(np.float32)
    y.backward(torch.from_numpy(dy))
    _, vjp = jax.vjp(lambda *a: ssd_reference(*a)[0], *jax_of(arrs))
    for leaf, want in zip(leaves, vjp(jnp.asarray(dy))):
        assert torch.isfinite(leaf.grad).all()
        assert rel_norm(leaf.grad.numpy(), want) <= 1e-4


def test_other_devices_raise_and_cpu_launches_nothing():
    meta = [torch.empty(shape, device="meta") for shape in
            ((1, 8, 2, 32), (1, 8, 2), (2,), (1, 8, 16), (1, 8, 16))]
    with pytest.raises(ValueError, match="meta"):
        S.ssd_scan(*meta)
    cpu = torch_of(ssd_inputs(0, b=1, s=8, h=2, p=32, n=16))
    with pytest.raises(ValueError, match="devices"):
        S.ssd_scan(*cpu[:4], meta[4])
    S.reset_launches()
    S.ssd_scan(*[t.requires_grad_(True) for t in cpu])[0].sum().backward()
    assert set(S.LAUNCHES) == {"ssd_fwd", "ssd_bwd"}
    assert not any(S.LAUNCHES.values())


@pytest.mark.parametrize("x_shape,dt_shape,a_shape,bc_shape,dtype,match", [
    ((1, 8, 2, 16), (1, 8, 2), (2,), (1, 8, 16), torch.float32, "head_dim"),
    ((1, 8, 2, 128), (1, 8, 2), (2,), (1, 8, 16), torch.float32, "head_dim"),
    ((1, 8, 2, 32), (1, 8, 2), (2,), (1, 8, 32), torch.float32, "state size"),
    ((1, 8, 2, 32), (1, 8, 2), (2,), (1, 8, 16), torch.float16, "f32 or bf16"),
    ((1, 8, 2, 32), (1, 8, 2), (2,), (1, 8, 16), torch.float64, "f32 or bf16"),
    ((1, 8, 2, 32), (1, 8, 2), (3,), (1, 8, 16), torch.float32, "A must be"),
    ((1, 8, 2, 32), (1, 8, 3), (2,), (1, 8, 16), torch.float32, "dt must be"),
    ((1, 8, 2, 32), (1, 8, 2), (2,), (1, 7, 16), torch.float32, "Bm and Cm"),
    ((1, 0, 2, 32), (1, 0, 2), (2,), (1, 0, 16), torch.float32, "S >= 1"),
    # each of N and P is taken, but only in the configs' pairs
    ((1, 8, 2, 64), (1, 8, 2), (2,), (1, 8, 16), torch.float32, "head_dim 64"),
    ((1, 8, 2, 32), (1, 8, 2), (2,), (1, 8, 64), torch.float32, "state size 64"),
])
def test_kernel_arguments_refused(x_shape, dt_shape, a_shape, bc_shape, dtype,
                                  match):
    """What the CUDA route checks before a launch (the checks run on any
    tensor, so they are tested here)."""
    x, dt, A, bc = (torch.zeros(shape, dtype=dtype)
                    for shape in (x_shape, dt_shape, a_shape, bc_shape))
    with pytest.raises((ValueError, TypeError), match=match):
        S._kernel_inputs(x, dt, A, bc, bc)


def test_kernel_arguments_of_the_main_path():
    """zamba2-1.2b's per-rank SSD at w=4: x is a view of a split of the
    conv output, which the wrapper copies into the kernels' layout."""
    xbc = torch.zeros(2, 1024, 4096 + 2 * 64)
    xs, bm, cm = torch.split(xbc, [4096, 64, 64], dim=-1)
    x = xs.reshape(2, 1024, 64, 64)
    dt, A = torch.zeros(2, 1024, 64), torch.zeros(64)
    assert not x.is_contiguous()
    ins, args = S._kernel_inputs(x, dt, A, bm, cm)
    assert args == [2, 1024, 64, 64, 64, 64, 0]
    assert all(t.is_contiguous() for t in ins) and ins[1] is dt
    assert ins[0].data_ptr() != x.data_ptr()
    bf = torch.zeros(4, 40, 8, 32, dtype=torch.bfloat16)
    bf_bc = torch.zeros(4, 40, 16, dtype=torch.bfloat16)
    ins, args = S._kernel_inputs(bf, torch.zeros(4, 40, 8), torch.zeros(8),
                                 bf_bc, bf_bc)
    assert args == [4, 40, 8, 32, 16, 40, 1] and ins[0].dtype == torch.bfloat16
    assert ins[1].dtype == ins[2].dtype == torch.float32
    # a mixed set is widened to f32, exactly
    ins, args = S._kernel_inputs(bf, torch.zeros(4, 40, 8), torch.zeros(8),
                                 bf_bc.float(), bf_bc)
    assert args[-1] == 0 and all(t.dtype == torch.float32 for t in ins)


# ---------------------------------------------------------------------------
# S1's and S2's order on the tensor cores in split TF32, emulated
# ---------------------------------------------------------------------------

def split_ssd(x, dt, A, Bm, Cm, dy, terms):
    """``(y, states)`` and ``(dx, ddt, dA, dB, dC)`` in the order of S1's and
    S2's stages, every product through :func:`tf32_mm` (``terms`` 3: the
    split the kernels run; 1: plain TF32): C B^T once per batch row and
    chunk; the chunk summaries ``(B ⊙ exp(g_L - g))^T xf``, the state pass,
    ``y = (C B^T ⊙ exp(g_t - g_j)) xf + exp(g) ⊙ (C S)``; the dS summaries
    ``(C ⊙ exp(g))^T dy``, the dS pass, then the chunk-local terms, with dg's
    state terms as the rows' dots of C and B with dC's and dB's state terms;
    g and the exponents of the decays in f64.
    The kernels' sums over 16 k a fresh accumulator are not emulated."""
    b, s, h, p, n = S._dims(x, dt, A, Bm, Cm)
    lc = min(S.SSD_CHUNK, s)
    xc, dtc, bc, cc, _ = S._chunk_all(x, dt, A, Bm, Cm, lc, torch.float32)
    dyc = S._chunks(dy, lc, torch.float32)
    # g and its differences in f64, as the kernels take them
    g = torch.cumsum(dtc.double() * A.double()[None, :, None, None], dim=-1)
    nc = xc.shape[2]

    def mm(a, b_):
        return tf32_mm(a, b_, terms)

    def t(m):
        return m.transpose(-1, -2)

    xf = xc * dtc[..., None]
    e = torch.exp(g).float()
    e_last, w = e[..., -1], torch.exp(g[..., -1:] - g).float()
    decay = S._pair_decay(g).float()
    cb = mm(cc, t(bc))                                 # (B, 1, nc, L, L)
    summary = mm(t(bc * w[..., None]), xf)             # (B, H, nc, N, P)
    states = [torch.zeros(b, h, n, p)]
    for c in range(1, nc):
        states.append(e_last[:, :, c - 1, None, None] * states[-1] + summary[:, :, c - 1])
    st = torch.stack(states, dim=2)
    y = mm(cb * decay, xf) + e[..., None] * mm(cc, st)
    read = mm(t(cc * e[..., None]), dyc)
    d_ends = [torch.zeros(b, h, n, p)]
    for c in range(nc - 2, -1, -1):
        d_ends.append(e_last[:, :, c + 1, None, None] * d_ends[-1] + read[:, :, c + 1])
    ds = torch.stack(d_ends[::-1], dim=2)
    gg = mm(dyc, t(xf)) * decay
    dxf = mm(t(cb * decay), dyc) + w[..., None] * mm(bc, ds)
    dc_state = e[..., None] * mm(dyc, t(st))
    db_state = w[..., None] * mm(xf, t(ds))
    dc = mm(gg, bc) + dc_state
    db = mm(t(gg), cc) + db_state
    strict = torch.tril(torch.ones(lc, lc, dtype=torch.bool), diagonal=-1)
    q = torch.where(strict, gg * cb, 0.0)
    r = (bc * db_state).sum(dim=-1)
    dg = q.sum(dim=-1) - q.sum(dim=-2) - r + (cc * dc_state).sum(dim=-1)
    dg[..., -1] += e_last * (st * ds).sum(dim=(-1, -2)) + r.sum(dim=-1)
    da = torch.flip(torch.cumsum(torch.flip(dg, [-1]), dim=-1), [-1])
    ddt = da * A[None, :, None, None] + (dxf * xc).sum(dim=-1)
    grads = (S._unchunk(dxf * dtc[..., None], s, torch.float32),
             S._unchunk(ddt[..., None], s, torch.float32)[..., 0],
             (da * dtc).sum(dim=(0, 2, 3)),
             S._unchunk(db.sum(dim=1, keepdim=True), s, torch.float32)[:, :, 0],
             S._unchunk(dc.sum(dim=1, keepdim=True), s, torch.float32)[:, :, 0])
    return (S._unchunk(y, s, torch.float32), st), grads


def split_errors(arrs, dy, terms):
    """The emulation's errors against the plain versions, as the smoke
    measures the kernels': y and the states as their largest gap over their
    largest value (the largest value itself where the plain one is all 0:
    one chunk's states), each gradient as its relative norm."""
    ins = torch_of(arrs)
    want_fwd = S.ssd_scan_plain(*ins)
    want_bwd = S.ssd_scan_bwd_plain(*ins, want_fwd[1], dy)
    got_fwd, got_bwd = split_ssd(*ins, dy, terms)
    fwd = [float((a - w_).abs().max() / w_.abs().max()) if bool(w_.abs().max() > 0)
           else float(a.abs().max()) for a, w_ in zip(got_fwd, want_fwd)]
    bwd = [rel_norm(a.numpy(), w_.numpy()) for a, w_ in zip(got_bwd, want_bwd)]
    return fwd, bwd


# the reduced model's S = 40 (one chunk of 40); ragged lengths over several
# chunks; both (N, P) pairs; the init decay, where the carried state weighs
# nothing, and the weak one, where it weighs in every output
@pytest.mark.parametrize("b,s,h,p,n,decay", [
    pytest.param(2, 40, 4, 32, 16, "init", id="reduced-40-init"),
    pytest.param(2, 40, 4, 32, 16, "weak", id="reduced-40-weak"),
    pytest.param(1, 200, 3, 32, 16, "weak", id="16-32-200-weak"),
    pytest.param(1, 150, 2, 64, 64, "weak", id="64-64-150-weak"),
    pytest.param(1, 100, 2, 64, 64, "init", id="64-64-100-init")])
def test_split_tf32_order_within_plain(b, s, h, p, n, decay):
    """S1's and S2's order with every product in split TF32 stays within
    the smoke's limits of the plain versions: y and the states within
    ``FA_FWD_TOL`` (2e-5) of their largest value, every gradient within
    1e-4 relative norm."""
    arrs = ssd_inputs(s + p + n, b=b, s=s, h=h, p=p, n=n, decay=decay)
    dy = torch.from_numpy(np.random.default_rng(s).standard_normal(
        (b, s, h, p)).astype(np.float32))
    fwd, bwd = split_errors(arrs, dy, terms=3)
    assert max(fwd) < 2e-5 and max(bwd) < 1e-4, (fwd, bwd)


def test_split_tf32_one_term_misses_the_limits():
    """Plain TF32 (hi.hi alone) puts the SSD's y beyond the smoke's forward
    limit and its gradients beyond 1e-4, at the weak decay over three
    chunks: a product left unsplit fails the smoke. The split stays far
    inside both. Emulated at S = 40 to 1024 and both (N, P) pairs, one
    term puts y at 4.2e-4 to 4.9e-4 of its largest value and the gradients
    at 3.3e-4 to 7.8e-4 relative norm; three terms at 3.8e-7 to 3.9e-6 and
    2.1e-7 to 1.5e-5 (the larger ones at init decay, from the plain
    version's f32 g, which the emulation takes in f64 as the kernels do)."""
    arrs = ssd_inputs(11, b=1, s=150, h=2, p=64, n=64, decay="weak")
    dy = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 150, 2, 64)).astype(np.float32))
    fwd, bwd = split_errors(arrs, dy, terms=1)
    split_fwd, split_bwd = split_errors(arrs, dy, terms=3)
    assert fwd[0] > 2e-5 and min(bwd) > 1e-4, (fwd, bwd)
    assert max(split_fwd) < 2e-5 / 10 and max(split_bwd) < 1e-4 / 10, (split_fwd, split_bwd)


def test_split_tf32_order_against_pallas_and_jax():
    """At one small shape (two chunks, the last ragged) the emulated order
    against the JAX package: y against ``ssd_scan_pallas`` in interpret mode
    at the kernels' chunk and against ``ssd_reference``, every gradient
    against ``jax.vjp`` of ``ssd_reference``."""
    arrs = ssd_inputs(12, b=2, s=100, h=2, p=32, n=16, decay="weak")
    dy = np.random.default_rng(12).standard_normal((2, 100, 2, 32)).astype(np.float32)
    (y, _), grads = split_ssd(*torch_of(arrs), torch.from_numpy(dy), terms=3)
    pallas = ssd_scan_pallas(*jax_of(arrs), chunk=S.SSD_CHUNK, interpret=True)
    ref, _ = ssd_reference(*jax_of(arrs))
    for want in (pallas, ref):
        assert_close_to_max(y.numpy(), want, 2e-5)
    _, vjp = jax.vjp(lambda *a: ssd_reference(*a)[0], *jax_of(arrs))
    for name, got, want in zip(("dx", "ddt", "dA", "dB", "dC"), grads, vjp(jnp.asarray(dy))):
        assert rel_norm(got.numpy(), want) <= 1e-4, name


def test_kernel_inputs_start_on_16_bytes():
    """The kernels read x, B and C rows 16 (f32) or 8 (bf16) bytes at a
    time: a contiguous input that starts off a 16-byte boundary is copied,
    with its values, and one on 16 bytes is passed as it is."""
    base = torch.randn(1 + 1 * 8 * 2 * 32)
    x = base[1:].view(1, 8, 2, 32)
    bc = torch.randn(1, 8, 16)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    ins, _ = S._kernel_inputs(x, torch.zeros(1, 8, 2), torch.zeros(2), bc, bc)
    assert all(t.data_ptr() % 16 == 0 for t in ins)
    assert torch.equal(ins[0], x) and ins[3] is bc
