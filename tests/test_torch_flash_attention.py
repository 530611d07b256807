"""The port's flash attention (``repro_torch.kernels.flash_attention``) held
against the JAX package: the plain forward against ``flash_attention_pallas``
in interpret mode and against ``mha_reference``, the plain backward against
``jax.vjp`` of ``mha_reference``, the autograd function by ``gradcheck``,
the port's wrappers against the JAX ``ops`` wrappers, the dense attention
oracle ``layers.attention_reference`` against ``mha_reference``, the dense
LM trained through the function against the reference's loss and
gradients, and the kernels' split TF32 products emulated on the CPU
against the plain forward and backward (and plain TF32 shown to miss the
card's limits).

Inputs are made with numpy from a seed and handed to both sides. On the CPU
the wrappers take their plain versions; the CUDA kernels are held against
those on the card by ``chip_smoke.py``. Tolerances: the forward uses the
reference's own (``tests/test_kernels.py:35,76-77``: atol 2e-5 / rtol 2e-4
in f32, atol 2e-2 / rtol 0.2 in bf16); lse atol 1e-5; the backward atol and
rtol 1e-4 in f32 (both sides sum in f32, in other orders).
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.kernels import ops as jax_ops
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ref import mha_reference as jax_mha_reference
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_arch
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import quant_ring as qr
from repro_torch.models import layers as L
from repro_torch.models.model import build_model
from repro_torch.models.module import _flatten, _unflatten, params_from_reference

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def inputs(seed, b, sq, skv, hq, hkv, d, dtype="float32"):
    """``(q, k, v)`` as f32 numpy arrays rounded to ``dtype``'s values."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for s, h in ((sq, hq), (skv, hkv), (skv, hkv))]
    if dtype == "bfloat16":
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in arrs]
    return arrs


def to_torch(arrs, dtype):
    return [torch.from_numpy(a.copy()).to(TORCH_DTYPE[dtype]) for a in arrs]


def to_jax(arrs, dtype):
    return [jnp.asarray(a, JAX_DTYPE[dtype]) for a in arrs]


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# every head_dim the registered dense configs give, each masking, each dtype;
# GQA groups, ragged lengths and block sizes cycle through the cases
MASKS = [(True, None), (True, "window"), (False, None)]
FWD_CASES = [
    (dtype, causal, window, group, d, s, block)
    for i, (dtype, (causal, window), d) in enumerate(itertools.product(
        ("float32", "bfloat16"), MASKS, (32, 64, 80, 128)))
    for group, s, block in [((1, 2, 4)[i % 3], (33, 192, 300)[(i // 3) % 3],
                             (32, 64, 128)[(i // 2) % 3])]
]


@pytest.mark.parametrize("dtype,causal,window,group,d,s,block", FWD_CASES)
def test_plain_forward_matches_pallas_and_reference(dtype, causal, window,
                                                    group, d, s, block):
    window = (24 if s == 33 else 96) if window else None
    hkv = 2 if group < 4 else 1
    arrs = inputs(d + s, 2, s, s, hkv * group, hkv, d, dtype)
    q, k, v = to_torch(arrs, dtype)
    out, lse = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                        block_k=block)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (2, hkv * group, s)
    jq, jk, jv = to_jax(arrs, dtype)
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                    block_q=block, block_k=block,
                                    interpret=True)
    ref = jax_mha_reference(jq, jk, jv, causal=causal, window=window)
    tol = TOL[dtype]
    for want in (pallas, ref):
        np.testing.assert_allclose(f32(out), f32(want), atol=tol, rtol=tol * 10)
    # lse against the reference's masked scaled scores
    kr = jnp.repeat(jk.astype(jnp.float32), group, axis=2)
    scores = jnp.einsum("bqhd,bkhd->bhqk", jq.astype(jnp.float32), kr) / np.sqrt(d)
    pos = jnp.arange(s)
    mask = jnp.ones((s, s), bool)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    want_lse = jax.nn.logsumexp(jnp.where(mask, scores, -1e30), axis=-1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("causal,window,hq,hkv,d,s,block", [
    (True, None, 4, 4, 32, 33, 32),
    (True, None, 4, 2, 64, 192, 64),
    (True, 40, 4, 1, 80, 300, 128),
    (True, 96, 8, 2, 128, 192, 64),
    (False, None, 4, 2, 32, 300, 64),
    (False, None, 2, 1, 80, 33, 128),
    (False, 24, 4, 4, 64, 70, 32),
])
def test_plain_backward_matches_jax_vjp(causal, window, hq, hkv, d, s, block):
    arrs = inputs(7 * d + s, 2, s, s, hq, hkv, d)
    q, k, v = to_torch(arrs, "float32")
    do = np.random.default_rng(s).standard_normal((2, s, hq, d)).astype(np.float32)
    o, lse = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                      block_k=block)
    dq, dk, dv = fa.flash_attention_bwd_plain(
        q, k, v, o, lse, torch.from_numpy(do), causal=causal, window=window)
    _, vjp = jax.vjp(lambda a, b, c: jax_mha_reference(
        a, b, c, causal=causal, window=window), *to_jax(arrs, "float32"))
    for got, want in zip((dq, dk, dv), vjp(jnp.asarray(do))):
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
    # the delta F2 computes, and through autograd the same gradients as from
    # the default forward's O and lse
    np.testing.assert_allclose(
        fa.bwd_preprocess_plain(o, torch.from_numpy(do)).numpy(),
        np.einsum("bshd,bshd->bhs", o.numpy(), do), atol=1e-5, rtol=1e-5)
    o, lse = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    wants = fa.flash_attention_bwd_plain(q, k, v, o, lse, torch.from_numpy(do),
                                         causal=causal, window=window)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.flash_attention(*leaves, causal=causal,
                       window=window).backward(torch.from_numpy(do))
    for leaf, want in zip(leaves, wants):
        np.testing.assert_array_equal(leaf.grad.numpy(), want.numpy())


@pytest.mark.parametrize("causal,window,hq,hkv", [(True, None, 2, 1),
                                                  (True, 3, 2, 2),
                                                  (False, None, 4, 2),
                                                  (False, 4, 2, 1)])
def test_autograd_function_gradcheck_f64(causal, window, hq, hkv):
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 7, h, 4)))
               .requires_grad_(True) for h in (hq, hkv, hkv))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention(a, b, c, causal=causal, window=window),
        (q, k, v))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 9), (False, None)])
def test_torch_mha_reference_matches_jax(causal, window):
    """The port's dense oracle is the reference's ``mha_reference``."""
    arrs = inputs(3, 2, 21, 21, 4, 2, 16)
    got = L.attention_reference(*to_torch(arrs, "float32"), causal=causal,
                                window=window)
    want = jax_mha_reference(*to_jax(arrs, "float32"), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,window,block", [(True, None, 64),
                                                 (True, 48, 32),
                                                 (False, None, 128)])
def test_ops_flash_attention_matches_jax_ops(causal, window, block):
    """The port's public wrapper (one tiling on the card) against JAX's
    ``ops.flash_attention`` at each of its block sizes."""
    arrs = inputs(5, 1, 128, 128, 4, 2, 32)
    got = fa.flash_attention(*to_torch(arrs, "float32"), causal=causal,
                             window=window)
    want = jax_ops.flash_attention(*to_jax(arrs, "float32"), causal=causal,
                                   window=window, block_q=block, block_k=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("with_acc", [False, True])
def test_ops_quant_wrappers_match_jax_ops(with_acc):
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((6, 256)) * 3).astype(np.float32)
    x[1] = 0.0
    q, s = qr.quantize_pack(torch.from_numpy(x))
    jq, js = jax_ops.quantize_blockwise(jnp.asarray(x))
    # ROADMAP C4: XLA may divide through a reciprocal (an ulp of a scale)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    assert np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int)).max() <= 1
    acc = rng.standard_normal((6, 256)).astype(np.float32) if with_acc else None
    got = qr.dequant_accumulate(q, s, None if acc is None else torch.from_numpy(acc))
    want = jax_ops.dequant_accumulate(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                                      None if acc is None else jnp.asarray(acc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_other_devices_raise_and_cpu_launches_nothing():
    meta = [torch.empty((1, 8, 2, 32), device="meta") for _ in range(3)]
    with pytest.raises(ValueError, match="meta"):
        fa.flash_attention(*meta)
    # the dense LM's attention off the CPU goes to the kernels, never to the
    # plain forms, with a query offset too
    with pytest.raises(ValueError, match="meta"):
        L.attention(*meta)
    with pytest.raises(ValueError, match="meta"):
        L.attention(*meta, q_offset=3)
    cpu = [torch.zeros(1, 8, 2, 32) for _ in range(3)]
    with pytest.raises(ValueError, match="devices"):
        fa.flash_attention(cpu[0], cpu[1], meta[2])
    fa.reset_launches()
    fa.flash_attention(*[t.requires_grad_(True) for t in cpu]).sum().backward()
    assert not any(fa.LAUNCHES.values()) and len(fa.LAUNCHES) == 4


@pytest.mark.parametrize("shape_q,shape_k,dtype,window,match", [
    ((1, 8, 2, 48), (1, 8, 2, 48), torch.float32, None, "head_dim"),
    ((1, 8, 2, 32), (1, 8, 2, 32), torch.float16, None, "f32 or bf16"),
    ((1, 8, 2, 32), (1, 8, 2, 32), torch.float64, None, "f32 or bf16"),
    ((1, 8, 3, 32), (1, 8, 2, 32), torch.float32, None, "q_heads"),
    ((1, 20, 2, 32), (1, 8, 2, 32), torch.float32, 4, "see no key"),
    ((1, 8, 2, 32), (1, 8, 2, 32), torch.float32, 0, "window"),
])
def test_kernel_arguments_refused(shape_q, shape_k, dtype, window, match):
    """What the CUDA route checks before a launch (the checks run on any
    tensor, so they are tested here)."""
    q = torch.zeros(shape_q, dtype=dtype)
    k = torch.zeros(shape_k, dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        fa._kernel_args(q, k, k, True, window)


def test_kernel_arguments_of_the_main_path():
    q, k = torch.zeros(2, 1024, 16, 128), torch.zeros(2, 1024, 8, 128)
    args = fa._kernel_args(q, k, k, True, None)
    assert args[:8] == [2, 1024, 1024, 16, 8, 128, 1, 0] and args[9] == 0
    assert args[8] == pytest.approx(128 ** -0.5)
    bf = torch.zeros(1, 5120, 32, 80, dtype=torch.bfloat16)
    assert fa._kernel_args(bf, bf[:, :, :8], bf[:, :, :8], True, 4096)[7:] == [
        4096, pytest.approx(80 ** -0.5), 1]


@pytest.mark.parametrize("arch,window", [("qwen3-0.6b", None),
                                         ("h2o-danube-1.8b", 5)])
def test_dense_lm_trains_through_flash_attention(monkeypatch, arch, window):
    """Loss and grads of the reduced dense LM with its attention through
    :func:`flash_attention` (the path a CUDA tensor takes, here on its plain
    versions), against ``jax.value_and_grad`` of the reference's loss; remat
    on, so the forward runs again inside backward. The window is cut so
    that it bites at 16 tokens. Grads as in ``tests/test_torch_model.py``:
    elementwise with qk-norm, else per leaf within 1e-3 of its largest value
    (measured 3.2e-5 here; the port's plain attention gives 4.2e-5)."""
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced(), remat=True,
                               sliding_window=window)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(2), dtype=jnp.float32)
    batch = JaxTokens(jcfg.vocab, 16, 2, seed=4).batch(0)
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(jparams, batch)
    cfg = dataclasses.replace(get_arch(arch).reduced(), remat=True,
                              sliding_window=window)
    model = build_model(cfg)
    params = params_from_reference(jax.tree.map(np.asarray, jparams), "cpu")
    calls = []

    def through_kernel(q, k, v, *, causal=True, window=None, q_offset=0, chunk=1024):
        calls.append(window)
        assert q_offset == 0
        return fa.flash_attention(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(L, "attention", through_kernel)
    leaves = {p: t.clone().requires_grad_(True) for p, t in _flatten(params)}
    loss = model.loss(_unflatten(leaves), {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert calls == [window] * (2 * cfg.n_layers)   # forward, then its recompute
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5,
                               atol=1e-5)
    want = dict(_flatten(jax.tree.map(np.asarray, jgrads)))
    for path, g in zip(leaves, grads):
        if cfg.qk_norm:
            np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4,
                                       atol=1e-6, err_msg=path)
        else:
            gap = float(np.abs(g.numpy() - want[path]).max())
            assert gap <= 1e-3 * float(np.abs(want[path]).max()), (path, gap)


def test_launch_counters_are_the_kernels():
    assert set(fa.LAUNCHES) == {"flash_attention_fwd",
                                "flash_attention_bwd_preprocess",
                                "flash_attention_bwd_dkdv",
                                "flash_attention_bwd_dq"}
    assert not set(fa.LAUNCHES) & set(qr.LAUNCHES)


# ---------------------------------------------------------------------------
# F3's and F4's products on the tensor cores in split TF32, emulated
# ---------------------------------------------------------------------------

def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on f32 bits: 10 mantissa bits, to nearest, ties
    away from zero (add half of the 13 dropped bits' weight, then drop them)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_mm(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """``a @ b`` as the kernels' mma does it: with 3 terms each operand is
    split into hi = tf32(x) and lo = tf32(x - hi), and lo.hi + hi.lo is
    summed before hi.hi; with 1 term, hi.hi alone (plain TF32). The products
    of TF32 values are exact in f32; the sums are f32."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    if terms == 1:
        return ah @ bh
    return (tf32_rna(a - ah) @ bh + ah @ tf32_rna(b - bh)) + ah @ bh


def split_bwd(q, k, v, do, lse, delta, causal, window, terms):
    """``(dQ, dK, dV)`` as F3 and F4 form them: S = scale (Q K^T), dP = dO V^T,
    P = exp(S - lse) (0 where masked), dS = P (dP - delta), dQ = scale (dS K),
    dK = scale (dS^T Q) and dV = P^T dO summed over each kv head's group,
    every product through :func:`tf32_mm`."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group, scale = hq // hkv, d ** -0.5

    def heads(x):  # (B, S, H, D) -> (B, Hq, S, D)
        return x.permute(0, 2, 1, 3).repeat_interleave(hq // x.shape[2], dim=1)

    qh, kh, vh, doh = (heads(x) for x in (q, k, v, do))
    mask = fa._visible(torch.arange(sq), torch.arange(skv), skv, causal, window)
    s = tf32_mm(qh, kh.transpose(-1, -2), terms) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (tf32_mm(doh, vh.transpose(-1, -2), terms) - delta[..., None])
    dq = tf32_mm(ds, kh, terms) * scale
    dk = tf32_mm(ds.transpose(-1, -2), qh, terms) * scale
    dv = tf32_mm(p.transpose(-1, -2), doh, terms)

    def back(x, h):  # (B, Hq, S, D) summed over the group -> (B, S, h, D)
        return x.reshape(b, h, hq // h, x.shape[2], d).sum(2).permute(0, 2, 1, 3)

    return back(dq, hq), back(dk, hkv), back(dv, hkv)


def test_tf32_rounding_is_cvt_rna():
    one = 1.0
    x = torch.tensor([one, one + 2 ** -11, one + 2 ** -11 - 2 ** -23,
                      one + 3 * 2 ** -11, -(one + 2 ** -11), 2.0 ** -130, 0.0])
    want = torch.tensor([one, one + 2 ** -10, one, one + 2 ** -9,
                         -(one + 2 ** -10), 2.0 ** -130, 0.0])
    assert torch.equal(tf32_rna(x), want)
    # a bf16 value is exact in TF32: its lo is 0, as the kernels take it
    r = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    b = r.to(torch.bfloat16).float()
    assert torch.equal(tf32_rna(b), b)
    # and hi + lo keeps 21 or more bits of any f32
    hi = tf32_rna(r)
    assert float(((hi + tf32_rna(r - hi) - r).abs() / r.abs()).max()) < 2 ** -21


@pytest.mark.parametrize("d", [64, 128])
def test_split_tf32_backward_within_plain_and_one_term_not(d):
    """The three-term split puts dQ, dK and dV within 1e-5 relative norm of
    the plain f32 versions; plain TF32 (one term) misses the card's f32
    limit of 1e-4 (``chip_smoke.FA_BWD_TOL``), so a product left unsplit
    fails the smoke. Causal GQA, inputs drawn as the smoke draws them."""
    rng = np.random.default_rng(d)
    b, s, hq, hkv = 1, 256, 4, 2
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                   for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d),
                                 (b, s, hq, d)))
    o, lse = fa.flash_attention_plain(q, k, v, causal=True)
    delta = fa.bwd_preprocess_plain(o, do)
    dk, dv = fa.bwd_dkdv_plain(q, k, v, do, lse, delta, causal=True)
    want = (fa.bwd_dq_plain(q, k, v, do, lse, delta, causal=True), dk, dv)

    def rel(got):
        return [float((a - w).norm() / w.norm()) for a, w in zip(got, want)]

    split = rel(split_bwd(q, k, v, do, lse, delta, True, None, terms=3))
    one = rel(split_bwd(q, k, v, do, lse, delta, True, None, terms=1))
    assert max(split) < 1e-5, split
    assert min(one) > 1e-4, one


def split_fwd(q, k, v, causal, window, terms, stage=16):
    """``(O, lse)`` as F1 forms them: over kv stages of ``stage`` keys, S =
    scale (Q K^T) through :func:`tf32_mm`, masked to -1e30; m' = max(m,
    rowmax S), P = exp(S - m'), corr = exp(m - m'), l = l corr + rowsum P,
    O = O corr + P V with each stage's P V through :func:`tf32_mm`, a fresh
    sum added in f32; O / max(l, 1e-30) and lse = m + log l. ``Skv`` a
    multiple of ``stage``."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]

    def heads(x):  # (B, S, H, D) -> (B, Hq, S, D)
        return x.permute(0, 2, 1, 3).repeat_interleave(hq // x.shape[2], dim=1)

    qh, kh, vh = (heads(x) for x in (q, k, v))
    m = torch.full((b, hq, sq), fa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qh)
    for k0 in range(0, skv, stage):
        kpos = torch.arange(k0, k0 + stage)
        s = tf32_mm(qh, kh[:, :, k0:k0 + stage].transpose(-1, -2), terms) * d ** -0.5
        s = torch.where(fa._visible(torch.arange(sq), kpos, skv, causal, window), s,
                        fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + tf32_mm(p, vh[:, :, k0:k0 + stage], terms)
        m = m_new
    o = acc / torch.clamp(l[..., None], min=1e-30)
    return o.permute(0, 2, 1, 3), m + torch.log(l)


@pytest.mark.parametrize("d", [64, 128])
def test_split_tf32_forward_within_plain_and_one_term_not(d):
    """F1's three-term split puts O and lse within the card's forward limit,
    2e-5 of their largest value (``chip_smoke.FA_FWD_TOL``), of the plain
    forward; plain TF32 (one term) puts O beyond it, so a product of F1 left
    unsplit fails the smoke. Causal GQA, inputs drawn as the smoke draws
    them."""
    rng = np.random.default_rng(10 + d)
    b, s, hq, hkv = 1, 256, 4, 2
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    want = fa.flash_attention_plain(q, k, v, causal=True)

    def over(got):  # each output's largest gap as a share of its largest value
        return [float((a - w).abs().max() / w.abs().max()) for a, w in zip(got, want)]

    split = over(split_fwd(q, k, v, True, None, terms=3))
    one = over(split_fwd(q, k, v, True, None, terms=1))
    assert max(split) < 2e-5, split
    assert one[0] > 2e-5, one


def test_forward_inputs_start_on_16_bytes():
    """F1 copies rows with 16-byte ``cp.async``, as F3 and F4 do: a
    contiguous input that starts off a 16-byte boundary is copied, with its
    values, and one on 16 bytes is passed as it is."""
    base = torch.randn(1 + 2 * 8 * 2 * 32)
    q = base[1:].view(2, 8, 2, 32)
    k = base[:-1].view(2, 8, 2, 32)
    assert q.data_ptr() % 16 != 0 and k.data_ptr() % 16 == 0
    ins = build.on_16_bytes(q, k)  # as F1 calls it
    assert all(t.data_ptr() % 16 == 0 for t in ins)
    assert torch.equal(ins[0], q) and ins[1] is k


def test_backward_inputs_start_on_16_bytes():
    """F3 and F4 copy rows with 16-byte ``cp.async``: a contiguous input
    that starts off a 16-byte boundary is copied, with its values."""
    base = torch.randn(1 + 2 * 8 * 2 * 32)
    q = base[1:].view(2, 8, 2, 32)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    lse = torch.zeros(2, 2, 8)
    _, ins = fa._bwd_inputs(q, q, q, q, lse, lse, True, None)
    assert all(t.data_ptr() % 16 == 0 for t in ins)
    assert all(torch.equal(t, q) for t in ins[:4])
