"""The published Zamba2 block (Zamba2-7B, ``transformers``' ``modeling_zamba2.py``)
in the port's ``Zamba2LM``, on the CPU at a small size with the same
structure: six layers, hybrid layers 1, 3 and 5 (so that the two shared
blocks are used A, B, A), two B/C groups, per-use LoRA adapters of rank 8,
GeGLU, the concatenated input at head dim 32 and its scale ``(D / 2)^-1/2``,
the tied head.

The port is held against the benchmark's plain reference
(``perfbench/reference/zamba2.py``, which imports nothing of the port) on
the same seeded weights: the loss to a relative 1e-6 and every gradient
leaf to 2e-4 of the leaf's largest value. Both run in f32 and sum in other
orders: the reference's SSD at chunks of 64 and its attention by query
blocks, the port's SSD at its chunk of 8 and its attention whole, and the
norms, rope and conv each written otherwise. Measured on these weights: the
loss 8.6e-8 apart, the worst leaf (``mamba/dt_bias``, a sum over every
position of small terms) 5.0e-5 of its largest value; every other leaf under
1e-5. A dropped piece of the block moves the loss by 1e-3 or more and its
own leaves' gradients by far more than the limit. Each piece that sets the
published block apart (the alternation of the shared blocks, a use's
adapter reaching its own use alone, the shared output kept out of the
residual, the tied head) is also checked by a case that fails without it.

Beside the model: B9's plain versions and ``ssd_chunked`` with two B/C
groups equal to two one-group calls over the head halves, and the grouped
layout at one group equal to the ``(B, S, N)`` one; B4's plain versions with
a ``scale``; the configuration file's parameter count; the spans
``hybrid.shared`` and ``mamba.layer``; and the paths that take one group or
the first form only, which raise.
"""

import copy
import dataclasses
import json
import math
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench.kinds.train import port_config  # noqa: E402
from perfbench.reference import common  # noqa: E402
from perfbench.reference import zamba2 as ref  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as S  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.module import _flatten, init_from_specs  # noqa: E402

CONFIG = ROOT / "perfbench" / "configs" / "zamba2-7b-l12.json"
HEAD_DIM = 32
SIZES = {"num_hidden_layers": 6, "hidden_size": 64, "attention_hidden_size": 128,
         "num_attention_heads": 4, "num_key_value_heads": 4,
         "attention_head_dim": HEAD_DIM, "attention_scale": (HEAD_DIM / 2) ** -0.5,
         "intermediate_size": 96, "adapter_rank": 8, "hybrid_layer_ids": [1, 3, 5],
         "mamba_d_state": 16, "mamba_headdim": 16, "n_mamba_heads": 8,
         "vocab_size": 256}
FIELDS = {"n_layers": 6, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
          "head_dim": HEAD_DIM, "d_ff": 96, "vocab": 256, "ssm_state": 16,
          "ssm_head_dim": 16, "hybrid_layers": [1, 3, 5], "adapter_rank": 8,
          "ssm_chunk": 8}
SEQ, ROWS, SEED = 40, 2, 5
LOSS_RTOL = 1e-6
LEAF_TOL = 2e-4


def _conf(remat: bool = False):
    conf = copy.deepcopy(json.loads(CONFIG.read_text()))
    conf["sizes"].update(SIZES)
    conf["port"]["fields"].update(FIELDS, remat=remat)
    return conf


def _model(remat: bool = False):
    conf = _conf(remat)
    return conf, build_model(port_config(conf))


def _weights(conf, seed: int = SEED):
    return common.draw(ref.layout(conf["sizes"]), seed, "cpu")


def _batch(seed: int = SEED):
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, SIZES["vocab_size"] // 2, (ROWS, SEQ), generator=gen)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}


def _port_loss(model, weights, batch):
    return model.loss(common.nest(weights), batch)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_leaf_match_the_reference(remat):
    conf, model = _model(remat)
    weights, batch = _weights(conf), _batch()
    assert set(dict(_flatten(model.param_specs()))) == set(weights)
    theirs = {p: t.clone().requires_grad_(True) for p, t in weights.items()}
    ref_loss = ref.loss(conf["sizes"], theirs, batch["tokens"], batch["labels"])
    ref_grads = torch.autograd.grad(ref_loss, list(theirs.values()))
    mine = {p: t.clone().requires_grad_(True) for p, t in weights.items()}
    loss = _port_loss(model, mine, batch)
    grads = torch.autograd.grad(loss, list(mine.values()))
    assert float(loss) == pytest.approx(float(ref_loss), rel=LOSS_RTOL)
    for path, g, r in zip(mine, grads, ref_grads):
        assert float(r.abs().max()) > 0, path
        assert float((g - r).abs().max()) <= LEAF_TOL * float(r.abs().max()), path


def _spied_uses(model, weights, batch, monkeypatch):
    """``(block, use) -> output`` of every shared-block use of a forward."""
    seen = {}
    inner = ssm.Zamba2LM._shared_use

    def spy(self, bp, up, h, emb, positions, block, use):
        out = inner(self, bp, up, h, emb, positions, block, use)
        seen[(block, use)] = out.detach()
        return out

    monkeypatch.setattr(ssm.Zamba2LM, "_shared_use", spy)
    with torch.no_grad():
        loss = _port_loss(model, weights, batch)
    monkeypatch.setattr(ssm.Zamba2LM, "_shared_use", inner)
    return float(loss), seen


def test_shared_blocks_alternate(monkeypatch):
    conf, model = _model()
    weights, batch = _weights(conf), _batch()
    loss, seen = _spied_uses(model, weights, batch, monkeypatch)
    assert list(seen) == [(0, 0), (1, 1), (0, 2)]
    # block B's weights reach the loss (with every use on block A they would not)
    weights["shared/wq"][1].mul_(2.0)
    moved, _ = _spied_uses(model, weights, batch, monkeypatch)
    assert abs(moved - loss) > 1e-4
    assert abs(moved - ref.loss(conf["sizes"], weights, batch["tokens"],
                                batch["labels"]).item()) <= LOSS_RTOL * abs(moved)


@pytest.mark.parametrize("use", [0, 1, 2])
def test_an_adapter_reaches_its_own_use_alone(use, monkeypatch):
    conf, model = _model()
    weights, batch = _weights(conf), _batch()
    _, before = _spied_uses(model, weights, batch, monkeypatch)
    weights["uses/lora_b"][use].mul_(3.0)
    _, after = _spied_uses(model, weights, batch, monkeypatch)
    for key in before:
        changed = not torch.equal(before[key], after[key])
        # a later use reads the hidden state that the changed use moved
        assert changed == (key[1] >= use), (key, use)
    # the use's own output moves at once: its adapter is in its own MLP
    first = [k for k in before if k[1] == use][0]
    assert float((after[first] - before[first]).abs().max()) > 1e-4


@pytest.mark.parametrize("use,layer", [(0, 1), (1, 3), (2, 5)])
def test_shared_output_stays_out_of_the_residual(use, layer):
    """With the hybrid layer's own Mamba output zeroed, its use's output can
    reach the loss only by the residual: the published block keeps it out,
    so zeroing the use's ``linear`` changes nothing."""
    conf, model = _model()
    weights, batch = _weights(conf), _batch()
    weights["mamba/out_proj"][layer].zero_()
    with torch.no_grad():
        kept = float(_port_loss(model, weights, batch))
        weights["uses/linear"][use].zero_()
        dropped = float(_port_loss(model, weights, batch))
        # and at the next hybrid layer's own weights the use does matter
        weights = _weights(conf)
        base = float(_port_loss(model, weights, batch))
        weights["uses/linear"][use].zero_()
        moved = float(_port_loss(model, weights, batch))
    assert kept == dropped
    assert abs(moved - base) > 1e-5


def test_the_head_is_the_embedding():
    conf, model = _model()
    assert "lm_head" not in dict(_flatten(model.param_specs()))
    weights, batch = _weights(conf), _batch()
    unseen = SIZES["vocab_size"] - 1            # never a token of the batch
    assert not bool((batch["tokens"] == unseen).any())
    with torch.no_grad():
        base = float(_port_loss(model, weights, batch))
        weights["embed"][unseen].mul_(50.0)     # reaches the loss by the head alone
        moved = float(_port_loss(model, weights, batch))
    assert abs(moved - base) > 1e-4


def test_configuration_counts_and_the_ten():
    conf = json.loads(CONFIG.read_text())
    cfg = port_config(conf)
    assert cfg.n_params() == conf["parameters"] == 1_757_853_120
    assert dataclasses.replace(cfg, n_layers=81, hybrid_layers=conf["hybrid_layer_ids"]
                               ).n_params() == 7_356_749_648
    assert len(list_archs()) == 10 and get_arch("zamba2-1.2b").hybrid_layers == ()
    assert cfg.attn_width == 7168 and cfg.n_ssm_heads == 112
    specs = dict(_flatten(build_model(cfg).param_specs()))
    assert specs["shared/wq"].shape == (2, 7168, 32, 224)
    assert specs["mamba/in_proj"].shape == (12, 3584, 2 * 7168 + 2 * 2 * 64 + 112)
    assert specs["uses/lora_b"].shape == (2, 128, 2 * 14336)


@pytest.mark.parametrize("name,value", [
    ("ssm_groups", 4), ("hybrid_layers", (2, 5)), ("n_shared_blocks", 3),
    ("adapter_rank", 16), ("norm_eps", 1e-6)])
def test_init_only_settings_count_in_equality_and_copies(name, value):
    """The init-only settings are no dataclass fields (the registered
    configs' ``asdict`` stays the JAX package's), yet a config that differs
    in one is another config: ``==``, ``hash``, ``repr`` and the
    ``as_dict`` copy through JSON take them in."""
    cfg = port_config(json.loads(CONFIG.read_text()))
    other = dataclasses.replace(cfg, **{name: value})
    assert getattr(other, name) == value and other != cfg
    assert dataclasses.asdict(other) == dataclasses.asdict(cfg)
    assert f"{name}={value!r}" in repr(other)
    assert len({cfg, other, dataclasses.replace(other)}) == 2
    for c in (cfg, other):
        again = ArchConfig(**json.loads(json.dumps(c.as_dict())))
        assert again == c and hash(again) == hash(c)


def _ssd_inputs(groups: int, b=2, s=50, h=6, p=8, n=4, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen))
    A = -torch.exp(torch.randn(h, generator=gen))
    Bm, Cm = (torch.randn(b, s, groups, n, generator=gen) for _ in range(2))
    dy = torch.randn(b, s, h, p, generator=gen)
    return x, dt, A, Bm, Cm, dy


def _halves(x, dt, A, Bm, Cm, i, h):
    sl = slice(i * h, (i + 1) * h)
    return x[:, :, sl], dt[:, :, sl], A[sl], Bm[:, :, i], Cm[:, :, i]


def test_grouped_ssd_is_two_calls_over_the_head_halves():
    x, dt, A, Bm, Cm, _ = _ssd_inputs(2)
    y, _, final = S.ssd_scan_plain(x, dt, A, Bm, Cm)
    parts = [S.ssd_scan_plain(*_halves(x, dt, A, Bm, Cm, i, 3)) for i in range(2)]
    assert torch.equal(y, torch.cat([p[0] for p in parts], dim=2))
    assert torch.equal(final, torch.cat([p[2] for p in parts], dim=1))


@pytest.mark.parametrize("other", ["ssd_scan_plain", "reference"])
def test_grouped_ssd_chunked_matches_an_independent_scan(other):
    """``ssd_chunked`` at two groups (G calls over the head slices) against
    B9's plain version, which reads each head's group in one pass, and the
    benchmark's reference, which repeats each group over its heads: the
    same y (and final state) to f32 rounding, at another chunk each."""
    x, dt, A, Bm, Cm, _ = _ssd_inputs(2)
    y, final = ssm.ssd_chunked(x, dt, A, Bm, Cm, 16)
    if other == "ssd_scan_plain":
        want, _, want_final = S.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=32)
        torch.testing.assert_close(final, want_final, rtol=1e-5, atol=1e-5)
    else:
        heads = x.shape[2] // Bm.shape[2]
        want = ref._ssd(x, dt, A, Bm.repeat_interleave(heads, dim=2),
                        Cm.repeat_interleave(heads, dim=2))
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    # the groups differ: one group's B and C for every head is another scan
    one = ssm.ssd_chunked(x, dt, A, Bm[:, :, :1], Cm[:, :, :1], 16)[0]
    assert float((one - y).abs().max()) > 1e-2


def test_grouped_ssd_backward_is_two_calls_over_the_head_halves():
    x, dt, A, Bm, Cm, dy = _ssd_inputs(2)
    states = S.ssd_scan_plain(x, dt, A, Bm, Cm)[1]
    dx, ddt, dA, dB, dC, _ = S.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, states, dy)
    parts = []
    for i in range(2):
        args = _halves(x, dt, A, Bm, Cm, i, 3)
        st = S.ssd_scan_plain(*args)[1]
        parts.append(S.ssd_scan_bwd_plain(*args, st, dy[:, :, 3 * i:3 * i + 3]))
    for got, dim, k in ((dx, 2, 0), (ddt, 2, 1), (dA, 0, 2)):
        torch.testing.assert_close(got, torch.cat([p[k] for p in parts], dim=dim),
                                   rtol=0, atol=0)
    for got, k in ((dB, 3), (dC, 4)):
        torch.testing.assert_close(got, torch.stack([p[k] for p in parts], dim=2),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("fn", ["ssd_chunked", "ssd_scan_plain", "ssd_scan_bwd_plain"])
def test_one_group_in_the_grouped_layout_is_the_shared_layout(fn):
    x, dt, A, Bm, Cm, dy = _ssd_inputs(1)
    flat = (x, dt, A, Bm[:, :, 0], Cm[:, :, 0])
    grouped = (x, dt, A, Bm, Cm)
    if fn == "ssd_chunked":
        outs = [ssm.ssd_chunked(*a, 16) for a in (flat, grouped)]
    elif fn == "ssd_scan_plain":
        outs = [S.ssd_scan_plain(*a) for a in (flat, grouped)]
    else:
        states = S.ssd_scan_plain(*flat)[1]
        outs = [S.ssd_scan_bwd_plain(*a, states, dy)[:5] for a in (flat, grouped)]
    for a, b in zip(*outs):
        assert torch.equal(a.reshape(b.shape), b)


def _causal_attention(q, k, v, scale):
    """Causal softmax attention in q's dtype (f64 here), scores times
    ``scale``."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    n = q.shape[1]
    seen = torch.ones(n, n, dtype=torch.bool).tril()
    probs = torch.softmax(torch.where(seen, scores, -math.inf), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


@pytest.mark.parametrize("d", [32, 224])
def test_flash_attention_plain_versions_take_a_scale(d):
    gen = torch.Generator().manual_seed(d)
    q, k, v, do = (torch.randn(1, 20, 2, d, generator=gen, dtype=torch.float64)
                   for _ in range(4))
    scale = (d / 2) ** -0.5
    o, lse = fa.flash_attention_plain(q, k, v, scale=scale, block_k=8)
    torch.testing.assert_close(o, _causal_attention(q, k, v, scale), rtol=1e-12, atol=1e-12)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(_causal_attention(*leaves, scale), leaves, do)
    mine = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale=scale)
    for g, w in zip(mine, grads):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)
    # the default is B4's 1/sqrt(D), and another scale is another function
    default = fa.flash_attention_plain(q, k, v)[0]
    assert torch.equal(default, fa.flash_attention_plain(q, k, v, scale=1.0 / math.sqrt(d))[0])
    assert float((default - o).abs().max()) > 1e-3


def test_gated_norm_by_group():
    gen = torch.Generator().manual_seed(3)
    u, w = torch.randn(2, 5, 12, generator=gen), torch.randn(12, generator=gen)
    got = ssm._gated_norm(u, w, 3, 1e-5)
    parts = [L.rms_norm(p, torch.ones(4), 1e-5) for p in u.split(4, dim=-1)]
    torch.testing.assert_close(got, torch.cat(parts, dim=-1) * w, rtol=1e-6, atol=1e-6)
    assert not torch.allclose(got, L.rms_norm(u, w, 1e-5), atol=1e-3)


@pytest.mark.parametrize("remat", [False, True])
def test_spans_of_the_shared_uses_and_mamba_layers(remat):
    conf, model = _model(remat)
    weights, batch = _weights(conf), _batch()
    leaves = {p: t.clone().requires_grad_(True) for p, t in weights.items()}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        loss = _port_loss(model, leaves, batch)
        torch.autograd.grad(loss, list(leaves.values()))
    events = [e for e in prof.events() if e.name.startswith(spans.PREFIX)]
    names = Counter(e.name[len(spans.PREFIX):] for e in events)
    layers = SIZES["num_hidden_layers"]
    # the remat recompute enters each Mamba layer's span once more
    assert names == {"hybrid.shared": 3, "mamba.layer": layers * (2 if remat else 1)}
    inputs = Counter(tuple(e.concrete_inputs) for e in events
                     if e.name.endswith("hybrid.shared"))
    assert inputs == {(0, 0): 1, (1, 1): 1, (0, 2): 1}
    layer_ids = Counter(e.concrete_inputs[0] for e in events
                        if e.name.endswith("mamba.layer"))
    assert layer_ids == {i: (2 if remat else 1) for i in range(layers)}


def test_one_group_and_first_form_paths_raise():
    conf, model = _model()
    cfg = port_config(conf)
    with pytest.raises(NotImplementedError, match="one B/C group"):
        ssm._mamba2_sharded(cfg, None, None)
    with pytest.raises(NotImplementedError, match="published Zamba2 block"):
        model.cache_specs(1, 8)
    for published_only in ({"n_shared_blocks": 2}, {"adapter_rank": 8}):
        bad = dataclasses.replace(get_arch("zamba2-1.2b"), **published_only)
        with pytest.raises(ValueError, match="published block"):
            build_model(bad).param_specs()
    with pytest.raises(ValueError, match="hybrid_layers"):
        build_model(dataclasses.replace(cfg, hybrid_layers=[3, 12])).param_specs()


def test_mamba2_lm_with_groups():
    """Mamba2LM shares the grouped block: with its head set to the
    embedding's transpose, its forward is the reference's Mamba layers
    without the shared blocks (no hybrid layer among them); its decode takes
    one B/C group and raises."""
    conf, _ = _model()
    sizes = dict(conf["sizes"], hybrid_layer_ids=[])
    cfg = dataclasses.replace(port_config(conf), family="ssm", hybrid_layers=(),
                              n_shared_blocks=1, adapter_rank=0)
    model = build_model(cfg)
    weights = {p: t for p, t in _weights(conf).items()
               if not p.startswith(("shared/", "uses/"))}
    weights["lm_head"] = weights["embed"].t().contiguous()
    assert set(dict(_flatten(model.param_specs()))) == set(weights)
    batch = _batch()
    with torch.no_grad():
        loss = float(_port_loss(model, weights, batch))
        want = float(ref.loss(sizes, weights, batch["tokens"], batch["labels"]))
    assert loss == pytest.approx(want, rel=LOSS_RTOL)
    cache = init_from_specs(model.cache_specs(ROWS, SEQ, dtype=torch.float32), None, "cpu")
    with pytest.raises(NotImplementedError, match="one B/C group"):
        model.decode_step(common.nest(weights), cache, batch["tokens"][:, :1], 0)
