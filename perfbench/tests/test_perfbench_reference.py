"""The plain references against the program at a tiny size on the CPU:
each family's loss and gradients from the same weights, the ring sums of
both wires, AdamW, and the token walk."""

import numpy as np
import pytest
import torch

from perfbench.kinds.train import port_config
from perfbench.reference import common, train
from perfbench.tests import small
from perfbench.traffic import TokenWalk

CELLS = ["rwkv6-7b-l4.ring-f32.w4", "phi3.5-moe-42b-l1.ring-int8.w4"]


@pytest.mark.parametrize("cell", CELLS)
def test_family_loss_and_gradients(cell):
    from repro_torch.models.model import build_model
    from repro_torch.models.module import _flatten

    torch.manual_seed(0)
    conf, mix = small.cell_inputs(cell, seq=24)
    fam = train.family(conf)
    weights = common.draw(fam.layout(conf["sizes"]), 5, "cpu")
    batch = {k: torch.as_tensor(v[:2])
             for k, v in TokenWalk(mix, conf["sizes"]["vocab_size"], 5).batch(0).items()}
    leaves = {p: t.clone().requires_grad_(True) for p, t in weights.items()}
    ref_loss = fam.loss(conf["sizes"], leaves, batch["tokens"], batch["labels"])
    ref_grads = torch.autograd.grad(ref_loss, list(leaves.values()))

    model = build_model(port_config(conf))
    mine = {p: t.clone().requires_grad_(True) for p, t in weights.items()}
    loss = model.loss(common.nest(mine), batch)
    grads = torch.autograd.grad(loss, list(mine.values()))
    assert set(dict(_flatten(model.param_specs()))) == set(weights)
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()), rel=1e-6)
    for path, g, r in zip(mine, grads, ref_grads):
        scale = float(r.abs().max()) or 1.0
        assert float((g - r).abs().max()) <= 1e-4 * scale, path


@pytest.mark.parametrize("mode", ["ring", "compressed-fused"])
@pytest.mark.parametrize("n", [1, 37, 4 * 4096 + 5, 70_001])
def test_ring_sum_equals_the_program_ring(mode, n):
    from repro_torch.dist.collectives import LocalRing
    from repro_torch.training.train_step import LEAF_COLLECTIVES

    gen = torch.Generator().manual_seed(n)
    xs = [torch.randn(n, generator=gen) * (r + 1) for r in range(4)]
    program = LEAF_COLLECTIVES[mode]([x.clone() for x in xs], LocalRing(["cpu"] * 4))
    mine = train.wire({"mode": mode}).all_reduce(xs)
    for out in program:
        assert torch.equal(out, mine)


def test_adamw_equals_the_program():
    from repro_torch.training.optimizer import adamw_init, adamw_update

    opt = train.optimizer({"optimizer": "adamw"})
    gen = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(5, 7, generator=gen), "b": torch.randn(3, generator=gen)}
    state, mine = adamw_init(params), opt.init(params)
    p_prog, p_mine = dict(params), dict(params)
    for step in range(3):
        grads = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
        p_prog, state = adamw_update(grads, state, p_prog, lr=3e-4)
        p_mine, mine = opt.update(p_mine, grads, mine, 3e-4)
        if step == 0:
            assert opt.first_grad_norms(state) == pytest.approx(
                {k: float(g.norm()) for k, g in grads.items()}, rel=1e-6)
    for k in params:
        torch.testing.assert_close(p_mine[k], p_prog[k], rtol=0, atol=1e-7)
        torch.testing.assert_close(mine["m"][k], state["m"][k], rtol=0, atol=0)


@pytest.mark.parametrize("mix", [{"mode": "psum-ring"}, {"optimizer": "lion"}])
def test_a_mix_the_reference_lacks_is_refused(mix):
    with pytest.raises(ValueError, match="the reference has no"):
        (train.wire if "mode" in mix else train.optimizer)(mix)


def test_token_walk_is_the_program_pipeline():
    from repro_torch.data.pipeline import SyntheticTokens

    mix = {"seq_len": 33, "global_batch": 4, "tokens": {"step_low": -3, "step_high": 3}}
    for seed, step in [(0, 0), (2**31 + 7, 5)]:
        ours = TokenWalk(mix, 1000, seed).batch(step)
        theirs = SyntheticTokens(1000, 33, 4, seed=seed).batch(step)
        assert ours["tokens"].shape == (4, 33)
        assert all(np.array_equal(ours[k], theirs[k]) for k in ours)
    assert not np.array_equal(TokenWalk(mix, 1000, 1).batch(0)["tokens"],
                              TokenWalk(mix, 1000, 1).batch(1)["tokens"])
