"""The frozen arithmetic against operations and bytes worked out by hand."""

import pytest

from perfbench import count
from perfbench.count import model, ring


def test_matmul_mm_and_bmm():
    # (128 x 64) @ (64 x 32): 2*128*32*64 operations; 4-byte reads and write
    assert count.matmul("aten::mm", [[128, 64], [64, 32]], ["float", "float"]) == (
        2 * 128 * 32 * 64, 4 * (128 * 64 + 64 * 32 + 128 * 32))
    assert count.matmul("aten::bmm", [[3, 5, 7], [3, 7, 11]], ["float", "float"]) == (
        2 * 3 * 5 * 11 * 7, 4 * (3 * 5 * 7 + 3 * 7 * 11 + 3 * 5 * 11))
    # addmm: the bias read, the product's output written once
    assert count.matmul("aten::addmm", [[32], [128, 64], [64, 32]],
                        ["float"] * 3) == (2 * 128 * 32 * 64,
                                           4 * (128 * 32 + 128 * 64 + 64 * 32 + 128 * 32))
    assert count.matmul("aten::mm", [[4, 4, 4], [4, 4]], ["float"] * 2) is None
    assert count.matmul("aten::add", [[4, 4], [4, 4]], ["float"] * 2) is None


def test_visible_pairs():
    assert count.visible_pairs(4, 4, True, None) == 1 + 2 + 3 + 4
    assert count.visible_pairs(4, 4, False, None) == 16
    assert count.visible_pairs(4, 4, True, 2) == 1 + 2 + 2 + 2
    assert count.visible_pairs(2, 4, True, None, q_offset=2) == 3 + 4


def test_flash_attention_one_call():
    # phi3.5-moe's shape: q (2, 1024, 32, 128), k and v (2, 1024, 8, 128)
    q, kv = [2, 1024, 32, 128], [2, 1024, 8, 128]
    pairs = 1024 * 1025 // 2 * 2 * 32
    ops, nbytes = count.flash_attention("fwd", [q, kv, kv, [], [], []], ["float"] * 6)
    assert ops == 4 * 128 * pairs
    q_b, kv_b, lse_b = 2 * 1024 * 32 * 128 * 4, 2 * 1024 * 8 * 128 * 4, 2 * 32 * 1024 * 4
    assert nbytes == q_b + 2 * kv_b + q_b + lse_b
    lse = [2, 32, 1024]
    ops, nbytes = count.flash_attention("bwd", [q, kv, kv, q, lse, q],
                                        ["float"] * 6)
    assert ops == 10 * 128 * pairs + 2 * 2 * 1024 * 32 * 128
    assert nbytes == (q_b + 2 * kv_b + q_b + lse_b + q_b) + (q_b + 2 * kv_b)
    # the bound: operations at the TF32 peak (17.2 GFLOP: twice PERF.md's
    # 8.6 GFLOP at 16 heads)
    assert count.bound_s(4 * 128 * pairs, 0) == pytest.approx(17.2e9 / 495e12, rel=1e-2)


def test_wkv6_one_call():
    b, s, h, p = 1, 2048, 64, 64
    shapes = [[b, s, h, p]] * 4 + [[h, p], []]
    ops, nbytes = count.wkv6("fwd", shapes, ["float"] * 6)
    nc, lc = s // 32, 32
    assert ops == 4 * b * nc * h * lc * lc * p + 4 * b * nc * h * lc * p * p \
        + 2 * b * nc * lc * h * p
    act, state = b * s * h * p * 4, b * h * p * p * 4
    assert nbytes == 4 * act + h * p * 4 + act + state
    saved = [b, h, nc, p, p]
    bwd_shapes = [[b, s, h, p]] * 4 + [[h, p], saved, [b, s, h, p], []]
    ops_b, nbytes_b = count.wkv6("bwd", bwd_shapes, ["float"] * 8)
    assert ops_b == 2 * ops
    # the saved chunk states (B, H, nc, P, P) are not counted
    assert nbytes_b == (4 * act + h * p * 4 + act) + 4 * act + h * p * 4
    # from a carried state: the initial state read, its gradient written
    d_final = [b, h, p, p]
    _, nbytes_i = count.wkv6("bwd", bwd_shapes[:7] + [d_final, []], ["float"] * 9,
                             with_initial=True)
    assert nbytes_i == nbytes_b + 3 * state


def test_ring_kernels_one_all_reduce():
    # 10,000 elements over 4 ranks: chunks of 2,500, one sub-block each
    n, w = 10_000, 4
    assert ring.chunk_layout(n, w) == (1, 2500)
    calls = ring.all_reduce_calls(n, w)
    payload, scales, f32 = 2500, 4, 2500 * 4
    assert calls["quantize_pack_kernel"] == (8, 8.0 * (f32 + payload + scales))
    assert calls["dequant_add_quantize_kernel"] == (
        8, 8.0 * (payload + scales + f32 + payload + scales))
    assert calls["dequant_accumulate_kernel"] == (4, 4.0 * (payload + scales + 2 * f32))
    assert calls["dequant_kernel"] == (4, 4.0 * (4 * (payload + scales) + 4 * f32))
    # a large leaf splits into 4096-element sub-blocks, the last padded
    assert ring.chunk_layout(4 * 10_000, 4) == (3, 4096)
    assert ring.all_reduce_calls(100, 1) == {}


def test_model_flops():
    conf = {"family": "moe", "sizes": {
        "num_hidden_layers": 1, "hidden_size": 8, "head_dim": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "intermediate_size": 16,
        "num_local_experts": 4, "num_experts_per_tok": 2, "vocab_size": 10}}
    mix = {"seq_len": 4, "global_batch": 3}
    per_token = (2 * 8 * 2 * (2 * 4 + 2 * 2) + 2 * 2 * 3 * 8 * 16 + 2 * 8 * 4
                 + 2 * 8 * 10)
    attention = 4 * 2 * 4 * (1 + 2 + 3 + 4)
    assert model.train_step_flops(conf, mix) == 3 * 3 * (4 * per_token + attention)
