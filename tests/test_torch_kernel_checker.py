"""The port's launch-config checker (``repro_torch.analysis.kernels``), held
against the reference's kernel checker (``repro.analysis.kernels``) where
the two share a contract: the hop message's scale trailer.

Each kernel-checker test of ``tests/test_analysis.py`` has its counterpart
here. The TPU's checks (tile budget, VMEM, lanes) become Hopper's: threads,
``__launch_bounds__``, dynamic shared memory, grid limits and the
instantiated shapes. The shared-memory sizes the checker reads from the
``.cu`` sources' own ``constexpr`` functions are held to the dynamic bytes
the card reported for the main paths' kernels. Blocks per SM against the
occupancy API are read on the card only (``chip_smoke.py`` phase 13); here
the prediction is held to hand-worked cases of ``cuda_occupancy.h``'s
rules for compute capability 9.0.
"""

import re

import pytest
import torch

from repro.analysis import kernels as jkern
from repro_torch.analysis import kernels as akern
from repro_torch.analysis.fixtures import (
    TRAILER_MISMATCH_SCALE_BYTES,
    trailer_mismatch_kernel_spec,
)


def test_kernel_checker_accepts_known_good_configs():
    for spec in (akern.KernelSpec(64, 4096),
                 akern.KernelSpec(512, 256, kernel="dequant_add_quantize"),
                 akern.KernelSpec(7, 4096, kernel="dequant_accumulate"),
                 akern.FlashSpec(2, 1024, 16, 128, kv_heads=8),
                 akern.WkvSpec(2, 1024, 64, 64),
                 akern.SsdSpec(2, 1024, 64, 64, state=64)):
        result = akern.check_spec(spec)
        assert result.ok, result.errors
        assert result.launches
        assert all(launch.smem <= akern.SMEM_PER_BLOCK
                   for launch in result.launches)


def test_kernel_checker_rejects_rows_quant_ring_rejects():
    result = akern.check_spec(akern.KernelSpec(2 ** 31, 4096))
    assert not result.ok
    assert "quant_ring._rows rejects it" in result.errors[0]
    assert any("grid" in e for e in result.errors)
    assert akern.check_spec(akern.KernelSpec(2 ** 31 - 1, 1)).ok


def test_kernel_checker_rejects_shared_memory_overflow():
    # above head dim 128 F3 holds one kv tile a block: at 256 its 49,984
    # floats fit (two tiles would need 399,872 B); at 352, 68,416 do not
    result = akern.check_spec(akern.FlashSpec(2, 1024, 16, 256, kv_heads=8))
    f3 = [launch for launch in result.launches
          if launch.function == "bwd_dkdv_kernel"]
    assert f3[0].smem == 199_936 and f3[0].grid == (16 * 8 * 2, 1, 1)
    assert akern.source_formulas("flash_attention")["dkdv_smem"](256) == 399_872
    result = akern.check_spec(akern.FlashSpec(2, 1024, 16, 352, kv_heads=8))
    assert not result.ok
    f3 = [launch for launch in result.launches
          if launch.function == "bwd_dkdv_kernel"]
    assert f3[0].smem == 273_664
    assert any("273664 B of dynamic shared memory" in e
               for e in result.errors)
    # head dim 96 fits the shared memory but has no instantiation
    result = akern.check_spec(akern.FlashSpec(2, 1024, 16, 96, kv_heads=8))
    assert not result.ok
    assert result.errors == ("head_dim 96 is not one DISPATCH instantiates "
                             "(32, 64, 80, 128, 224)",)


# ---------------------------------------------------------------------------
# the formulas against the sources
# ---------------------------------------------------------------------------

_SIZE_FUNCTION = re.compile(r"constexpr (?:int|size_t) (\w+_(?:floats|smem))\(\)")
# the dynamic bytes the card reported for the main paths' f32
# instantiations (chip_smoke.py phase 13's launch_configs line on an NVIDIA
# H100 80GB HBM3): (source, size function, template arguments) -> bytes
CARD_DYNAMIC_BYTES = {
    ("flash_attention", "fwd_smem", (128,)): 67_584,      # F1
    ("flash_attention", "dkdv_smem", (128,)): 203_264,    # F3
    ("flash_attention", "dq_smem", (128,)): 101_376,      # F4
    ("wkv6", "fwd_floats", (64,)): 67_968,                # W1 fwd_out
    ("wkv6", "bwd_floats", (64,)): 99_840,                # W2 bwd_chunk
    ("ssd_scan", "sum_floats", (64, 64)): 38_144,         # S1, S2 chunk_sum
    ("ssd_scan", "fwd_floats", (64, 64)): 72_960,         # S1 fwd_out
    ("ssd_scan", "bwd_floats", (64, 64)): 214_560,        # S2 bwd_chunk
}


def test_kernel_checker_matches_sources_formulas():
    """The checker reads every shared-memory size function of the sources,
    and its reading gives the dynamic bytes the card reported; the sources'
    own static_asserts hold on it, and what it cannot read raises."""
    for name in ("flash_attention", "wkv6", "ssd_scan"):
        text = (akern.CSRC / f"{name}.cu").read_text()
        assert set(akern.source_formulas(name)) == \
            set(_SIZE_FUNCTION.findall(text))
    for (name, fn, args), nbytes in CARD_DYNAMIC_BYTES.items():
        got = akern.source_formulas(name)[fn](*args)
        assert (got if fn.endswith("_smem") else 4 * got) == nbytes, fn
    fa = akern.source_formulas("flash_attention")
    groups = akern.source_constants("flash_attention")["kDkdvGroups"]
    for d in akern.flash_head_dims() + (96, 256):
        assert fa["fwd_smem"](d) == 4 * fa["fwd_floats"](d)
        assert fa["dkdv_smem"](d) == 4 * groups * fa["dkdv_floats"](d)
    assert fa["dkdv_smem"](256) == 399_872
    # the sources' own static_asserts hold on the reading
    ssd, wkv = akern.source_formulas("ssd_scan"), akern.source_formulas("wkv6")
    assert 4 * ssd["bwd_floats"](64, 64) <= akern.SMEM_PER_BLOCK
    assert 2 * 4 * wkv["bwd_floats"](64) <= akern.SMEM_PER_BLOCK - 2048
    with pytest.raises(TypeError):
        ssd["bwd_floats"](64)
    with pytest.raises(ValueError, match="not an integer C expression"):
        akern._int_expr("max(1, 2)", {})


def test_constants_and_launch_bounds_read_from_sources():
    quant = akern.source_constants("quant_ring")
    assert quant["kRowThreads"] == 256 and quant["kWarps"] == 8
    assert akern.source_constants("flash_attention")["kMmaThreads"] == 128
    for name in ("quant_ring", "flash_attention", "wkv6", "ssd_scan", "adamw"):
        text = (akern.CSRC / f"{name}.cu").read_text()
        bounds = akern.launch_bounds(name)
        assert len(bounds) == len(set(re.findall(
            r"__launch_bounds__\([^)]*\)\s*(\w+)\s*\(", text)))
        assert text.count("__global__") == text.count("__launch_bounds__")
        assert all(b % 32 == 0 and b <= 1024 for b in bounds.values())
    assert akern.flash_head_dims() == (32, 64, 80, 128, 224)
    assert akern.wkv_head_dims() == (32, 64)
    assert akern.ssd_shapes() == ((16, 32), (64, 64))


def test_every_launch_is_a_queried_instantiation():
    """The launches each spec makes are among the instantiations the card
    query reports, with the dynamic bytes the checker expects there."""
    inst = {name: (fn, smem) for name, _, fn, _, smem in akern._instantiations()}
    assert len(inst) == 97
    specs = [akern.KernelSpec(4, 128, kernel=k) for k in
             ("quantize_pack", "dequant_fp8", "cast_pack_bf16", "bf16_upcast")]
    for bf16 in (False, True):
        specs += [akern.FlashSpec(1, 100, 4, d, kv_heads=2, bf16=bf16)
                  for d in akern.flash_head_dims()]
        specs += [akern.WkvSpec(1, 100, 2, p, bf16=bf16)
                  for p in akern.wkv_head_dims()]
        specs += [akern.SsdSpec(1, 100, 6, p, state=n, bf16=bf16)
                  for n, p in akern.ssd_shapes()]
    for spec in specs:
        result = akern.check_spec(spec)
        assert result.ok, (spec, result.errors)
        for launch in result.launches:
            assert inst[launch.kernel] == (launch.function, launch.smem)


@pytest.mark.parametrize("regs,static,dynamic,threads,blocks", [
    (172, 0, 67_584, 128, 2),      # registers: 2 warps a sub-partition
    (255, 0, 203_264, 256, 1),     # registers and shared memory
    (30, 32, 0, 256, 8),           # threads
    (26, 0, 0, 128, 16),           # threads
    (80, 0, 99_840, 256, 2),       # shared memory, the 1 KB reserve counted
    (146, 0, 96_800, 256, 1),      # registers
    (16, 0, 0, 32, 32),            # the 32 blocks an SM
    (32, 0, 232_449, 256, 0),      # over the opt-in limit
    (32, 2_000, 232_448, 256, 0),  # static + dynamic over the SM
    (255, 0, 0, 1024, 0),          # 255 registers x 1024 threads
])
def test_predicted_blocks_per_sm(regs, static, dynamic, threads, blocks):
    assert akern.predicted_blocks_per_sm(regs, static, dynamic, threads) \
        == blocks


# ---------------------------------------------------------------------------
# the trailer, shared with the reference and the collective verifier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale_bytes", [None, 2, 4, 8])
@pytest.mark.parametrize("n_blocks,block", [(64, 4096), (512, 256),
                                            (7, 4096), (8, 1024)])
def test_trailer_verdicts_match_reference(n_blocks, block, scale_bytes):
    """The port's check_spec accepts exactly what the reference's accepts
    on the same (n_blocks, block, scale_bytes), each of the reference's
    trailer messages among the port's."""
    port = akern.check_spec(akern.KernelSpec(n_blocks, block,
                                             scale_bytes=scale_bytes))
    ref = jkern.check_spec(jkern.KernelSpec(n_blocks, block,
                                            scale_bytes=scale_bytes))
    assert port.ok == ref.ok == (scale_bytes in (None, 4))
    ref_trailer = jkern._check_trailer_consistency(
        jkern.KernelSpec(n_blocks, block, scale_bytes=scale_bytes))
    assert set(ref_trailer) <= set(port.errors)


def test_trailer_mismatch_fixture_rejected_by_both_checkers():
    spec = trailer_mismatch_kernel_spec()
    assert spec.scale_bytes == TRAILER_MISMATCH_SCALE_BYTES == 2
    assert not akern.check_spec(spec).ok
    assert not jkern.check_spec(jkern.KernelSpec(
        spec.n_blocks, spec.block, scale_bytes=spec.scale_bytes)).ok


def test_bf16_wire_has_no_trailer():
    assert akern.check_spec(akern.KernelSpec(64, 4096,
                                             kernel="bf16_add_cast")).ok
    result = akern.check_spec(akern.KernelSpec(64, 4096, kernel="bf16_upcast",
                                               scale_bytes=4))
    assert not result.ok and "no scale trailer" in result.errors[0]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_kernel_checker_cli_suite():
    assert akern.main([]) == 0
    suite = akern.default_suite()
    assert sum(1 for _, ok in suite if ok) >= 3
    assert sum(1 for _, ok in suite if not ok) >= 4
    assert akern.main(["--check", "2147483648,4096"]) == 1
    assert akern.main(["--check", "64,4096,dequant"]) == 0


def test_kernel_checker_executes_small_configs_on_the_cpu(capsys):
    """--execute --device cpu runs the plain versions and checks each small
    accepted config's packed message; the resources need a card."""
    assert akern.main(["--execute", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("executed on cpu: message length OK") == 5
    for kernel in ("quantize_pack", "dequant_add_quantize_fp8",
                   "bf16_accumulate", "dequant"):
        assert akern.execute_spec(akern.KernelSpec(3, 40, kernel=kernel),
                                  "cpu") is None
    # the Share-Only gather, its trailers on 4 bytes and off them
    for kernel, block in (("dequant", 40), ("dequant_fp8", 33)):
        assert akern.execute_spec(akern.KernelSpec(3, block, kernel=kernel, rows=4),
                                  "cpu") is None
    assert not akern.check_spec(akern.KernelSpec(3, 40, rows=4)).ok


def test_launch_configs_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the query runs")
    with pytest.raises(RuntimeError, match="CUDA card"):
        akern.card_launch_configs()
