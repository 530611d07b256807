#!/usr/bin/env python3
"""What each design choice of B4's tensor-core kernels (F1, F3, F4) buys, on one CUDA card.

Run from the root of a checkout: ``python3 tools/flash_attention_forms.py``.
It needs one card and ``nvcc``. It writes forms of
``src/repro_torch/kernels/csrc/flash_attention.cu`` that each undo one
choice, by exact substitutions in the source (each must match), builds them
side by side into ``build/kernels/forms/``, and times F1, F3 and F4 of
every form at ``chip_smoke.FA_TIMED`` on the device alone
(``chip_smoke.device_ms``; in turns, the source's own form first and
last) and measures
F1's O and lse (largest gap over the largest plain value) and F3's and
F4's gradients (relative norms) against the plain versions there and at
h2o-danube-1.8b's shape (S = 5120, window 4096, the longest sums of
``chip_smoke.FA_SHAPES``). The forms:

- ``source``: the kernels as they are;
- ``cvt_rna``: the TF32 rounding by ``cvt.rna.tf32.f32`` instead of its two
  integer operations (the same bits);
- ``one_accumulator``: every product into the running sum (F1: P V into
  O), no fresh accumulator per stage or block of columns;
- ``unrolled``, ``rolled``: F3's score products with their blocks of 32
  columns unrolled in full, or not at all (the source unrolls two);
- ``unpaired``: one kv tile a block of 4 warps in F3, not two;
- ``one_term``: plain TF32, hi.hi alone (the products' error without the
  split).

The F3-only forms leave F1 and F4 as they are. F1 on f32 FMAs, the kernel
before the tensor cores, is no substitution of this source: it is timed
from its own commit's tree (``tools/kernel_times.py``).

The last line of the output is the result as JSON.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from source_forms import build_forms  # noqa: E402

SOURCE = build.CSRC / "flash_attention.cu"
OUT = build.BUILD_DIR / "forms"
# form: [(text in the source, its replacement), ...]
FORMS = {
    "source": [],
    "cvt_rna": [(
        "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
        '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n  return r;')],
    "one_accumulator": [
        ("        mma3<kExact, kExact>(part[n], af, bf);",
         "        mma3<kExact, kExact>(c[n], af, bf);"),
        ("        mma3<false, kExactB>(part, af[j], bf);",
         "        mma3<false, kExactB>(c[c0 / 8 + i], af[j], bf);")],
    "unrolled": [
        ("mma_nt<D, 2, kExact, 2>(pt,", "mma_nt<D, 2, kExact, D / 32 + 1>(pt,"),
        ("mma_nt<D, 2, kExact, 2>(dst,", "mma_nt<D, 2, kExact, D / 32 + 1>(dst,")],
    "rolled": [
        ("mma_nt<D, 2, kExact, 2>(pt,", "mma_nt<D, 2, kExact, 1>(pt,"),
        ("mma_nt<D, 2, kExact, 2>(dst,", "mma_nt<D, 2, kExact, 1>(dst,")],
    "unpaired": [
        ("constexpr int kDkdvGroups = 2;", "constexpr int kDkdvGroups = 1;"),
        ("flat_grid((tiles(d.skv) + 1) / 2,", "flat_grid(tiles(d.skv),")],
    "one_term": [
        ("  if (!kExactA) mma(c, a[0].lo,", "  if (false) mma(c, a[0].lo,"),
        ("  if (!kExactB) mma(c, a[0].hi,", "  if (false) mma(c, a[0].hi,")],
}
LONG = ("h2o-danube-1.8b", (1, 5120, 5120, 32, 8, 80), True, 4096, torch.float32)


class Inputs:
    """One shape's inputs, plain gradients and output buffers on the card."""

    def __init__(self, dims, causal, window, dtype):
        b, sq, skv, hq, hkv, d = dims
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        self.q, self.k, self.v, self.do = (
            torch.randn(sh, generator=gen, device="cuda").to(dtype)
            for sh in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d),
                       (b, sq, hq, d)))
        opts = dict(causal=causal, window=window)
        o, lse = fa.flash_attention_plain(self.q, self.k, self.v, **opts)
        delta = fa.bwd_preprocess_plain(o, self.do)
        # held here: the kernels read them by pointer after __init__ returns
        self.ins = (self.q, self.k, self.v, self.do, lse, delta)
        self.want = (fa.bwd_dq_plain(*self.ins, **opts), *fa.bwd_dkdv_plain(*self.ins, **opts))
        self.want_fwd = (o, lse)
        self.ptrs = [t.data_ptr() for t in self.ins]
        # the dimension arguments, then the query offset (0)
        self.args = fa._kernel_args(self.q, self.k, self.v, causal, window) + [0]
        self.dq, self.dk, self.dv, self.o = (torch.empty_like(t)
                                             for t in (self.q, self.k, self.v, self.q))
        self.lse = torch.empty_like(lse)

    def f1(self, lib):
        err = lib.flash_attention_fwd(*self.ptrs[:3], self.o.data_ptr(), self.lse.data_ptr(),
                                      *self.args, torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    def f3(self, lib):
        err = lib.flash_attention_bwd_dkdv(*self.ptrs, self.dk.data_ptr(), self.dv.data_ptr(),
                                           *self.args, torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    def f4(self, lib):
        err = lib.flash_attention_bwd_dq(*self.ptrs, self.dq.data_ptr(), *self.args,
                                         torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    def errors(self, lib) -> list:
        self.f3(lib)
        self.f4(lib)
        return [C.rel_norm(a, w) for a, w in zip((self.dq, self.dk, self.dv), self.want)]

    def fwd_errors(self, lib) -> list:
        self.f1(lib)
        return [C.rel_max(a, w) for a, w in zip((self.o, self.lse), self.want_fwd)]


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_attention_forms: no CUDA card", file=sys.stderr)
        return 1
    card = C.card_line()
    libs = build_forms(SOURCE, OUT, FORMS, fa._SIGNATURES)
    timed = next(row for row in C.FA_SHAPES if row[0] == C.FA_TIMED)
    res = {n: {"f1_ms": [], "f3_ms": [], "f4_ms": []} for n in libs}
    for label, dims, causal, window, dtype in (timed, LONG):
        shape = Inputs(dims, causal, window, dtype)
        for n, lib in libs.items():
            res[n][f"errors {label} (dq, dk, dv)"] = shape.errors(lib)
            res[n][f"errors {label} (o, lse)"] = shape.fwd_errors(lib)
        if label == C.FA_TIMED:
            order = list(libs) + ["source"]
            for n in order:
                res[n]["f1_ms"].append(C.device_ms(lambda: shape.f1(libs[n])))
                res[n]["f3_ms"].append(C.device_ms(lambda: shape.f3(libs[n])))
                res[n]["f4_ms"].append(C.device_ms(lambda: shape.f4(libs[n])))
        del shape
        C.free_cuda()
    for n, r in res.items():
        print(f"{n}: {json.dumps(r)}", flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "timed": list(timed[1]), "forms": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
