#!/usr/bin/env python3
"""What each design choice of B4's backward kernels (F3, F4) buys, on one CUDA card.

Run from the root of a checkout: ``python3 tools/flash_attention_forms.py``.
It needs one card and ``nvcc``. It writes forms of
``src/repro_torch/kernels/csrc/flash_attention.cu`` that each undo one
choice, by exact substitutions in the source (each must match), builds them
side by side into ``build/kernels/forms/``, and times F3 and F4 of every
form at ``chip_smoke.FA_TIMED`` (in turns, the source's own form first and
last) and measures their gradients' relative norms against the plain
versions there and at h2o-danube-1.8b's shape (S = 5120, window 4096, the
longest sums of ``chip_smoke.FA_SHAPES``). The forms:

- ``source``: the kernels as they are;
- ``cvt_rna``: the TF32 rounding by ``cvt.rna.tf32.f32`` instead of its two
  integer operations (the same bits);
- ``one_accumulator``: every product into the running sum, no fresh
  accumulator per stage or block of columns;
- ``unrolled``, ``rolled``: F3's score products with their blocks of 32
  columns unrolled in full, or not at all (the source unrolls two);
- ``unpaired``: one kv tile a block of 4 warps in F3, not two;
- ``one_term``: plain TF32, hi.hi alone (the products' error without the
  split).

The last line of the output is the result as JSON.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

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
LONG = ("h2o-danube-1.8b", (1, 5120, 32, 8, 80), True, 4096, torch.float32)


def write_forms() -> dict:
    text = SOURCE.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, subs in FORMS.items():
        form = text
        for old, new in subs:
            if form.count(old) != 1:
                raise AssertionError(f"{name}: {old!r} is not in the source once")
            form = form.replace(old, new)
        paths[name] = OUT / f"{name}.cu"
        paths[name].write_text(form)
    return paths


def compile_forms(paths: dict) -> dict:
    nvcc = build.find_nvcc()
    procs = {n: subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-o", str(p.with_suffix(".so")),
                                  str(p)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True) for n, p in paths.items()}
    libs = {}
    for n, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on form {n}:\n{out}")
        lib = ctypes.CDLL(str(paths[n].with_suffix(".so")))
        for fn, argtypes in fa._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes + [ctypes.c_void_p]
        libs[n] = lib
    return libs


class Inputs:
    """One shape's inputs, plain gradients and output buffers on the card."""

    def __init__(self, dims, causal, window, dtype):
        b, s, hq, hkv, d = dims
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        self.q, self.k, self.v, self.do = (
            torch.randn(sh, generator=gen, device="cuda").to(dtype)
            for sh in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d)))
        opts = dict(causal=causal, window=window)
        o, lse = fa.flash_attention_plain(self.q, self.k, self.v, **opts)
        delta = fa.bwd_preprocess_plain(o, self.do)
        ins = (self.q, self.k, self.v, self.do, lse, delta)
        self.want = (fa.bwd_dq_plain(*ins, **opts), *fa.bwd_dkdv_plain(*ins, **opts))
        self.ptrs = [t.data_ptr() for t in ins]
        self.args = fa._kernel_args(self.q, self.k, self.v, causal, window)
        self.dq, self.dk, self.dv = (torch.empty_like(t) for t in (self.q, self.k, self.v))

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


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_attention_forms: no CUDA card", file=sys.stderr)
        return 1
    card = C.card_line()
    libs = compile_forms(write_forms())
    timed = next(row for row in C.FA_SHAPES if row[0] == C.FA_TIMED)
    res = {n: {"f3_ms": [], "f4_ms": []} for n in libs}
    for label, dims, causal, window, dtype in (timed, LONG):
        shape = Inputs(dims, causal, window, dtype)
        for n, lib in libs.items():
            res[n][f"errors {label} (dq, dk, dv)"] = shape.errors(lib)
        if label == C.FA_TIMED:
            order = list(libs) + ["source"]
            for n in order:
                res[n]["f3_ms"].append(C.cuda_ms(lambda: shape.f3(libs[n])))
                res[n]["f4_ms"].append(C.cuda_ms(lambda: shape.f4(libs[n])))
        del shape
        C.free_cuda()
    for n, r in res.items():
        print(f"{n}: {json.dumps(r)}", flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "timed": list(timed[1]), "forms": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
