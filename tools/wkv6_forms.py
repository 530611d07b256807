#!/usr/bin/env python3
"""What each design choice of B8's chunk-parallel kernels (W1, W2) buys, on one CUDA card.

Run from the root of a checkout: ``python3 tools/wkv6_forms.py``. It needs
one card and ``nvcc``. It writes forms of
``src/repro_torch/kernels/csrc/wkv6.cu`` that each undo one choice, by
exact substitutions in the source (each must match once;
``tools/source_forms.py``), builds them side by side into
``build/kernels/forms/``, and times W1 and W2 of every form at
``chip_smoke.WKV_TIMED`` on the device alone (``chip_smoke.device_ms``; in
turns, the source's own form first and last), with each output's error
against the plain versions there and with every logw at the clamp (y and
the states as their largest gap over their largest value, the gradients
as relative norms). The forms:

- ``source``: the kernels as they are;
- ``one_term``: plain TF32, hi.hi alone;
- ``lo_truncated``: lo = x - hi handed to the tensor cores as it is (they
  read a TF32 operand's top 19 bits: lo truncated, not rounded to
  nearest), one rounding fewer an operand;
- ``row_0``: the pair decays referred to the chunk's first row, as B8's
  factorization is (m = 0: k exp(-cum) reaches |k| e^80 and r exp(cumprev)
  |r| e^-77.5, whose lo halves the tensor cores may flush), not to its
  middle row;
- ``one_accumulator``: every product into its running sum, no fresh
  accumulator for each 16 of k;
- ``one_copy_group``: stage 3 waits for all its tiles before it starts
  (the source lets the states and dS arrive while cum and A are formed);
- ``fwd_out_2_blocks``, ``fwd_out_4_blocks``: W1's output stage held to
  registers for 2 or 4 blocks an SM (the source leaves it to the compiler);
- ``bwd_chunk_1_block``: W2's chunk-local stage free to take 255 registers
  a thread, one block an SM (the source: two, 128 registers).

Beside them, timing-only forms (``PHASES``) each drop one phase of the
stage-3 kernels, so that their outputs are wrong and only their times are
read: ``no_tile_loads`` (no tile is copied in), ``no_state_products`` (W1's
``r' (exp(m) S)``, W2's ``dy (exp(m) S)^T`` and ``v dS''^T``),
``no_dv_products`` (W2's ``A^T dy`` and ``k' dS''``), ``no_output_stores``
(W2's dr and dk stores) and ``exps_free`` (the rebased factors without
``expf``): what each costs. Every form's device time is also split by
kernel (the profiler's durations by kernel name). The last line of the
output is the result as JSON.
"""

from __future__ import annotations

import json
import re
import statistics
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import rwkv6_wkv as W  # noqa: E402
from source_forms import build_forms  # noqa: E402

SOURCE = build.CSRC / "wkv6.cu"
OUT = build.BUILD_DIR / "forms"
# form: [(text in the source, its replacement), ...]
FORMS = {
    "source": [],
    "one_term": [
        ("  if (!kExactA) mma(c, a[0].lo,", "  if (false) mma(c, a[0].lo,"),
        ("  if (!kExactB) mma(c, a[0].hi,", "  if (false) mma(c, a[0].hi,")],
    "lo_truncated": [("  return {hi, tf32(x - __uint_as_float(hi))};",
                      "  return {hi, __float_as_uint(x - __uint_as_float(hi))};")],
    "row_0": [("(seq + chunk - 1) / chunk, (chunk + 1) / 2 - 1}",
               "(seq + chunk - 1) / chunk, -1}")],
    "one_accumulator": [
        ("          mma3<kExactA, kExactB>(part[n], af, bf);",
         "          mma3<kExactA, kExactB>(c[n], af, bf);")],
    "one_copy_group": [("  cp_wait<1>();  // r, k, logw", "  cp_wait<0>();  // r, k, logw"),
                       ("  cp_wait<1>();  // r, k, v, dy, logw",
                        "  cp_wait<0>();  // r, k, v, dy, logw")],
    "fwd_out_2_blocks": [("__launch_bounds__(kThreads)\n    fwd_out_kernel(",
                          "__launch_bounds__(kThreads, 2)\n    fwd_out_kernel(")],
    "fwd_out_4_blocks": [("__launch_bounds__(kThreads)\n    fwd_out_kernel(",
                          "__launch_bounds__(kThreads, 4)\n    fwd_out_kernel(")],
    "bwd_chunk_1_block": [("__launch_bounds__(kThreads, 2)\n    bwd_chunk_kernel(",
                           "__launch_bounds__(kThreads, 1)\n    bwd_chunk_kernel(")],
}

# timing-only forms: one phase of stage 3 dropped (its outputs are not read)
PHASES = {
    "no_tile_loads": [
        ("  stage<P, SR>(sr, r + at, pitch, rows);\n  stage<P, SR>(sk, k + at, pitch, rows);\n"
         "  stage<P, SR>(scum, lw + at, pitch, rows);\n  cp_commit();\n"
         "  stage<P, SV>(sv, v + at, pitch, rows);\n"
         "  stage<P, SV, P>(ss, states + (bh * d.nc + c) * P * P, P, P);\n", ""),
        ("  stage<P, SR>(sr, r + at, pitch, rows);\n  stage<P, SR>(sk, k + at, pitch, rows);\n"
         "  stage<P, SR>(sv, v + at, pitch, rows);\n  stage<P, SR>(sdy, dy + at, pitch, rows);\n"
         "  stage<P, SR>(sfk, lw + at, pitch, rows);\n  cp_commit();\n"
         "  stage<P, SR, P>(ss, states + (bh * d.nc + c) * P * P, P, P);\n"
         "  stage<P, SR, P>(sds, ds + (bh * d.nc + c) * P * P, P, P);\n", "")],
    "no_state_products": [
        ("  mma_tile<NT, false, false>(\n      rsn, 0, P, NT,",
         "  if (false) mma_tile<NT, false, false>(\n      rsn, 0, P, NT,"),
        ("    mma_tile<NT, kExact, false>(\n        d2, 0, P, NT,",
         "    if (false) mma_tile<NT, kExact, false>(\n        d2, 0, P, NT,"),
        ("    mma_tile<NT, kExact, false>(\n        k2, 0, P, NT,",
         "    if (false) mma_tile<NT, kExact, false>(\n        k2, 0, P, NT,")],
    "no_dv_products": [
        ("    mma_tile<NT, false, kExact>(\n        v1, row0, kL, NT,",
         "    if (false) mma_tile<NT, false, kExact>(\n        v1, row0, kL, NT,"),
        ("    mma_tile<NT, false, false>(\n        v2, 0, P, NT,",
         "    if (false) mma_tile<NT, false, false>(\n        v2, 0, P, NT,")],
    "no_output_stores": [("        if (valid) {\n          put2(dr",
                          "        if (false) {\n          put2(dr")],
    "exps_free": [
        ("    sr[at_s] *= expf(scp[at_s] - sm[p]);\n    sk[at_s] *= expf(sm[p] - scum[at_s]);",
         "    sr[at_s] *= scp[at_s] - sm[p];\n    sk[at_s] *= sm[p] - scum[at_s];"),
        ("    const float fr = expf(sfr[at_s] - sm[p]), fk = expf(sm[p] - sfk[at_s]);",
         "    const float fr = sfr[at_s] - sm[p], fk = sm[p] - sfk[at_s];")],
}


class Inputs:
    """One shape's inputs, plain outputs, and the kernels' outputs and
    scratch on the card; ``fwd(lib)`` and ``bwd(lib)`` call one form's
    entry points as the wrappers do."""

    def __init__(self, dims, dtype, decay):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        ins, u, dy = C.wkv_inputs(dims, dtype, decay, gen)
        self.want_fwd = W.wkv6_plain(*ins, u)
        self.want_bwd = W.wkv6_bwd_plain(*ins, u, self.want_fwd[1], dy)
        kins, uf, self.args = W._kernel_inputs(*ins, u)
        b, s, h, p, lc, _ = self.args
        nc = -(-s // lc)

        def f32(*shape):
            return torch.empty(shape, dtype=torch.float32, device="cuda")

        self.ins = tuple(kins) + (uf,)
        self.states, self.dy = self.want_fwd[1], dy.to(kins[0].dtype)
        self.y, self.y_states = torch.empty_like(kins[0]), f32(b, h, nc, p, p)
        self.grads = tuple(f32(b, s, h, p) for _ in range(4)) + (f32(h, p),)
        self.ds, self.el, self.du_part = f32(b, h, nc, p, p), f32(b, h, nc, p), f32(b, h, nc, p)

    def fwd(self, lib):
        # from a zero state, the final state not formed (null pointers)
        ptrs = ([t.data_ptr() for t in self.ins + (self.y, self.y_states)]
                + [None, None, self.el.data_ptr()])
        err = lib.wkv6_fwd(*ptrs, *self.args, torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    def bwd(self, lib):
        # no final state's gradient, the initial state's not formed
        ptrs = ([t.data_ptr() for t in self.ins + (self.states, self.dy)] + [None]
                + [t.data_ptr() for t in self.grads] + [None]
                + [t.data_ptr() for t in (self.ds, self.el, self.du_part)])
        err = lib.wkv6_bwd(*ptrs, *self.args, torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    def errors(self, lib) -> dict:
        self.fwd(lib)
        self.bwd(lib)
        torch.cuda.synchronize()
        return {"y, states": [C.rel_max(a, w) for a, w in
                              zip((self.y, self.y_states), self.want_fwd)],
                "dr dk dv dlogw du": [C.rel_norm(a, w) for a, w in
                                      zip(self.grads, self.want_bwd)]}


def by_kernel(fn, calls: int = 10) -> dict:
    """Median device ms of each CUDA kernel one call of ``fn`` launches,
    by kernel name, over ``calls`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = defaultdict(list)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = re.search(r"\w+_kernel", e.name)
            times[name.group(0) if name else e.name].append(
                (e.time_range.end - e.time_range.start) / 1e3)
    return {name: statistics.median(ts) * len(ts) / calls for name, ts in times.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("wkv6_forms: no CUDA card", file=sys.stderr)
        return 1
    card = C.card_line()
    libs = build_forms(SOURCE, OUT, {**FORMS, **PHASES}, W._SIGNATURES)
    timed = next(row for row in C.WKV_SHAPES if row[0] == C.WKV_TIMED)
    clamp = next(row for row in C.WKV_SHAPES if row[3] == "clamp")
    res = {n: {"w1_ms": [], "w2_ms": []} for n in libs}
    for label, dims, dtype, decay in (clamp, timed):
        shape = Inputs(dims, dtype, decay)
        for n in FORMS:
            res[n][f"errors {label}"] = shape.errors(libs[n])
        if label == C.WKV_TIMED:
            for n in list(libs) + ["source"]:
                res[n]["w1_ms"].append(C.device_ms(lambda: shape.fwd(libs[n])))
                res[n]["w2_ms"].append(C.device_ms(lambda: shape.bwd(libs[n])))
            for n, lib in libs.items():
                res[n]["w1_by_kernel"] = by_kernel(lambda: shape.fwd(lib))
                res[n]["w2_by_kernel"] = by_kernel(lambda: shape.bwd(lib))
        del shape
        C.free_cuda()
    for n, r in res.items():
        print(f"{n}: {json.dumps(r)}", flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "timed": list(timed[1]), "forms": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
