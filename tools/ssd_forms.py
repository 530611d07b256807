#!/usr/bin/env python3
"""What each design choice of B9's chunk-parallel kernels (S1, S2) buys, on one CUDA card.

Run from the root of a checkout: ``python3 tools/ssd_forms.py``. It needs
one card and ``nvcc``. It writes forms of
``src/repro_torch/kernels/csrc/ssd_scan.cu`` that each undo one choice, by
exact substitutions in the source (each must match once;
``tools/source_forms.py``), builds them side by side into
``build/kernels/forms/``, and times S1 and S2 of every form at
``chip_smoke.SSD_TIMED`` on the device alone (``chip_smoke.device_ms``; in
turns, the source's own form first and last), with each output's error
against the plain versions there and at the weak decay (S1's y and states
as their largest gap over their largest value, S2's gradients as relative
norms). The forms:

- ``source``: the kernels as they are;
- ``one_term``: plain TF32, hi.hi alone;
- ``one_accumulator``: every product into its running sum, no fresh
  accumulator for each 16 of k;
- ``cb_per_head``: C B^T formed once per head (64 blocks of stage 1 a
  chunk, each writing the same tile), not once per batch row and chunk;
- ``fwd_out_3_blocks``: S1's output stage held to registers for three
  blocks an SM (the source: two, 95 registers a thread);
- ``sum_2_heads``, ``sum_8_heads``: 2 or 8 heads a block of the chunk
  summaries (the source 4);
- ``fwd_heads_1``, ``fwd_heads_8``: 1 or 8 heads a block of S1's output
  stage (the source 4).

S2's heads a block of its chunk-local stage is an argument of the entry
point: the source form is also timed at 1 (dB and dC leave as per-head
partials, 67 MB at the main shape, summed over the heads in the last
kernel: the traffic of the wrapper's head sums before), 4 and 8 heads (the
wrapper takes 16). Chunk 128 is not tried: S2's tiles at 128 would need
about 500 KB of shared memory. The source form's device time is also split
by kernel (the profiler's durations by kernel name).

The last line of the output is the result as JSON.
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
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from source_forms import build_forms  # noqa: E402

SOURCE = build.CSRC / "ssd_scan.cu"
OUT = build.BUILD_DIR / "forms"
# form: [(text in the source, its replacement), ...]
FORMS = {
    "source": [],
    "one_term": [
        ("  if (!kExactA) mma(c, a[0].lo,", "  if (false) mma(c, a[0].lo,"),
        ("  if (!kExactB) mma(c, a[0].hi,", "  if (false) mma(c, a[0].hi,")],
    "one_accumulator": [
        ("          mma3<kExactA, kExactB>(part[n], af, bf);",
         "          mma3<kExactA, kExactB>(c[n], af, bf);")],
    "cb_per_head": [
        ("  const int head_blocks = gridDim.z - d.ngroups;\n"
         "  const int gi = blockIdx.z >= head_blocks ? blockIdx.z - head_blocks",
         "  const int head_blocks = gridDim.z - d.heads;\n"
         "  const int gi = blockIdx.z >= head_blocks\n"
         "      ? (blockIdx.z - head_blocks) / (d.heads / d.ngroups)"),
        *((f"chunk_sum_kernel<N, P, T, {bwd}>,\n"
           "                   dim3(d.nc, d.batch, d.heads / dsum.group + d.ngroups)",
           f"chunk_sum_kernel<N, P, T, {bwd}>,\n"
           "                   dim3(d.nc, d.batch, d.heads / dsum.group + d.heads)")
          for bwd in ("false", "true"))],
    "fwd_out_3_blocks": [("__launch_bounds__(kThreads)\n    fwd_out_kernel(",
                          "__launch_bounds__(kThreads, 3)\n    fwd_out_kernel(")],
    "sum_2_heads": [("constexpr int kSumHeads = 4;", "constexpr int kSumHeads = 2;")],
    "sum_8_heads": [("constexpr int kSumHeads = 4;", "constexpr int kSumHeads = 8;")],
    "fwd_heads_1": [("constexpr int kFwdHeads = 4;", "constexpr int kFwdHeads = 1;")],
    "fwd_heads_8": [("constexpr int kFwdHeads = 4;", "constexpr int kFwdHeads = 8;")],
}
# S2's heads a block timed beside the wrapper's
BWD_HEADS = (1, 4, 8)


class Inputs:
    """One shape's inputs, plain outputs, and the kernels' outputs and
    scratch on the card; ``fwd(lib)`` and ``bwd(lib, heads)`` call one
    form's entry points as the wrappers do."""

    def __init__(self, dims, dtype, decay):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(3)
        ins, dy = C.ssd_inputs(dims, dtype, decay, gen)
        self.want_fwd = SSD.ssd_scan_plain(*ins)
        self.want_bwd = SSD.ssd_scan_bwd_plain(*ins, self.want_fwd[1], dy)
        kins, self.args = SSD._kernel_inputs(*ins)
        b, s, h, p, n, lc, _ = self.args
        nc = -(-s // lc)

        def f32(*shape):
            return torch.empty(shape, dtype=torch.float32, device="cuda")

        self.ins = kins + (self.want_fwd[1], dy.to(kins[0].dtype))
        self.y, self.states = torch.empty_like(kins[0]), f32(b, h, nc, n, p)
        self.grads = (f32(b, s, h, p), f32(b, s, h), f32(h), f32(b, s, n), f32(b, s, n))
        self.cb, self.el = f32(b, nc, SSD.SSD_CHUNK, SSD.SSD_CHUNK), f32(b, h, nc)
        self.ds, self.da = f32(b, h, nc, n, p), f32(b, h, nc)
        self.parts = {k: (f32(b, h // k, s, n), f32(b, h // k, s, n))
                      for k in (SSD._heads_per_block(h),) + BWD_HEADS}

    def fwd(self, lib):
        # from a zero state, the final state not formed (null pointers)
        ptrs = ([t.data_ptr() for t in self.ins[:5] + (self.y, self.states)] + [None, None]
                + [self.cb.data_ptr(), self.el.data_ptr()])
        # one B/C group
        err = lib.ssd_fwd(*ptrs, *self.args[:-1], 1, self.args[-1],
                          torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    def bwd(self, lib, heads):
        # no final state's gradient, the initial state's not formed
        ptrs = ([t.data_ptr() for t in self.ins] + [None]
                + [t.data_ptr() for t in self.grads] + [None]
                + [t.data_ptr() for t in (self.cb, self.el, self.ds, self.da)
                   + self.parts[heads]])
        err = lib.ssd_bwd(*ptrs, *self.args[:-1], 1, heads, self.args[-1],
                          torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    def errors(self, lib) -> dict:
        self.fwd(lib)
        self.bwd(lib, SSD._heads_per_block(self.args[2]))
        torch.cuda.synchronize()
        return {"y, states": [C.rel_max(a, w) for a, w in
                              zip((self.y, self.states), self.want_fwd)],
                "dx ddt dA dB dC": [C.rel_norm(a, w) for a, w in
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
        print("ssd_forms: no CUDA card", file=sys.stderr)
        return 1
    card = C.card_line()
    libs = build_forms(SOURCE, OUT, FORMS, SSD._SIGNATURES)
    timed = next(row for row in C.SSD_SHAPES if row[0] == C.SSD_TIMED)
    weak = next(row for row in C.SSD_SHAPES if row[2] == torch.float32 and row[3] == "weak")
    res = {n: {"s1_ms": [], "s2_ms": []} for n in libs}
    res.update({f"s2_heads_{k}": {"s2_ms": []} for k in BWD_HEADS})
    for label, dims, dtype, decay in (weak, timed):
        shape = Inputs(dims, dtype, decay)
        for n, lib in libs.items():
            res[n][f"errors {label}"] = shape.errors(lib)
        if label == C.SSD_TIMED:
            hb = SSD._heads_per_block(dims[2])
            src = libs["source"]
            for n in list(libs) + ["source"]:
                res[n]["s1_ms"].append(C.device_ms(lambda: shape.fwd(libs[n])))
                res[n]["s2_ms"].append(C.device_ms(lambda: shape.bwd(libs[n], hb)))
                if n == "fwd_heads_1":
                    for k in BWD_HEADS:
                        res[f"s2_heads_{k}"]["s2_ms"].append(
                            C.device_ms(lambda: shape.bwd(src, k)))
            res["source"]["s1_by_kernel"] = by_kernel(lambda: shape.fwd(src))
            res["source"]["s2_by_kernel"] = by_kernel(lambda: shape.bwd(src, hb))
        del shape
        C.free_cuda()
    for n, r in res.items():
        print(f"{n}: {json.dumps(r)}", flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "timed": list(timed[1]), "forms": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
