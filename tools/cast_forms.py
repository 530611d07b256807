#!/usr/bin/env python3
"""What each design choice of B5, the bf16 wire cast, buys, on one CUDA card.

Run from the root of a checkout: ``python3 tools/cast_forms.py``. It needs
one card and ``nvcc``. It writes forms of
``src/repro_torch/kernels/csrc/quant_ring.cu`` that each undo one choice of
``cast_pack_bf16_kernel``, by exact substitutions in the source (each must
match), builds them side by side into ``build/kernels/cast_forms/``, holds
each form's cast bit for bit against ``x.to(torch.bfloat16)`` and times it
on the device alone (``chip_smoke.device_ms``) at the embed chunk's shape
(``chip_smoke.EMBED_CHUNK_W4``), in three rounds of turns beside
``x.to(torch.bfloat16)`` itself. The forms:

- ``source``: the kernel as it is: a grid over the whole tensor, blocks of
  128 threads, two float4s a thread;
- ``card_grid``: a grid sized to the card (SMs times resident blocks, from
  ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) striding over the
  tensor, blocks of 256, four float4s a thread;
- ``four_a_thread``: four float4s a thread;
- ``threads_256``: blocks of 256 threads;
- ``one_by_one``: every element cast one by one, no float4 body.

The last line of the output is the result as JSON.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import quant_ring as qr  # noqa: E402
from source_forms import build_forms  # noqa: E402

SOURCE = build.CSRC / "quant_ring.cu"
OUT = build.BUILD_DIR / "cast_forms"
THREADS, VECS = "constexpr int kCastThreads = 128;", "constexpr int kCastVecs = 2;"
GRID = "  return static_cast<unsigned int>(want < 0x7fffffff ? want : 0x7fffffff);"
# form: [(text in the source, its replacement), ...]
FORMS = {
    "source": [],
    "card_grid": [
        (THREADS, "constexpr int kCastThreads = 256;"),
        (VECS, "constexpr int kCastVecs = 4;"),
        (GRID, "  int dev = 0, sms = 0, per_sm = 0;\n"
               "  cudaGetDevice(&dev);\n"
               "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
               "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cast_pack_bf16_kernel,\n"
               "                                                kCastThreads, 0);\n"
               "  return static_cast<unsigned int>(want < sms * per_sm ? want : sms * per_sm);")],
    "four_a_thread": [(VECS, "constexpr int kCastVecs = 4;")],
    "threads_256": [(THREADS, "constexpr int kCastThreads = 256;")],
    "one_by_one": [("static_cast<__nv_bfloat16*>(out), n, vec ? n / 4 : 0);",
                    "static_cast<__nv_bfloat16*>(out), n, 0);")],
}
ROUNDS = 3


def main() -> int:
    if not torch.cuda.is_available():
        print("cast_forms: no CUDA card", file=sys.stderr)
        return 1
    card = C.card_line()
    libs = build_forms(SOURCE, OUT, FORMS, {"quant_ring_cast_pack_bf16":
                                            qr._SIGNATURES["cast_pack_bf16"]})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    x = C.kernel_inputs(*C.EMBED_CHUNK_W4, gen, 3.0)
    want = x.to(torch.bfloat16)
    out = torch.empty_like(want)

    def cast(lib):
        err = lib.quant_ring_cast_pack_bf16(x.data_ptr(), out.data_ptr(), x.numel(),
                                            torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    calls = {"x.to(bfloat16)": lambda: x.to(torch.bfloat16)}
    for name, lib in libs.items():
        out.zero_()
        cast(lib)
        if not C.same_bits(out, want):
            raise AssertionError(f"form {name} differs from x.to(bfloat16)")
        calls[name] = lambda lib=lib: cast(lib)
    res = {name: [] for name in calls}
    for _ in range(ROUNDS):
        for name, fn in calls.items():
            res[name].append(C.device_ms(fn, samples=60))
    bound_ms, _ = C.bound("cast_pack_bf16", *C.EMBED_CHUNK_W4)
    summary = {name: {"device_ms": ms, "median": statistics.median(ms),
                      "of_bound": bound_ms / statistics.median(ms)} for name, ms in res.items()}
    for name, row in summary.items():
        print(f"{name}: {json.dumps(row)}", flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "shape": list(C.EMBED_CHUNK_W4), "bound_ms": bound_ms,
                      "forms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
