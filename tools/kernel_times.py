#!/usr/bin/env python3
"""Kernel and step times of one checkout of the port by chip_smoke.py's phases 3 and 4, to compare commits.

Run from the root of a checkout: ``python3 tools/kernel_times.py [--zamba2] [--rwkv] [--out FILE] [ROOT]``.
It needs one card and ``nvcc``. ``ROOT`` (by default this checkout) is the
checkout whose ``src/repro_torch`` is timed: its kernels are built from its
own sources into its own ``build/kernels/``, and its wrappers are called.
Everything else is this checkout's ``chip_smoke``: its phase 3
(``check_kernels``, ``check_flash_attention``, ``check_wkv6``,
``check_ssd``) holds every kernel against its plain version and times it
(``ms``, ``device_ms``, ``host_us``, the library call's, the bound); then
its phase-4 slot of full-width qwen3-0.6b in ``STEP_MODE``
(``run_main_path``: warm steps at w=4 and w=2). With ``--zamba2``, then
also the phase-7 slot of full-width zamba2-1.2b (``ring_slot``: warm steps
at w=4 and w=2). With ``--rwkv``, then also the phase-6 slot of rwkv6-7b
at full width cut to ``RWKV_LAYERS`` layers (``ring_slot``: warm steps at
w=4 and w=2). To compare two commits, unpack the
other one into a directory that ``.gitignore`` lists and run, in one call
and in turns, ``tools/kernel_times.py DIR``, ``tools/kernel_times.py``,
``tools/kernel_times.py``, ``tools/kernel_times.py DIR``.

The last line of the output is the result as JSON (and, with ``--out``,
the file): each kernel's times and the step's, and ``bits``, a sha256 of
the outputs of B4's, B8's and B9's kernels at their main shapes (query
offset 0, zero states) on inputs from fixed seeds. ``python3
tools/kernel_times.py --compare A.json B.json ...`` (no card needed) holds
those digests equal across the runs and prints each of those kernels'
device ms in every run, with its ratio to the first's.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import statistics
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
# the mode of the timed qwen3-0.6b step
STEP_MODE = "compressed-fused"


def load(root: Path):
    """This checkout's ``chip_smoke`` over ``root``'s package: imported
    first, ``root``'s ``repro_torch`` is the one ``chip_smoke``'s imports
    find."""
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    sys.path.insert(1, str(HERE))
    import chip_smoke
    from repro_torch.training import train_step
    if not Path(repro_torch.__file__).resolve().is_relative_to(root):
        raise AssertionError(f"{repro_torch.__file__} is not under {root}")
    if "ring.psum(losses)" not in Path(train_step.__file__).read_text():
        chip_smoke.LOSS_MEAN_PSUMS = 0   # a step that takes the loss mean on the host
    return chip_smoke


def times(row: dict) -> dict:
    """A phase-3 row's times and bound."""
    return {k: v for k, v in row.items()
            if (k == "ms" or k.endswith(("_ms", "_us"))) and isinstance(v, (int, float))}


# the kernels whose bits and device times --compare holds across runs
COMPARED = ("flash_attention_fwd", "flash_attention_bwd_preprocess",
            "flash_attention_bwd_dkdv", "flash_attention_bwd_dq",
            "wkv6_fwd", "wkv6_bwd", "ssd_fwd", "ssd_bwd")


def digests(C) -> dict:
    """A sha256 of each B4, B8 and B9 kernel's outputs at its main shape
    (``FA_TIMED``, ``WKV_TIMED``, ``SSD_TIMED``), query offset 0 and zero
    states, on inputs from fixed seeds; only the outputs both the parent's
    and this checkout's wrappers give (a backward's gradients of the
    inputs, a forward's y and chunk states)."""
    out = {}

    def put(name, tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(C.bits(t.contiguous()).cpu().numpy().tobytes())
        out[name] = h.hexdigest()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    _, dims, causal, window, dtype = next(x for x in C.FA_SHAPES if x[0] == C.FA_TIMED)
    b, sq, skv, hq, hkv, d = dims
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d),
                                 (b, sq, hq, d)))
    opts = dict(causal=causal, window=window)
    o, lse = C.fa.flash_attention_fwd(q, k, v, **opts)
    delta = C.fa.bwd_preprocess(o, do)
    put(COMPARED[0], (o, lse))
    put(COMPARED[1], (delta,))
    put(COMPARED[2], C.fa.bwd_dkdv(q, k, v, do, lse, delta, **opts))
    put(COMPARED[3], (C.fa.bwd_dq(q, k, v, do, lse, delta, **opts),))
    _, dims, dtype, decay = next(x for x in C.WKV_SHAPES if x[0] == C.WKV_TIMED)
    ins, u, dy = C.wkv_inputs(dims, dtype, decay, gen)
    fwd = C.W.wkv6_fwd(*ins, u)
    put(COMPARED[4], fwd[:2])
    put(COMPARED[5], C.W.wkv6_bwd(*ins, u, fwd[1], dy)[:5])
    _, dims, dtype, decay = next(x for x in C.SSD_SHAPES if x[0] == C.SSD_TIMED)
    ins, dy = C.ssd_inputs(dims, dtype, decay, gen)
    fwd = C.SSD.ssd_scan_fwd(*ins)
    put(COMPARED[6], fwd[:2])
    put(COMPARED[7], C.SSD.ssd_scan_bwd(*ins, fwd[1], dy)[:5])
    return out


def compare(paths) -> int:
    """The runs' digests equal, and each compared kernel's device ms in
    every run beside its ratio to the first run's; exit 1 where bits
    differ."""
    runs = [json.loads(Path(p).read_text()) for p in paths]
    same = True
    for name in COMPARED:
        bits = {r["bits"][name] for r in runs}
        ms = [r["rows"][name]["device_ms"] for r in runs]
        same &= len(bits) == 1
        print(f"{name}: bits {'equal' if len(bits) == 1 else 'DIFFER'} in "
              f"{len(runs)} runs; device ms {ms}, ratio to the first "
              f"{[round(m / ms[0], 4) for m in ms]}")
    roots = [r["root"] for r in runs]
    by_root = {root: [r["rows"] for r in runs if r["root"] == root] for root in roots}
    if len(by_root) == 2:
        (a, ra), (b, rb) = by_root.items()
        for name in COMPARED:
            ma = statistics.mean(r[name]["device_ms"] for r in ra)
            mb = statistics.mean(r[name]["device_ms"] for r in rb)
            print(f"{name}: mean device ms {mb:.5g} ({b}) against {ma:.5g} ({a}): "
                  f"{mb / ma:.4f}")
    print(json.dumps({"bits_equal": same, "runs": paths}))
    return 0 if same else 1


def slot_times(C, cfg) -> dict:
    """The warm steps of the smoke's slot of ``cfg`` in the f32 ring mode
    (phase 7's zamba2-1.2b, phase 6's rwkv6-7b)."""
    model = C.build_model(cfg)
    data = C.SyntheticTokens(cfg.vocab, C.SEQ, C.GLOBAL_BATCH, seed=0)
    return {"warm_step_s": C.ring_slot(model, data)[1]["timings"]}


def main() -> int:
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("root", nargs="?", default=str(HERE), help="the checkout to time")
    args.add_argument("--zamba2", action="store_true",
                      help="also zamba2-1.2b's slot")
    args.add_argument("--rwkv", action="store_true",
                      help="also rwkv6-7b's slot (4 layers)")
    args.add_argument("--out", help="also write the result's JSON to this file")
    args.add_argument("--compare", nargs="+", metavar="JSON",
                      help="hold the bits of these runs' --out files equal; no card")
    opts = args.parse_args()
    if opts.compare:
        return compare(opts.compare)
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA card", file=sys.stderr)
        return 1
    root = Path(opts.root).resolve()
    C = load(root)
    card = C.card_line()
    C.build.build_all()
    model = C.build_model(C.get_arch(C.ARCH))
    rows = C.check_kernels(model)
    rows.update(C.check_flash_attention())
    rows.update(C.check_wkv6())
    rows.update(C.check_ssd())
    data = C.SyntheticTokens(model.cfg.vocab, C.SEQ, C.GLOBAL_BATCH, seed=0)
    run = C.run_main_path(model, data, STEP_MODE)
    out = {"card": card, "root": str(root), "bits": digests(C),
           "rows": {name: times(row) for name, row in rows.items()},
           "step": {"mode": STEP_MODE, "warm_step_s": run["res"]["timings"]}}
    del run, model
    C.free_cuda()
    if opts.zamba2:
        out["zamba2"] = slot_times(C, C.get_arch(C.ZAMBA_ARCH))
        C.free_cuda()
    if opts.rwkv:
        out["rwkv"] = slot_times(C, dataclasses.replace(
            C.get_arch(C.RWKV_ARCH), n_layers=C.RWKV_LAYERS))
    for name, row in out["rows"].items():
        print(f"{name}: {json.dumps(row)}", flush=True)
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    if opts.out:
        Path(opts.out).write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
