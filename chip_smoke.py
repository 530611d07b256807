#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
card and ``nvcc``; without a card, or outside the repository, it exits
non-zero and prints no result. Phases, each raising on failure:

  1. require CUDA; print the card's name and power limit;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. hold each kernel bit for bit against its plain PyTorch version at
     every shape the main path gives it (the embed leaf's chunk at w=4 is
     9,496 blocks of 4,096), at ragged shapes, all-zero rows and exact .5
     ties; time kernel, plain version and the one PyTorch call computing
     the same function where there is one, with CUDA events, beside the
     kernel's bound; then train reduced qwen3-0.6b two steps on the card
     and on the CPU (the plain path) from the same weights and compare;
  4. the main path: ``ElasticTrainer`` on qwen3-0.6b at full width over the
     fused int8 ring, ``SlotPlan(workers=4, steps=4, leave=(2, 2))``, each
     kernel's launches counted over exactly that run and held against the
     ring schedule, the ring's bytes against the wire formula; then, on one
     step's gradients, every rank's reduced leaf bit-identical and within
     the reference's rel < 0.15 of the f32 ring sum; and the step's parts
     (forward and backward of every rank, the ring, the update) timed
     apart at w=4 and w=2;
  5. two steps of the f32 ring (mode ``ring``) at w=4 on the same model;
  6. the ``kernels`` JSON line, the card line, and last the result line.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.dist.collectives import LocalRing, ring_all_reduce  # noqa: E402
from repro_torch.dist.compression import (  # noqa: E402
    DEFAULT_BLOCK,
    _fused_chunk_layout,
    compressed_ring_all_reduce,
    compressed_ring_ppermutes,
    compressed_wire_bytes,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import quant_ring as qr  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.module import _flatten, _unflatten, n_params, tree_map  # noqa: E402
from repro_torch.training.elastic import ElasticTrainer, SlotPlan  # noqa: E402
from repro_torch.training.optimizer import make_optimizer  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    rank_grads,
    reduce_grads,
    shard_batch,
)

# H100 SXM peaks (NVIDIA data sheet): device memory, f32 outside tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SOURCE = "src/repro_torch/kernels/csrc/quant_ring.cu"
REPLACES = {                   # the pallas_call of each TPU kernel
    "quantize_pack": "src/repro/kernels/quant_ring.py:188",
    "dequant_add_quantize": "src/repro/kernels/quant_ring.py:226",
    "dequant_accumulate": "src/repro/kernels/quant_ring.py:275",
    "dequant": "src/repro/kernels/quant_ring.py:267",
}
# bytes per element and per row (each input read once, each output written
# once) and f32 operations per element of each kernel
BYTES_PER_ELEM = {"quantize_pack": 5, "dequant_add_quantize": 6,
                  "dequant_accumulate": 9, "dequant": 5}
BYTES_PER_ROW = {"quantize_pack": 4, "dequant_add_quantize": 8,
                 "dequant_accumulate": 4, "dequant": 4}
OPS_PER_ELEM = {"quantize_pack": 6,          # abs, max, div, round, 2 clamps
                "dequant_add_quantize": 8,   # mul, add, then as quantize_pack
                "dequant_accumulate": 2, "dequant": 1}
ARCH, SEQ, GLOBAL_BATCH, LR = "qwen3-0.6b", 1024, 8, 3e-4
PLAN = SlotPlan(workers=4, steps=4, leave=(2, 2))
MAIN_RINGS = [4, 4, 2, 2]      # ring size of each step of PLAN


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, samples: int = 25, calls: int = 10) -> float:
    """Median device milliseconds per call of ``fn``: CUDA events around
    ``calls`` back-to-back calls, ``samples`` times, after a warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


def bound(name: str, nb: int, block: int):
    n = nb * block
    t_bytes = (BYTES_PER_ELEM[name] * n + BYTES_PER_ROW[name] * nb) / HBM_BYTES_PER_S
    t_ops = OPS_PER_ELEM[name] * n / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# -- phase 3: kernels against their plain versions -------------------------

def main_path_shapes(model) -> list:
    """Every ``(w, n_blocks, block)`` the fused ring gives the kernels on
    the main path: each leaf's chunk layout at w=4 and w=2."""
    sizes = [int(math.prod(s.shape)) for _, s in _flatten(model.param_specs())]
    shapes = set()
    for w in sorted(set(MAIN_RINGS)):
        for d in sizes:
            c_pad, nb, _ = _fused_chunk_layout(d, w, DEFAULT_BLOCK)
            shapes.add((w, nb, c_pad // nb))
    return sorted(shapes)


def kernel_inputs(nb: int, block: int, gen: torch.Generator,
                  scale: float) -> torch.Tensor:
    """Random rows; where there are three or more, row 1 is all zero and row
    2 holds exact .5 ties (its amax is 127, so its scale is 1)."""
    x = torch.randn((nb, block), generator=gen, device="cuda") * scale
    if nb > 2:
        x[1] = 0.0
        ties = (torch.arange(block, device="cuda", dtype=torch.float32) % 40) - 20.5
        ties[0] = 127.0
        x[2] = ties
    return x


def check_kernels(model) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    c_pad, nb_embed, _ = _fused_chunk_layout(
        model.cfg.padded_vocab * model.cfg.d_model, 4, DEFAULT_BLOCK)
    timed = (4, nb_embed, c_pad // nb_embed)
    if timed[1:] != (9496, 4096):
        raise AssertionError(f"embed chunk at w=4 is {timed[1:]}")
    shapes = main_path_shapes(model) + [(2, 1, 33), (2, 7, 33), (4, 3, 256)]
    log(f"kernel shapes (w, n_blocks, block): {shapes}")
    rows = {name: {"name": name, "route": "cuda", "source": SOURCE,
                   "replaces": REPLACES[name], "max_abs_err": 0.0}
            for name in REPLACES}

    def check(name, shape, kernel, plain, library=None):
        outs, refs = kernel(), plain()
        outs = outs if isinstance(outs, tuple) else (outs,)
        refs = refs if isinstance(refs, tuple) else (refs,)
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(outs, refs))
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
        if not all(same_bits(a, b) for a, b in zip(outs, refs)):
            raise AssertionError(f"{name}{shape}: kernel differs from its plain "
                                 f"version (max abs err {err})")
        if shape == timed:
            nb, block = outs[0].shape
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            library_ms = cuda_ms(library) if library is not None else None
            bound_ms, bound_by = bound(name, nb, block)
            rows[name].update(shape=[nb, block], ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=library_ms)
            log(f"{name} ({nb}, {block}): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"library {library_ms}, bound {bound_ms:.4f} ms ({bound_by})")

    for shape in shapes:
        w, nb, block = shape
        x = kernel_inputs(nb, block, gen, 3.0)
        acc = kernel_inputs(nb, block, gen, 2.0)
        q, s = qr.quantize_pack(x)
        check("quantize_pack", shape, lambda: qr.quantize_pack(x),
              lambda: qr.quantize_pack_plain(x))
        check("dequant_add_quantize", shape,
              lambda: qr.dequant_add_quantize(q, s, acc),
              lambda: qr.dequant_add_quantize_plain(q, s, acc))
        check("dequant_accumulate", shape,
              lambda: qr.dequant_accumulate(q, s, acc),
              lambda: qr.dequant_accumulate_plain(q, s, acc),
              lambda: torch.addcmul(acc, q, s[:, None]))
        # Share-Only dequantizes all w gathered messages in one call
        qw, sw = q.repeat(w, 1), s.repeat(w)
        check("dequant", shape, lambda: qr.dequant_accumulate(qw, sw),
              lambda: qr.dequant_accumulate_plain(qw, sw),
              lambda: torch.mul(qw, sw[:, None]))
        del x, acc, q, s, qw, sw
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"all four kernels bit-exact against their plain versions at "
        f"{len(shapes)} shapes")
    return rows


def check_small_against_cpu() -> None:
    """Reduced qwen3-0.6b, two fused-ring steps at w=4 on the card and on
    the CPU (the plain versions) from the same weights."""
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg)
    data = SyntheticTokens(cfg.vocab, 16, GLOBAL_BATCH, seed=0)
    params = model.init(0, device="cpu", dtype=torch.float32)
    losses = {}
    for device in ("cpu", "cuda"):
        tr = ElasticTrainer(model, make_optimizer("adamw"), data,
                            global_batch=GLOBAL_BATCH, base_lr=1e-3,
                            mode="compressed-fused", device=device,
                            params=tree_map(lambda t, d=device: t.to(d), params))
        tr.run_slot(SlotPlan(workers=4, steps=2))
        losses[device] = tr.losses
    gap = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
    log(f"reduced model, card vs CPU losses {losses['cuda']} vs "
        f"{losses['cpu']}: max gap {gap:.3g}")
    if not gap < 1e-3:
        raise AssertionError(f"card and CPU losses differ by {gap}")


# -- phase 4: the main path -------------------------------------------------

def expected_launches(n_leaves: int) -> dict:
    """Launches of each kernel the fused ring's schedule makes over PLAN:
    per step and leaf, each rank quantizes twice, requantizes w-2 times,
    accumulates once and dequantizes once."""
    out = dict.fromkeys(qr.LAUNCHES, 0)
    for w in MAIN_RINGS:
        out["quantize_pack"] += n_leaves * 2 * w
        out["dequant_add_quantize"] += n_leaves * w * (w - 2)
        out["dequant_accumulate"] += n_leaves * w
        out["dequant"] += n_leaves * w
    return out


def main_path(model, data) -> dict:
    trainer = ElasticTrainer(model, make_optimizer("adamw"), data,
                             global_batch=GLOBAL_BATCH, base_lr=LR,
                             mode="compressed-fused", device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    qr.reset_launches()
    t0 = time.perf_counter()
    res = trainer.run_slot(PLAN)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(qr.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    losses = trainer.losses
    log(f"main path: losses {losses}, warm step s {res['timings']}, slot "
        f"{seconds:.3f} s, peak {peak / 2**30:.3f} GiB, launches {launches}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    if trainer.re_ring_events != 1 or len(losses) != PLAN.steps:
        raise AssertionError(f"re_ring_events {trainer.re_ring_events}, "
                             f"{len(losses)} steps")
    sizes = [v.numel() for _, v in _flatten(next(iter(trainer.params.values())))]
    want = expected_launches(len(sizes))
    if len(sizes) != 14 or launches != want:
        raise AssertionError(f"{len(sizes)} leaves, kernel launches {launches} "
                             f"!= schedule {want}")

    # LocalRing's own counts against the wire formula, per ring size
    for w in sorted(set(MAIN_RINGS)):
        steps = MAIN_RINGS.count(w)
        trainer.group.form(w)          # the cached ring program of size w
        ring = trainer.group.current.ring
        want_bytes = steps * sum(compressed_wire_bytes(d, w, fused=True) for d in sizes)
        want_msgs = steps * len(sizes) * compressed_ring_ppermutes(w, fused=True)
        if ring.bytes != [want_bytes] * w or ring.messages != [want_msgs] * w:
            raise AssertionError(f"w={w}: ring sent {ring.bytes} B in "
                                 f"{ring.messages} messages, formula "
                                 f"{want_bytes} B in {want_msgs}")
    log("ring bytes and messages equal compressed_wire_bytes at w=4 and w=2")
    return {"trainer": trainer, "res": res, "launches": launches,
            "peak_bytes": peak, "slot_s": seconds}


def synced_s(fn):
    """``(seconds, issue_seconds, result)`` of ``fn`` between two device
    syncs. ``issue_seconds`` ends when ``fn`` returns, before the closing
    sync: where it is close to ``seconds``, the host's issuing of work, not
    the device, sets the pace."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return time.perf_counter() - t0, issued, out


def check_reduction(model, trainer, data) -> dict:
    """One step's gradients through the fused ring against the f32 ring;
    then the step's parts on the trainer's state, at w=4 and w=2, each the
    best of three: every rank's forward and backward, the fused ring's
    reduction of all leaves, and the optimizer update."""
    batch = {k: torch.as_tensor(v) for k, v in data.batch(trainer.step).items()}
    parts = {}
    worst = 0.0
    for w in (4, 2):
        devices = trainer.group.devices[:w]
        ring = LocalRing(devices)
        grads_s, grads_issue_s = float("inf"), None
        for _ in range(3):
            t, issued, (_, grads) = synced_s(lambda: rank_grads(
                model, trainer.params, shard_batch(batch, devices), devices))
            if t < grads_s:
                grads_s, grads_issue_s = t, issued
        if w == 4:
            for path in grads[0]:
                xs = [g[path] for g in grads]
                fused = compressed_ring_all_reduce(xs, ring, fused=True)
                exact = ring_all_reduce(xs, ring)
                if not all(same_bits(fused[0], f) for f in fused[1:]):
                    raise AssertionError(f"{path}: ranks disagree after the fused ring")
                rel = float((fused[0] - exact[0]).abs().max()
                            / (exact[0].abs().max() + 1e-30))
                worst = max(worst, rel)
                if not rel < 0.15:
                    raise AssertionError(f"{path}: fused ring rel err {rel} >= 0.15")
                del fused, exact
            log(f"one step's reduced grads: ranks bit-identical, worst leaf "
                f"rel err {worst:.6g} against the f32 ring")
        ring_s = min(synced_s(lambda: reduce_grads(
            [dict(g) for g in grads], ring, "compressed-fused"))[0]
            for _ in range(3))
        parts[w] = {"grads_s": grads_s, "grads_issue_s": grads_issue_s,
                    "ring_s": ring_s}
        reduced = reduce_grads(grads, ring, "compressed-fused")[0]
        home = devices[0]
        parts[w]["update_s"] = min(synced_s(lambda: trainer.optimizer.update(
            _unflatten(reduced), trainer.opt_state[home],
            trainer.params[home], lr=LR))[0] for _ in range(3))
        del reduced, grads
        torch.cuda.empty_cache()
    return {"worst_rel": worst, "parts": parts}


def ring_mode(model, data, params) -> list:
    trainer = ElasticTrainer(model, make_optimizer("adamw"), data,
                             global_batch=GLOBAL_BATCH, base_lr=LR,
                             mode="ring", device="cuda", params=params)
    qr.reset_launches()
    trainer.run_slot(SlotPlan(workers=4, steps=2))
    if any(qr.LAUNCHES.values()):
        raise AssertionError(f"the f32 ring launched quant kernels: {qr.LAUNCHES}")
    if not all(math.isfinite(x) for x in trainer.losses):
        raise AssertionError(f"f32 ring losses not finite: {trainer.losses}")
    log(f"f32 ring at w=4: losses {trainer.losses}")
    return trainer.losses


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs "
              "a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    built = build.build_all()
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.3f} s")

    cfg = get_arch(ARCH)
    model = build_model(cfg)
    rows = check_kernels(model)
    check_small_against_cpu()

    data = SyntheticTokens(cfg.vocab, SEQ, GLOBAL_BATCH, seed=0)
    log(f"main path: {cfg.name}, {n_params(model.param_specs())} params, "
        f"seq {SEQ}, global batch {GLOBAL_BATCH}, {PLAN}")
    main_run = main_path(model, data)
    trainer, step_s = main_run["trainer"], main_run["res"]["timings"]
    for name, row in rows.items():
        row["launches"] = main_run["launches"][name]
    red = check_reduction(model, trainer, data)
    summary = {
        "arch": cfg.name, "seq": SEQ, "global_batch": GLOBAL_BATCH,
        "losses": trainer.losses, "slot_s": main_run["slot_s"],
        "warm_step_s": {str(w): s for w, s in step_s.items()},
        "step_parts_s": {str(w): p for w, p in red["parts"].items()},
        "ring_share": {str(w): red["parts"][w]["ring_s"] / step_s[w]
                       for w in step_s},
        "peak_gib": main_run["peak_bytes"] / 2**30,
        "worst_leaf_rel": red["worst_rel"],
    }
    log("summary " + json.dumps(summary))

    params = next(iter(trainer.params.values()))
    del trainer, main_run
    ring_mode(model, data, params)

    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
