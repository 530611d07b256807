#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
card and ``nvcc``; without a card, or outside the repository, it exits
non-zero and prints no result. Phases, each raising on failure:

  1. require CUDA; print the card's name and power limit;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. hold each of the twelve kernels (the int8 and fp8 instantiations of
     the four quantized kernels, and the four bf16 kernels) bit for bit
     against its plain PyTorch version at every shape the main paths give
     it (each leaf's chunk at w=4 and w=2, and each bucket's of the
     overlap mode; the embed leaf's chunk at w=4 is 9,496 blocks of
     4,096), at ragged shapes, all-zero rows, exact .5 ties, values at
     +-448, e4m3 subnormals and bf16 ties; time kernel, plain version and
     the one PyTorch call computing the same function where there is one,
     with CUDA events, beside the kernel's bound; then train reduced
     qwen3-0.6b two steps in each kernel mode on the card and on the CPU
     (the plain path) from the same weights and compare;
  4. the main paths: ``ElasticTrainer`` on qwen3-0.6b at full width,
     ``SlotPlan(workers=4, steps=4, leave=(2, 2))``, once in each of the
     modes ``compressed-fused``, ``bf16-fused``, ``fp8-fused`` and
     ``compressed-fused-overlap``. Each run's kernel launches are counted
     over exactly that run and held against the mode's ring schedule (per
     leaf, or per bucket of the overlap plan), the ring's bytes and
     messages against the wire formulas; then, on one step's gradients,
     every rank's reduced leaf bit-identical, and what each ring call
     reduced (a leaf; a bucket in the overlap mode) within the reference's
     limit of the f32 ring sum (bf16 0.02, fp8 0.25, int8 0.15); and the
     step's parts (forward and backward of every rank, the ring, the
     update) timed apart at w=4 and w=2, with the peak memory of the run;
  5. the modes without kernels, ``ring``, ``bidir``, ``psum`` and
     ``compressed``, two steps each at w=4 on the model cut to 4 layers,
     with no kernel launched and the ring's counts against the formulas;
  6. the ``kernels`` JSON line, the card line, and last the result line.
"""

from __future__ import annotations

import dataclasses
import gc
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
    compressed_ring_ppermutes,
    compressed_wire_bytes,
    fused_wire_bytes,
)
from repro_torch.dist.overlap import plan_bucket_sizes, plan_buckets, tree_leaves  # noqa: E402
from repro_torch.dist.registry import STEP_MODES  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import quant_ring as qr  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.module import _unflatten, n_params, tree_map  # noqa: E402
from repro_torch.training.elastic import ElasticTrainer, SlotPlan  # noqa: E402
from repro_torch.training.optimizer import make_optimizer  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    rank_grads,
    reduce_grads,
    shard_batch,
)

DEVICE = "cuda"
FP8 = qr.FP8_DTYPE
# H100 SXM peaks (NVIDIA data sheet): device memory, f32 outside tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SOURCE = "src/repro_torch/kernels/csrc/quant_ring.cu"
_REF = "src/repro/kernels/quant_ring.py"
# kernel -> (the pallas_call it replaces, bytes per element and per row with
# each input read once and each output written once, f32 operations per
# element); the fp8 instantiations move and compute what int8's do
KERNELS = {
    "quantize_pack": (f"{_REF}:188", 5, 4, 6),        # abs, max, div, round, 2 clamps
    "dequant_add_quantize": (f"{_REF}:226", 6, 8, 8),  # mul, add, then as above
    "dequant_accumulate": (f"{_REF}:275", 9, 4, 2),
    "dequant": (f"{_REF}:267", 5, 4, 1),
}
KERNELS.update({f"{name}_fp8": spec for name, spec in KERNELS.items()})
KERNELS.update({
    "cast_pack_bf16": (f"{_REF}:303", 6, 0, 1),
    "bf16_add_cast": (f"{_REF}:328", 8, 0, 2),
    "bf16_accumulate": (f"{_REF}:370", 10, 0, 1),
    "bf16_upcast": (f"{_REF}:362", 6, 0, 1),
})
# the kernels of each mode's schedule: (send quantize, steady hop, last
# Share-Reduce hop, Share-Only unpack)
MODE_KERNELS = {
    "compressed-fused": ("quantize_pack", "dequant_add_quantize",
                         "dequant_accumulate", "dequant"),
    "bf16-fused": ("cast_pack_bf16", "bf16_add_cast", "bf16_accumulate",
                   "bf16_upcast"),
    "fp8-fused": ("quantize_pack_fp8", "dequant_add_quantize_fp8",
                  "dequant_accumulate_fp8", "dequant_fp8"),
    "compressed-fused-overlap": ("quantize_pack", "dequant_add_quantize",
                                 "dequant_accumulate", "dequant"),
}
# the reference's limit on the error of what one ring call reduces against
# the f32 ring, as a share of its largest sum (tests/test_dist.py:381, :547)
REL_LIMIT = {"compressed-fused": 0.15, "bf16-fused": 0.02, "fp8-fused": 0.25,
             "compressed-fused-overlap": 0.15}
PLAIN_MODES = ("ring", "bidir", "psum", "compressed")
PLAIN_MODE_LAYERS = 4
ARCH, SEQ, GLOBAL_BATCH, LR = "qwen3-0.6b", 1024, 8, 3e-4
EMBED_CHUNK_W4 = (9496, 4096)  # the embed leaf's (n_blocks, block) at w=4
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


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s raw bits as an integer tensor of its element size."""
    return t.view({4: torch.int32, 2: torch.int16, 1: torch.uint8}[t.element_size()])


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and bool(torch.equal(bits(a), bits(b))))


def bound(name: str, nb: int, block: int):
    _, per_elem, per_row, ops = KERNELS[name]
    n = nb * block
    t_bytes = (per_elem * n + per_row * nb) / HBM_BYTES_PER_S
    t_ops = ops * n / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def free_cuda() -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# -- phase 3: kernels against their plain versions -------------------------

def leaf_sizes(tree) -> list:
    """Leaf sizes of a parameter (or spec) tree in ``jax.tree.flatten``'s
    order, the order the overlap mode plans its buckets in."""
    return [int(math.prod(leaf.shape)) for _, leaf in tree_leaves(tree)]


def main_path_shapes(model) -> list:
    """Every ``(w, n_blocks, block)`` the fused rings give the kernels on
    the main paths: each leaf's chunk layout, and each bucket's of the
    overlap mode's plan, at w=4 and w=2."""
    sizes = leaf_sizes(model.param_specs())
    buckets = plan_bucket_sizes(
        sizes, STEP_MODES["compressed-fused-overlap"].n_buckets, reverse=True)
    shapes = set()
    for w in sorted(set(MAIN_RINGS)):
        for d in sizes + buckets:
            c_pad, nb, _ = _fused_chunk_layout(d, w, DEFAULT_BLOCK)
            shapes.add((w, nb, c_pad // nb))
    return sorted(shapes)


def kernel_inputs(nb: int, block: int, gen: torch.Generator,
                  scale: float) -> torch.Tensor:
    """Random rows, with special rows where there are enough: row 1 all
    zero; row 2 exact .5 ties of the int8 codes (amax 127, so its int8
    scale is 1); row 3 amax 448 (its fp8 scale is 1) with +-448, e4m3 ties
    (1.0625 lies halfway between 1 and 1.125) and values in e4m3's
    subnormal range (below 2^-6) and halfway between two of them; row 4
    f32 values halfway between two bf16 values."""
    x = torch.randn((nb, block), generator=gen, device=DEVICE) * scale
    k = torch.arange(block, device=DEVICE, dtype=torch.float32)
    if nb > 1:
        x[1] = 0.0
    if nb > 2:
        ties = (k % 40) - 20.5
        ties[0] = 127.0
        x[2] = ties
    if nb > 3:
        row = torch.where(k % 4 == 0, (k % 13 - 6) * 2.0 ** -9,
              torch.where(k % 4 == 1, (k % 7 + 0.5) * 2.0 ** -9,
              torch.where(k % 4 == 2, 1.0625 * (1 + k % 3), -(k % 50))))
        row[0] = 448.0
        if block > 1:
            row[1] = -448.0
        x[3] = row
    if nb > 4:
        # a bf16 value plus half its spacing: the low 16 bits are 0x8000
        h = x[4].to(torch.bfloat16).float().view(torch.int32)
        x[4] = (h | 0x8000).view(torch.float32)
    return x


def check_kernels(model) -> dict:
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    c_pad, nb_embed, _ = _fused_chunk_layout(
        model.cfg.padded_vocab * model.cfg.d_model, 4, DEFAULT_BLOCK)
    timed = (4, nb_embed, c_pad // nb_embed)
    if timed[1:] != EMBED_CHUNK_W4:
        raise AssertionError(f"embed chunk at w=4 is {timed[1:]}")
    shapes = main_path_shapes(model) + [(2, 1, 33), (2, 7, 33), (4, 3, 256)]
    log(f"kernel shapes (w, n_blocks, block): {shapes}")
    rows = {name: {"name": name, "route": "cuda", "source": SOURCE,
                   "replaces": spec[0], "max_abs_err": 0.0}
            for name, spec in KERNELS.items()}

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
            log(f"{name} ({nb}, {block}): {ms:.5g} ms, plain {plain_ms:.5g} ms, "
                f"library {library_ms}, bound {bound_ms:.5g} ms ({bound_by})")

    for shape in shapes:
        w, nb, block = shape
        x = kernel_inputs(nb, block, gen, 3.0)
        acc = kernel_inputs(nb, block, gen, 2.0)
        for wire, sfx in ((torch.int8, ""), (FP8, "_fp8")):
            q, s = qr.quantize_pack(x, wire)
            check(f"quantize_pack{sfx}", shape, lambda: qr.quantize_pack(x, wire),
                  lambda: qr.quantize_pack_plain(x, wire))
            check(f"dequant_add_quantize{sfx}", shape,
                  lambda: qr.dequant_add_quantize(q, s, acc),
                  lambda: qr.dequant_add_quantize_plain(q, s, acc))
            # torch has no arithmetic on float8 operands: no library call
            lib = wire == torch.int8
            check(f"dequant_accumulate{sfx}", shape,
                  lambda: qr.dequant_accumulate(q, s, acc),
                  lambda: qr.dequant_accumulate_plain(q, s, acc),
                  (lambda: torch.addcmul(acc, q, s[:, None])) if lib else None)
            # Share-Only dequantizes all w gathered messages in one call
            qw, sw = q.repeat(w, 1), s.repeat(w)
            check(f"dequant{sfx}", shape, lambda: qr.dequant_accumulate(qw, sw),
                  lambda: qr.dequant_accumulate_plain(qw, sw),
                  (lambda: torch.mul(qw, sw[:, None])) if lib else None)
            del q, s, qw, sw
        h = qr.cast_pack_bf16(x)
        out = torch.empty_like(h)
        check("cast_pack_bf16", shape, lambda: qr.cast_pack_bf16(x),
              lambda: qr.cast_pack_bf16_plain(x), lambda: x.to(torch.bfloat16))
        check("bf16_add_cast", shape, lambda: qr.bf16_add_cast(h, acc),
              lambda: qr.bf16_add_cast_plain(h, acc),
              lambda: torch.add(acc, h, out=out))
        check("bf16_accumulate", shape, lambda: qr.bf16_accumulate(h, acc),
              lambda: qr.bf16_accumulate_plain(h, acc), lambda: torch.add(acc, h))
        hw = h.repeat(w, 1)
        check("bf16_upcast", shape, lambda: qr.bf16_accumulate(hw),
              lambda: qr.bf16_accumulate_plain(hw), lambda: hw.to(torch.float32))
        del x, acc, h, hw, out
    free_cuda()
    log(f"all {len(KERNELS)} kernels bit-exact against their plain versions "
        f"at {len(shapes)} shapes")
    return rows


def check_small_against_cpu(mode: str) -> None:
    """Reduced qwen3-0.6b, two steps of ``mode`` at w=4 on the card and on
    the CPU (the plain versions) from the same weights."""
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg)
    data = SyntheticTokens(cfg.vocab, 16, GLOBAL_BATCH, seed=0)
    params = model.init(0, device="cpu", dtype=torch.float32)
    losses = {}
    for device in ("cpu", DEVICE):
        tr = ElasticTrainer(model, make_optimizer("adamw"), data,
                            global_batch=GLOBAL_BATCH, base_lr=1e-3,
                            mode=mode, device=device,
                            params=tree_map(lambda t, d=device: t.to(d), params))
        tr.run_slot(SlotPlan(workers=4, steps=2))
        losses[device] = tr.losses
    gap = max(abs(a - b) for a, b in zip(losses["cpu"], losses[DEVICE]))
    log(f"reduced model, {mode}, card vs CPU losses {losses[DEVICE]} vs "
        f"{losses['cpu']}: max gap {gap:.3g}")
    if not gap < 1e-3:
        raise AssertionError(f"{mode}: card and CPU losses differ by {gap}")


# -- phase 4: the main paths ------------------------------------------------

def ring_units(mode: str, sizes: list) -> list:
    """The flat sizes the mode reduces one ring call each: every leaf, or
    every bucket of the overlap mode's reverse-autodiff plan."""
    n_buckets = STEP_MODES[mode].n_buckets
    if n_buckets is None:
        return list(sizes)
    return plan_bucket_sizes(sizes, n_buckets, reverse=True)


def expected_launches(mode: str, sizes: list) -> dict:
    """Launches of each kernel the mode's schedule makes over PLAN: per step
    and ring call, each rank quantizes (or casts) twice, requantizes w-2
    times, accumulates once and dequantizes (or upcasts) once."""
    send, hop, last, unpack = MODE_KERNELS[mode]
    n = len(ring_units(mode, sizes))
    out = dict.fromkeys(qr.LAUNCHES, 0)
    for w in MAIN_RINGS:
        out[send] += n * 2 * w
        out[hop] += n * w * (w - 2)
        out[last] += n * w
        out[unpack] += n * w
    return out


def unit_wire(mode: str, d: int, w: int):
    """(bytes, messages) one rank sends for one ring call of ``d`` elements,
    from the port's compression accounting."""
    if mode in ("compressed-fused", "compressed-fused-overlap"):
        return (compressed_wire_bytes(d, w, fused=True),
                compressed_ring_ppermutes(w, fused=True))
    wire = {"bf16-fused": "bf16", "fp8-fused": "fp8"}[mode]
    return fused_wire_bytes(d, w, wire=wire), 2 * (w - 1)


def check_wire(mode: str, trainer, sizes: list, rings: list) -> None:
    """``LocalRing``'s counts of each ring size used, against the
    registry's ``wire_formula`` expectation for the mode's ring calls."""
    variant = STEP_MODES[mode].leaf_variant()
    units = ring_units(mode, sizes)
    for w in sorted(set(rings)):
        steps = rings.count(w)
        trainer.group.form(w)          # the cached ring program of size w
        ring = trainer.group.current.ring
        want_bytes = steps * sum(variant.expected_bytes(d, w) for d in units)
        want_msgs = steps * sum(variant.expected_messages(w, d) for d in units)
        want_psums = steps * len(units) if variant.collective == "psum" else 0
        if (ring.bytes != [want_bytes] * w or ring.messages != [want_msgs] * w
                or ring.psums != [want_psums] * w):
            raise AssertionError(
                f"{mode} w={w}: ring sent {ring.bytes} B in {ring.messages} "
                f"messages and {ring.psums} psums; formula {want_bytes} B in "
                f"{want_msgs} messages and {want_psums} psums")


def run_main_path(model, data, mode: str) -> dict:
    """One full-width slot of ``mode``, with the launch counters set to 0
    just before it and read just after."""
    trainer = ElasticTrainer(model, make_optimizer("adamw"), data,
                             global_batch=GLOBAL_BATCH, base_lr=LR,
                             mode=mode, device=DEVICE)
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
    log(f"{mode}: losses {losses}, warm step s {res['timings']}, slot "
        f"{seconds:.4f} s, peak {peak / 2**30:.4f} GiB, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{mode}: losses not finite and falling: {losses}")
    if trainer.re_ring_events != 1 or len(losses) != PLAN.steps:
        raise AssertionError(f"{mode}: re_ring_events {trainer.re_ring_events}, "
                             f"{len(losses)} steps")
    sizes = leaf_sizes(next(iter(trainer.params.values())))
    want = expected_launches(mode, sizes)
    if len(sizes) != 14 or launches != want:
        raise AssertionError(f"{mode}: {len(sizes)} leaves, kernel launches "
                             f"{launches} != schedule {want}")
    check_wire(mode, trainer, sizes, MAIN_RINGS)
    variant = STEP_MODES[mode].leaf_variant()
    for w in sorted(set(MAIN_RINGS)):
        for d in ring_units(mode, sizes):
            if unit_wire(mode, d, w) != (variant.expected_bytes(d, w),
                                         variant.expected_messages(w, d)):
                raise AssertionError(f"{mode} w={w} d={d}: the compression "
                                     "accounting disagrees with wire_formula")
    log(f"{mode}: launches equal the schedule over {len(ring_units(mode, sizes))} "
        f"ring calls a step; ring bytes and messages equal the formulas")
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


def ring_unit_paths(mode: str, paths: list, sizes: list) -> list:
    """The leaf paths of each ring call of the mode: one leaf each, or the
    leaves of each bucket of the overlap mode's plan."""
    n_buckets = STEP_MODES[mode].n_buckets
    if n_buckets is None:
        return [[p] for p in paths]
    return [[paths[i] for i in bucket]
            for bucket in plan_buckets(sizes, n_buckets, reverse=True)]


def check_reduction(model, trainer, data, mode: str) -> dict:
    """One step's gradients through the mode's ring against the f32 ring;
    then the step's parts on the trainer's state, at w=4 and w=2, each the
    best of three: every rank's forward and backward, the mode's reduction
    of all leaves, and the optimizer update.

    The reference's limit holds for what one ring call reduces: a leaf, or
    in the overlap mode a bucket, whose concatenated leaves share
    quantization blocks. There the error of a leaf of small gradients
    beside a leaf of large ones is measured against the bucket's largest
    sum, and reported per leaf as well."""
    batch = {k: torch.as_tensor(v) for k, v in data.batch(trainer.step).items()}
    parts = {}
    worst = {}
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
            reduced = reduce_grads([dict(g) for g in grads], ring, mode)
            err, peak = {}, {}        # per leaf: max |got - exact|, max |exact|
            for path in grads[0]:
                got = [r.pop(path) for r in reduced]
                if not all(same_bits(got[0], g) for g in got[1:]):
                    raise AssertionError(f"{mode} {path}: ranks disagree")
                exact = ring_all_reduce([g[path] for g in grads], ring)[0] / w
                err[path] = float((got[0] - exact).abs().max())
                peak[path] = float(exact.abs().max())
                del got, exact
            del reduced
            leaves = tree_leaves(grads[0])
            units = ring_unit_paths(mode, [p for p, _ in leaves],
                                    [v.numel() for _, v in leaves])
            for unit in units:
                rel = max(err[p] for p in unit) / (max(peak[p] for p in unit) + 1e-30)
                worst["unit"] = max(worst.get("unit", 0.0), rel)
                if not rel < REL_LIMIT[mode]:
                    raise AssertionError(f"{mode} {unit}: rel err {rel} >= "
                                         f"{REL_LIMIT[mode]}")
            leaf_rel = {p: err[p] / (peak[p] + 1e-30) for p in err}
            worst["leaf"] = max(leaf_rel.values())
            worst["leaf_path"] = max(leaf_rel, key=leaf_rel.get)
            log(f"{mode}: one step's reduced grads: ranks bit-identical; worst "
                f"of the {len(units)} ring calls rel err {worst['unit']:.6g}, "
                f"worst leaf {worst['leaf']:.6g} ({worst['leaf_path']}), "
                f"against the f32 ring")
        ring_s = min(synced_s(lambda: reduce_grads(
            [dict(g) for g in grads], ring, mode))[0] for _ in range(3))
        parts[w] = {"grads_s": grads_s, "grads_issue_s": grads_issue_s,
                    "ring_s": ring_s}
        reduced = reduce_grads(grads, ring, mode)[0]
        home = devices[0]
        parts[w]["update_s"] = min(synced_s(lambda: trainer.optimizer.update(
            _unflatten(reduced), trainer.opt_state[home],
            trainer.params[home], lr=LR))[0] for _ in range(3))
        del reduced, grads
        free_cuda()
    return {"worst": worst, "parts": parts}


# -- phase 5: the modes without kernels ---------------------------------------

def plain_mode(mode: str, model, data) -> list:
    trainer = ElasticTrainer(model, make_optimizer("adamw"), data,
                             global_batch=GLOBAL_BATCH, base_lr=LR,
                             mode=mode, device=DEVICE)
    qr.reset_launches()
    trainer.run_slot(SlotPlan(workers=4, steps=2))
    if any(qr.LAUNCHES.values()):
        raise AssertionError(f"{mode} launched kernels: {qr.LAUNCHES}")
    if not all(math.isfinite(x) for x in trainer.losses):
        raise AssertionError(f"{mode} losses not finite: {trainer.losses}")
    sizes = leaf_sizes(next(iter(trainer.params.values())))
    check_wire(mode, trainer, sizes, [4, 4])
    log(f"{mode} at w=4, {PLAIN_MODE_LAYERS} layers: losses {trainer.losses}, "
        f"no kernel launched, ring counts equal the formula")
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
    for mode in MODE_KERNELS:
        check_small_against_cpu(mode)

    data = SyntheticTokens(cfg.vocab, SEQ, GLOBAL_BATCH, seed=0)
    log(f"main paths: {cfg.name}, {n_params(model.param_specs())} params, "
        f"seq {SEQ}, global batch {GLOBAL_BATCH}, {PLAN}")
    for row in rows.values():
        row["launches"] = 0
        row["launches_by_mode"] = {}
    summary = {"arch": cfg.name, "seq": SEQ, "global_batch": GLOBAL_BATCH,
               "modes": {}}
    for mode in MODE_KERNELS:
        run = run_main_path(model, data, mode)
        trainer, step_s = run["trainer"], run["res"]["timings"]
        for name, n in run["launches"].items():
            if n:
                rows[name]["launches"] += n
                rows[name]["launches_by_mode"][mode] = n
        red = check_reduction(model, trainer, data, mode)
        summary["modes"][mode] = {
            "losses": trainer.losses, "slot_s": run["slot_s"],
            "warm_step_s": {str(w): s for w, s in step_s.items()},
            "step_parts_s": {str(w): p for w, p in red["parts"].items()},
            "ring_share": {str(w): red["parts"][w]["ring_s"] / step_s[w]
                           for w in step_s},
            "peak_gib": run["peak_bytes"] / 2**30,
            "worst_ring_call_rel": red["worst"]["unit"],
            "worst_leaf_rel": red["worst"]["leaf"],
            "worst_leaf": red["worst"]["leaf_path"],
        }
        log(f"summary {mode} " + json.dumps(summary["modes"][mode]))
        del trainer, run
        free_cuda()
    missing = [name for name, row in rows.items() if not row["launches"]]
    if missing:
        raise AssertionError(f"kernels no main path launched: {missing}")

    cut = dataclasses.replace(cfg, n_layers=PLAIN_MODE_LAYERS)
    cut_model = build_model(cut)
    for mode in PLAIN_MODES:
        plain_mode(mode, cut_model, data)
        free_cuda()

    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
