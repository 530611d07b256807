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
     +-448, e4m3 subnormals and bf16 ties, and the bf16 cast on inputs off
     16 bytes; time kernel, plain version and the one PyTorch call
     computing the same function where there is one, with CUDA events,
     beside the kernel's bound; hold B4's four kernels
     (flash attention: forward, and the backward's delta, dK/dV and dQ)
     against their plain versions at the main paths' per-rank attention
     shapes, granite-3-2b's and h2o-danube-1.8b's (window 4096), ragged
     non-causal lengths and bf16, each run twice for identical bits, and
     time them beside their bounds (f32 FMAs; for F1, F3 and F4 also the
     split TF32 form on the tensor cores), their blocks per SM, their plain
     versions and ``scaled_dot_product_attention`` (its forward, its
     backward alone, which is F3's and F4's library time, and both, with
     the CUDA kernels it launches); hold B8's two kernels (RWKV6's WKV:
     forward W1, backward W2) against their plain versions at the RWKV6
     path's per-rank shapes at w=4 and w=2, the loop's reduced shape, a
     ragged length, every step at the decay clamp, a weak decay and bf16,
     each run twice for identical bits, and time them beside their bounds
     (f32 FMAs and the split TF32 form on the tensor cores) and their plain
     versions, with the largest operand each factorization forms; hold
     B9's two kernels (Mamba2's SSD scan: forward S1, backward S2) against
     their plain versions at the Zamba2 path's per-rank shapes at w=4 and
     w=2, the reduced model's, a ragged length,
     a weak decay (A = -0.01 exp(N) a head, so the carried state weighs)
     and bf16, each run twice for identical bits, and time them beside
     their bounds (f32 FMAs and the split TF32 form on the tensor cores)
     and their plain versions; then the state-carrying forms at the main
     shapes: B4's four kernels at query offset 512 (q the last 512 of 1024
     rows against all the keys, causal, and causal in a window of 300), B8's
     and B9's from a random initial state with a random final-state
     gradient (y, the chunk states, the final state, every gradient with
     the initial state's), each against its plain version within its
     kernel's limits and timed beside the zero-state row; hold AdamW's leaf
     kernel (``adamw.cu``, no TPU counterpart) bit for bit against its plain
     version in p', m' and v' at every leaf shape of rwkv6-7b at 4 layers
     and phi3.5-moe-42b at 1 (the benchmark's configurations), and with
     bf16 parameters or gradients at ragged lengths and off 16 bytes, and
     time it at each one's largest leaf beside its byte bound and its plain
     version (no library call computes the same arrangement). Every kernel and
     library call timed is also timed on the device alone (``device_ms``: the summed
     durations of the CUDA kernels one call launches, from
     ``torch.profiler``, its inputs evicted from the L2 first) and every
     kernel's wrapper on the host alone (``host_us``, while the device is
     kept busy); then train reduced qwen3-0.6b
     two steps in each kernel mode on the card (attention through B4) and
     on the CPU (the plain path) from the same weights and compare, reduced
     rwkv6-7b two steps of the f32 ring (its time-mix through B8) likewise,
     and reduced zamba2-1.2b likewise (its SSD through B9, its shared
     attention through B4), with one rank's gradients compared leaf by
     leaf;
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
     update) timed apart at w=4 and w=2, with the peak memory of the run.
     B4's launches are held to the model's schedule over each run (per
     step at ring size w, with remat: the forward 2*L*w times, each
     backward kernel L*w), and its share of one rank's forward and
     backward is timed with CUDA events;
  5. the modes without ring kernels, ``ring``, ``bidir``, ``psum`` and
     ``compressed``, two steps each at w=4 on the model cut to 4 layers,
     with no ring kernel launched, B4 launched on the same schedule, and
     the ring's counts against the formulas;
  6. the RWKV6 path: ``ElasticTrainer`` on rwkv6-7b at full width (d_model
     4096, 64 heads of 64, d_ff 14336, vocab 65536) with the depth cut to 4
     layers, ``PLAN`` in the f32 ``ring`` mode; B8's launches held to the
     model's schedule (with remat W1 2*L*w times a step, W2 L*w times), and
     AdamW's to one a leaf a step (as in phases 7 and 10),
     every step's loss and a held-out loss against the same slot with the
     time-mix through the plain recurrence on the card, warm steps, peak
     memory, and B8's share of one rank's forward and backward;
  7. the Zamba2 path: ``ElasticTrainer`` on zamba2-1.2b at full width and
     full depth (38 Mamba2 layers, d_model 2048, 64 SSD heads of 64, state
     64; the shared attention block, 32 heads of 64, d_ff 8192, applied 6
     times; vocab 32000), ``PLAN`` in the f32 ``ring`` mode; B9's and B4's
     launches held to the model's schedule (with remat S1 2*L*w times a
     step and S2 L*w; the shared attention, which is not rematerialized,
     6*w times each kernel), every S1 and S2 call of one rank's forward
     and backward against the plain versions on the path's own inputs (and
     S1 against the SSD in f64, no further than the model's plain
     ``ssd_chunked`` is), warm steps, peak memory, B9's and B4's shares of
     one rank's forward and backward (the slot is not held against one
     through the plain SSD: the model at random init amplifies any
     reordering of its sums; ``tools/zamba2_ssd_forms.py`` measures that);
 7b. the state-carrying path (``state_carry_path``): a sequence of 1024
     tokens in two halves, the second from the states the first returns,
     against the whole, at full width and 2 rows: each of zamba2-1.2b's 38
     Mamba2 layers from its own input in the whole sequence's forward
     (``mamba2_block``, SSM and conv states), its shared attention's 6
     applications (the second half's queries at ``q_offset=512`` over all
     1024 keys), and rwkv6-7b's WKV in 4 layers; outputs within B4's
     forward limit and the gradients of a loss on the second half, run
     back through the carried state, within its backward limit (the largest
     gap and the calls that kept their bits printed); B4's, B8's and B9's
     launches equal to the path's schedule;
  8. GADGET's online loop on the card: ``repro_torch.launch.schedule_and_
     train`` at the example's own sizes (three reduced jobs, 6 slots of 4
     steps, the scripted ``WorkerLeave``, calibration on), with the
     example's checks, job 0's slot-3 re-ring, every kernel's launches
     against the slots the jobs ran (B8 for the rwkv job, B4 for the dense
     jobs, the int8 ring for job 1), and one ``solve_slot`` with the PDHG
     engine on the card against HiGHS;
  9. serving (``repro_torch.launch.serve``; decode is plain PyTorch on the
     card, as it is XLA in the reference, so no ported kernel runs in it):
     qwen3-0.6b at full width and depth answers 8 staggered requests
     through ``ServingEngine(max_batch=8, max_seq=1024, prefill_chunk=8)``
     with a clean audit, each of its three steps captured once as a CUDA
     graph and no kernel launched; two requests' logits held against the
     training forward (F1 on the card) and against the token-by-token
     oracle within ``SERVE_GAP_FACTOR`` times the reference's own
     forward-vs-decode gap (``SERVE_REF_GAP``, measured by
     ``tests/test_torch_serving.py``); prefill and decode tokens/s, the
     decode step's device ms at full occupancy beside its byte bound, TTFT
     and peak memory. zamba2-1.2b (full) and rwkv6-7b (4 layers) serve 4
     requests through 2 lanes each: a request on a reused lane gives logits
     bit-identical to a fresh engine's in the same lane, and decode against
     the forward (S1 and F1, W1) is held for rwkv6-7b and printed for
     zamba2-1.2b. Then GADGET with a serve job whose engine is on the card,
     under the sanitizer: the burst takes workers from the training ring
     and gives them back, and the event log equals the CPU run's. Mamba2LM
     (zamba2-1.2b's config as family "ssm") at full width and depth serves
     as zamba2-1.2b does (its decode against the forward printed). Each
     decode step of one request of zamba2-1.2b and of Mamba2LM, reduced and
     at full width, runs again on the CPU from the card engine's cache and
     weights, in f32 and in f64: the card's logits and cache held to the
     CPU f32 step at reduced size, and no further from the f64 step than the
     CPU's f32 step at full width, zamba2's layer by layer from the card's
     inputs to each layer (``STEP_*``; at full width the first 7 decode
     steps, at reduced size all 31); reduced Mamba2LM's decode held
     against its forward (S1 on the card);
 10. the MoE path: phi3.5-moe-42b at full width, 1 of 32 layers, in
     ``compressed-fused`` (``moe_path``);
 11. the encoder-decoder and VLM ranks: whisper-large-v3, internvl2-26b and
     phi3-medium-14b, every B4 call against the exact function
     (``encdec_path``);
 12. fault tolerance, calibration and the CLIs: ``FaultTolerantRunner`` on
     qwen3-0.6b at full width cut to 2 layers, ``compressed-fused``, the
     reference test's plans with 2 of 4 workers left in slot 1 and the
     in-memory state set to NaN at the failure: one recovery, step 8, the
     restored state bit-identical to the checkpoint's, every loss
     bit-identical to a plain trainer over the slots it ran, the kernels'
     launches equal to their schedule, the checkpoint's bytes and write and
     read seconds, heartbeats from each rank's step time; then
     ``python -m repro_torch.launch.serve`` (qwen3-0.6b, zamba2-1.2b) and
     ``python -m repro_torch.launch.serve_batched`` side by side, and
     ``python -m repro_torch.cluster.calibrate`` alone (the fitted bandwidth
     is a copy within the card's memory: every rank is ``cuda:0``);
 13. the analyses on the card: the collective verifier
     (``repro_torch.analysis.collectives``) records every registered ring
     variant and step mode over a ``RecordingRing`` on the card, the fused
     variants through the ring kernels, each fused variant's launches held to
     its ring schedule, with no finding and no silent fixture of the mutation
     suite; every kernel instantiation's registers, shared and local memory
     and blocks per SM read on the card (``repro_torch.analysis.kernels``),
     the predicted blocks per SM equal to the occupancy API's; then both
     CLIs, ``python -m repro_torch.analysis.collectives`` and ``python -m
     repro_torch.analysis.kernels --execute``, side by side;
 14. the GSPMD path (``gspmd_path``): ``make_train_step`` on qwen3-0.6b at
     full width and depth (28 layers, seq 1024, global batch 8, f32 AdamW),
     one step on plain tensors and the same step on DTensors over a
     one-rank (1, 1) ``DeviceMesh`` (``nccl``) under ``activate(rules)``:
     its loss, gradient norm, parameters and optimizer state bit-identical
     to the plain step's, B4's launches at the schedule (2*L forwards and L
     of each backward kernel, with remat); then that step in 4 microbatches
     (B4 4 times as often; loss, gradient norm and AdamW's first moment
     within 1e-4 of the one-microbatch step's); meanwhile, as processes of
     their own, the dry run of that cell on a fake (1, 1) mesh (its
     argument bytes held equal to the real tensors', its temporary bytes
     printed beside the step's measured peak), and ``python -m
     repro_torch.launch.dryrun`` and ``profile_cell --metric flops`` for
     qwen3-0.6b train_4k on the 16x16 fake mesh; then one step of each
     other family at full width, plain and on the (1, 1) mesh under the
     config's layout (phi3.5-moe-42b at 1 layer, whisper-large-v3,
     rwkv6-7b at 4 layers, zamba2-1.2b), every leaf bit-identical and B4's,
     B8's and B9's launches equal between the two and to the step's
     schedule, with their 16x16 train_4k dry runs on the host beside them
     (``summary gspmd`` line);
 15. the ``launch_configs`` JSON line, the ``kernels`` JSON line, the card
     line, and last the result line.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.analysis import collectives as AC  # noqa: E402
from repro_torch.analysis import kernels as AK  # noqa: E402
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
from repro_torch.kernels import adamw as AD  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import quant_ring as qr  # noqa: E402
from repro_torch.kernels import rwkv6_wkv as W  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.module import (  # noqa: E402
    _flatten,
    _unflatten,
    init_from_specs,
    n_params,
    tree_map,
)
from repro_torch.training.elastic import ElasticTrainer, SlotPlan  # noqa: E402
from repro_torch.training.optimizer import make_optimizer  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    LEAF_COLLECTIVES,
    rank_grads,
    reduce_grads,
    shard_batch,
)

DEVICE = "cuda"
FP8 = qr.FP8_DTYPE
# H100 SXM peaks (NVIDIA data sheet): device memory, f32 outside tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# dense TF32 on the tensor cores (the same data sheet)
TF32_OPS_PER_S = 495e12
# device_ms: a buffer of FLUSH_BYTES (over 5x the 50 MB L2) is read before
# each timed call, and torch.cuda._sleep's kernel (named MARK) marks the
# call's start, OPEN_CYCLES long (about 0.5 us at the H100's clock), and its
# end, CLOSE_CYCLES long (about 50 us): a mark longer than SPLIT_US closes;
# up to SESSIONS profiler sessions. host_us: HOST_CALLS calls behind a sleep
# sized from WARM_CALLS calls before them, its cycles at MAX_CLOCK_HZ (the
# H100 SXM's highest clock, 1.98 GHz, rounded up: the sleep lasts at least
# as long at any clock)
FLUSH_BYTES = 256 * 2**20
MARK, OPEN_CYCLES, CLOSE_CYCLES, SPLIT_US = "spin_kernel", 1_000, 100_000, 20.0
SESSIONS = 3
WARM_CALLS, HOST_CALLS, MAX_CLOCK_HZ = 10, 100, 2e9
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
# psums a ring step takes beside its reduction: the loss mean, as the
# reference's pmean (tools/kernel_times.py sets 0 for a checkout whose step
# takes the mean on the host)
LOSS_MEAN_PSUMS = 1

# B4, flash attention: its kernels, and the f32 operations each does per
# visible (query, key) pair and unit of head_dim (F2 has no pairs)
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:105"
FA_FWD = "flash_attention_fwd"
FA_BWD = ("flash_attention_bwd_preprocess", "flash_attention_bwd_dkdv",
          "flash_attention_bwd_dq")
FA_PAIR_OPS = {FA_FWD: 4, FA_BWD[0]: 0, FA_BWD[1]: 8, FA_BWD[2]: 6}
# limits against the plain versions, by the output's dtype. Forward (O, and
# lse, which is f32): in f32 max |x - x_plain| <= 2e-5 max |x_plain|, the
# reference's own TOL (tests/test_kernels.py:35); in bf16, where both sides
# round one f32 value once, each element within one bf16 ulp of its plain
# value plus that f32 limit. Backward: each output's relative norm
# |x - x_plain| / |x_plain|.
FA_FWD_TOL = 2e-5
FA_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
# (label, (B, Sq, Skv, Hq, Hkv, D), causal, window, dtype): each rank's
# attention on the main paths at w=4 and w=2 and in the reduced model at
# w=4, then granite-3-2b and h2o-danube-1.8b at one sequence a rank (the
# window bites past 4096), ragged non-causal lengths and bf16; then this
# slice's: phi3.5-moe-42b at w=4, whisper-large-v3's encoder (1500 frames),
# decoder (448 tokens, Whisper's text context) and cross-attention (queries
# and keys of different lengths), internvl2-26b (256 patches + 1024 tokens)
# and phi3-medium-14b at batch 2
FA_SHAPES = [
    ("main w=4", (2, 1024, 1024, 16, 8, 128), True, None, torch.float32),
    ("main w=2", (4, 1024, 1024, 16, 8, 128), True, None, torch.float32),
    ("reduced qwen3 w=4", (2, 16, 16, 4, 2, 32), True, None, torch.float32),
    ("granite-3-2b", (2, 1024, 1024, 32, 8, 64), True, None, torch.float32),
    ("h2o-danube-1.8b", (1, 5120, 5120, 32, 8, 80), True, 4096, torch.float32),
    ("ragged 33", (2, 33, 33, 16, 8, 128), False, None, torch.float32),
    ("ragged 1000", (2, 1000, 1000, 16, 8, 128), False, None, torch.float32),
    ("bf16 main w=4", (2, 1024, 1024, 16, 8, 128), True, None, torch.bfloat16),
    ("bf16 ragged window", (1, 1000, 1000, 32, 8, 80), True, 300, torch.bfloat16),
    ("zamba2 w=4", (2, 1024, 1024, 32, 32, 64), True, None, torch.float32),
    ("zamba2 w=2", (4, 1024, 1024, 32, 32, 64), True, None, torch.float32),
    ("phi3.5-moe w=4", (2, 1024, 1024, 32, 8, 128), True, None, torch.float32),
    ("whisper encoder", (2, 1500, 1500, 20, 20, 64), False, None, torch.float32),
    ("whisper decoder", (2, 448, 448, 20, 20, 64), True, None, torch.float32),
    ("whisper cross", (2, 448, 1500, 20, 20, 64), False, None, torch.float32),
    ("internvl2-26b", (2, 1280, 1280, 48, 8, 128), True, None, torch.float32),
    ("phi3-medium-14b", (2, 1024, 1024, 40, 10, 128), True, None, torch.float32),
    ("bf16 whisper cross", (2, 448, 1500, 20, 20, 64), False, None, torch.bfloat16),
]
FA_TIMED = "main w=4"

# B8, RWKV6's WKV: its kernels, held to B4's limits (FA_FWD_TOL for y and
# the chunk states, FA_BWD_TOL per gradient)
WKV_SOURCE = "src/repro_torch/kernels/csrc/wkv6.cu"
WKV_REPLACES = "src/repro/kernels/rwkv6_wkv.py:76"
WKV_FWD, WKV_BWD = "wkv6_fwd", "wkv6_bwd"
# (label, (B, S, H, P), dtype, every logw at the clamp): each rank's
# time-mix on the RWKV6 path at w=4 and w=2 and in the loop's reduced model
# at w=4, a ragged length, the factorization's widest range (k exp(-cum) up
# to |k| e^80) and bf16
WKV_SHAPES = [
    ("main w=4", (2, 1024, 64, 64), torch.float32, "model"),
    ("main w=2", (4, 1024, 64, 64), torch.float32, "model"),
    ("loop reduced w=4", (2, 32, 4, 32), torch.float32, "model"),
    ("ragged 1000", (2, 1000, 64, 64), torch.float32, "model"),
    ("logw at the clamp", (2, 256, 8, 64), torch.float32, "clamp"),
    ("weak decay main w=4", (2, 1024, 64, 64), torch.float32, "weak"),
    ("bf16 main w=4", (2, 1024, 64, 64), torch.bfloat16, "model"),
]
WKV_TIMED = "main w=4"
RWKV_ARCH, RWKV_LAYERS = "rwkv6-7b", 4
# the RWKV6 slot through B8 against the same slot through the plain
# recurrence on the card, from the same weights: limit on any step's loss gap
RWKV_LOSS_TOL = 1e-3

# B9, Mamba2's SSD scan: its kernels, held to B4's limits (FA_FWD_TOL for y
# and the chunk states, FA_BWD_TOL per gradient)
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan.py:77"
SSD_FWD, SSD_BWD = "ssd_fwd", "ssd_bwd"
# B9's own chunk: beside the bound, its algorithm's work at this chunk,
# whatever chunk the kernels take
B9_CHUNK = 128
# (label, (B, S, H, P, N), dtype, decay): each rank's SSD on the Zamba2 path
# at w=4 and w=2 and in the reduced model at w=4 (seq 40, one ragged
# chunk), a ragged length, a weak decay and bf16 x, B and C
SSD_SHAPES = [
    ("main w=4", (2, 1024, 64, 64, 64), torch.float32, "init"),
    ("main w=2", (4, 1024, 64, 64, 64), torch.float32, "init"),
    ("reduced w=4", (2, 40, 8, 32, 16), torch.float32, "init"),
    ("ragged 1000", (2, 1000, 64, 64, 64), torch.float32, "init"),
    ("weak decay main w=4", (2, 1024, 64, 64, 64), torch.float32, "weak"),
    ("bf16 main w=4", (2, 1024, 64, 64, 64), torch.bfloat16, "init"),
]
SSD_TIMED = "main w=4"
ZAMBA_ARCH = "zamba2-1.2b"

# Zamba2-7B's kernels (check_zamba2_7b_kernels): B4 at head_dim 224 with the
# shared attention's scale, (label, (B, Sq, Skv, Hq, Hkv, D), causal,
# window, dtype): one rank's call in the benchmark's cell (seq 4096, one
# row), a ragged length, bf16; B9 with two B/C groups, (label, (B, S, H, P,
# N, G), dtype, decay): the cell's call, a weak decay, a ragged length, the
# reduced widths and bf16. Each timed at its first shape.
ZAMBA2_7B_SCALE = (224 / 2) ** -0.5
FA_224_SHAPES = [
    ("zamba2-7b w=4", (1, 4096, 4096, 32, 32, 224), True, None, torch.float32),
    ("zamba2-7b ragged 1000", (2, 1000, 1000, 8, 8, 224), True, None, torch.float32),
    ("zamba2-7b gqa ragged 33", (1, 33, 33, 8, 2, 224), True, None, torch.float32),
    ("zamba2-7b bf16", (1, 1024, 1024, 8, 8, 224), True, None, torch.bfloat16),
]
SSD_GROUP_SHAPES = [
    ("zamba2-7b w=4", (1, 4096, 112, 64, 64, 2), torch.float32, "init"),
    ("zamba2-7b weak decay", (1, 1024, 112, 64, 64, 2), torch.float32, "weak"),
    ("ragged 1000 G=2", (2, 1000, 16, 64, 64, 2), torch.float32, "init"),
    ("reduced G=2", (2, 40, 8, 32, 16, 2), torch.float32, "weak"),
    ("bf16 G=2", (1, 1024, 112, 64, 64, 2), torch.bfloat16, "init"),
]

# B4, B8 and B9 in their state-carrying forms, at the main shapes: B4 at
# query offset CARRY_CUT, q the last CARRY_CUT of SEQ rows against all SEQ
# keys (causal, and causal in a window), each of its kernels held against
# its plain version within B4's limits; B8 and B9 at WKV_TIMED's and
# SSD_TIMED's shapes from a random initial state (and, backward, with a
# random final-state gradient), held likewise: y, the chunk states, the
# final state, and every gradient with the initial state's. Each form is
# timed beside the zero-state row (``forms`` in the kernel's row).
CARRY_CUT = 512
FA_OFFSET_SHAPES = [
    ("main w=4 second half", (2, 512, 1024, 16, 8, 128), True, None, torch.float32),
    ("main w=4 second half, window 300", (2, 512, 1024, 16, 8, 128), True, 300,
     torch.float32),
]
# The state-carrying path (``state_carry_path``): a sequence of SEQ tokens
# in two halves, cut at CARRY_CUT (a chunk boundary of B8's 32 and of B9's
# 64), the second half from the states the first returns, against the
# whole sequence, at full width and CARRY_BATCH rows (a rank's at w=4):
# zamba2-1.2b's 38 Mamba2 layers (``mamba2_block``: SSM and conv states),
# each from its own input in the whole sequence's forward (the model
# amplifies any reordering at random init, so it is held layer by layer),
# and its shared attention's applications (the second half's queries at
# ``q_offset`` CARRY_CUT over all the keys); rwkv6-7b's WKV in
# RWKV_LAYERS layers (its time-mix's token shift starts from zeros outside
# decode, as the reference's, so the WKV itself is split). Forward outputs
# within B4's forward limit, and the gradients of a loss on the second
# half, run back through the carried state, within its backward limit.
CARRY_BATCH = 2
# Zamba2 at random init amplifies any reordering of its sums: its first
# loss moves by about 1e-2 between exact forms of the SSD in f32, and its
# slot through the plain SSD parts from the kernels' by more with every
# step (tools/zamba2_ssd_forms.py measures both). So the kernels are held
# where that does not reach them: every S1 and S2 call of one rank's
# forward and backward on the path, at the path's own inputs, against the
# plain versions (B4's limits), and S1's y against the SSD in f64 no
# further than the model's plain ssd_chunked (f32, chunk 256) is.
# Reduced zamba2-1.2b on the card against the CPU: its first loss (the
# same weights) within SMALL_FIRST_TOL, and one rank's gradients at those
# weights leaf by leaf to a relative norm of SMALL_GRAD_TOL, the limit that
# tests/test_torch_ssm.py holds this model's gradients to against the
# reference; the second loss, after an AdamW step of this chaotic model, is
# recorded
SMALL_FIRST_TOL, SMALL_GRAD_TOL = 1e-4, 2e-2

# Serving (phase 9). The reference's own gap between its training forward
# and its decode, max |decode - forward| over max |forward| at every
# position, at reduced size with f32 weights and its bf16 KV cache (2
# sequences of 64 tokens; tests/test_torch_serving.py measures it, in
# [recorded / 2, recorded]). The card holds the port's decode to the
# forward that runs the ported kernels, and the engine to the token-by-token
# oracle, within SERVE_GAP_FACTOR times it; zamba2-1.2b's is printed beside
# its gap on the card and not held (chaotic at random init). MAMBA2 is
# Mamba2LM: zamba2-1.2b's config with family="ssm" (no KV cache; measured
# 3.515e-6)
MAMBA2 = "zamba2-1.2b/ssm"
SERVE_REF_GAP = {"qwen3-0.6b": 2.7e-3, "rwkv6-7b": 4.1e-6, "zamba2-1.2b": 0.26,
                 MAMBA2: 3.6e-6}
# phi3.5-moe-42b's and whisper-large-v3's gaps are taken with an f32 KV
# cache on both sides (the MoE's forward dropping no token, whisper's cache
# holding its encoder's cross K/V): at random init these models amplify
# the bf16 cache's rounding, the reference's own decode moving by 0.13 and
# 0.098 of the largest logit against an f32 cache (the MoE's router is
# near-uniform, so roundings flip its top-2 choices). For whisper it is the
# larger of the reference's and the port's own gaps (tests/test_torch_moe.py,
# tests/test_torch_encdec.py). Their reduced configs on the card, through
# an f32 cache, are held within SERVE_GAP_FACTOR times it: decode against
# the forward, and every step of the engine against the per-lane oracle
SERVE_REF_GAP_F32_CACHE = {"phi3.5-moe-42b": 2.5e-5, "whisper-large-v3": 4e-5}
SERVE_GAP_FACTOR = 10.0
# qwen3-0.6b at full width and depth: SERVE_REQUESTS requests, prompts
# SERVE_PROMPT tokens (inclusive, from seed 0), SERVE_NEW tokens each,
# request i arriving at engine clock SERVE_STAGGER * i, through
# ServingEngine(max_batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ,
# prefill_chunk=SERVE_CHUNK); the SERVE_HELD shortest prompts held against
# the forward and the oracle; the decode step timed with every lane
# admitted a fresh SERVE_FULL_PROMPT-token prompt
SERVE_ARCH, SERVE_BATCH, SERVE_MAX_SEQ, SERVE_CHUNK = "qwen3-0.6b", 8, 1024, 8
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW, SERVE_STAGGER = 8, (32, 512), 64, 4
SERVE_HELD, SERVE_FULL_PROMPT = 2, 64
# zamba2-1.2b and Mamba2LM at full width and depth, rwkv6-7b at full width
# cut to 4 layers: RECURRENT_REQUESTS requests through RECURRENT_BATCH lanes
RECURRENT_SERVE = {"zamba2-1.2b": None, "rwkv6-7b": 4, MAMBA2: None}
HELD_RECURRENT = ("rwkv6-7b",)
# Each decode step of request 0 (the first of those requests, alone on a
# fresh engine with the served engine's bf16 K/V cache) of zamba2-1.2b and
# Mamba2LM, full and reduced, also runs on the CPU from the card engine's
# cache and weights, in f32 and in f64. At reduced size the card's logits
# are held within STEP_LOGITS_REL of the CPU f32 step's largest, every
# cache leaf of the lane within STEP_CACHE_REL of its largest value plus,
# for bf16 leaves, one bf16 rounding (2^-7 of each value): the limits
# tests/test_torch_serving.py holds one step of reduced zamba2 (bf16 K/V)
# to against the reference. At full width the card's step (logits and every
# cache leaf) is no further from the f64 step than the CPU's f32 step is,
# plus STEP_F64_REL of the f64 step's largest value. For zamba2 there the
# CPU steps are teacher-forced (``forced_from_card``): each Mamba2 layer
# starts from the card's input to it (from an eager rerun of the card's
# step, held bit-identical to the captured one), and the shared attention
# stores the card's bf16 K and V; each layer's input ``h`` and the new K
# and V (within one bf16 rounding more) are held too. Without forcing,
# full-width zamba2 fails that limit at 4.03 (PERF.md §6): its first
# Mamba2 layers match the CPU's error, the first shared attention
# application leaves the card's f32 error 2-4x the CPU's, and each of the
# six applications multiplies both by 4-5 (at step 24 the card's logits
# 0.048 from f64, the CPU's 0.0078, largest 4.06).
STEP_CHECKED = ("zamba2-1.2b", MAMBA2)
STEP_LOGITS_REL, STEP_CACHE_REL, STEP_F64_REL = 1e-3, 1e-4, 1e-3
# tokens of request 0 at full width (STEP_FULL_NEW - 1 decode steps held on
# the CPU; RECURRENT_NEW at reduced size): each full-width step reruns 38
# layers on the CPU in f32 and f64 (about 1.2 s a step on the card
# machine's host), the depth this check was cut to in time for the
# state-carrying path
STEP_FULL_NEW = 8
BF16_ROUNDING = 2.0**-7
RECURRENT_BATCH, RECURRENT_REQUESTS = 2, 4
RECURRENT_PROMPT, RECURRENT_NEW = (64, 256), 32
# phi3.5-moe-42b at full width cut to 4 layers (21.8 GB of f32 weights) and
# whisper-large-v3 at full width and depth: FAMILY_REQUESTS requests each,
# prompts FAMILY_PROMPT tokens (inclusive, from seed 3), FAMILY_NEW tokens
# each, staggered as qwen3-0.6b's, through the same engine; the decode step
# timed with every lane admitted a fresh FAMILY_TIMED_PROMPT-token prompt
FAMILY_SERVE = {"phi3.5-moe-42b": 4, "whisper-large-v3": None}
FAMILY_REQUESTS, FAMILY_PROMPT, FAMILY_NEW, FAMILY_TIMED_PROMPT = 8, (8, 64), 16, 8
# GADGET with a serve job: its burst from slot CO_BURST of CO_HORIZON
CO_BURST, CO_HORIZON = 6, 16

# Phase 10: phi3.5-moe-42b at full width cut to MOE_LAYERS of its 32 layers
# (1,563,504,640 parameters; at the 43.4 bytes a parameter that the qwen3
# path's rank peaks at, two layers would need about 116 GiB), in MOE_MODE
# over PLAN; MOE_LEAVES parameter leaves
MOE_ARCH, MOE_LAYERS, MOE_MODE, MOE_LEAVES = "phi3.5-moe-42b", 1, "compressed-fused", 13
# Phase 11: one rank's loss and gradients at batch ENC_BATCH, whisper's
# decoder at ENC_TOKENS tokens (Whisper's text context) over its 1500
# frames, internvl2-26b and phi3-medium-14b at SEQ tokens (internvl2's 256
# patches ahead of them) cut to VLM_LAYERS layers, every B4 call held on
# its own inputs against the exact function. Reduced whisper on the card
# against the CPU from the same weights: the loss's relative gap within
# ENC_LOSS_TOL (the CPU tests' limit of the loss against the reference,
# tests/test_torch_encdec.py), each gradient leaf's relative norm within
# SMALL_GRAD_TOL, as reduced zamba2-1.2b's: on the CPU, one ulp of every
# weight moves this model's gradients by 4.6e-3 in that measure, and the
# card reorders every product; the same rank with B4 in bf16 must land
# outside the limit
ENC_ARCH, ENC_TOKENS, ENC_BATCH = "whisper-large-v3", 448, 2
VLM_ARCHS, VLM_LAYERS = ("internvl2-26b", "phi3-medium-14b"), 2
ENC_LOSS_TOL = 1e-5

# Phase 12: fault tolerance at full width, qwen3-0.6b cut to FT_LAYERS
# layers, FT_MODE with AdamW at LR, seq SEQ, global batch GLOBAL_BATCH,
# over tests/test_training.py::test_fault_tolerant_recovery's plans, FT_PLANS,
# with FT_SURVIVORS left in slot FT_FAIL_SLOT: the runner reruns that slot at
# the survivors' ring (FT_RAN). FT_TIMEOUT and FT_STRAGGLER are the
# HeartbeatMonitor's defaults, fed each rank's measured step time
FT_LAYERS, FT_MODE = 2, "compressed-fused"
FT_PLANS = [(4, 3), (4, 3), (4, 2)]
FT_FAIL_SLOT, FT_SURVIVORS = 1, 2
FT_RAN = [(4, 3), (2, 3), (4, 2)]
FT_TIMEOUT, FT_STRAGGLER = 10.0, 2.5
# the reference's calibration grid: worlds 2/4/8, sizes 2^14/2^16/2^18
CALIBRATION_SAMPLES = 9
# the serving CLI's arches (its default batch of SERVE_CLI_BATCH requests)
SERVE_CLI_ARCHS, SERVE_CLI_BATCH = ("qwen3-0.6b", "zamba2-1.2b"), 4
# each CLI run's time limit, seconds
CLI_TIMEOUT = 600
# Phase 13: the fused ring variants the collective verifier records through
# the ring kernels, and the mode whose ring schedule each call follows
# (error feedback's compression adds one dequantize a rank)
# Phase 14: the GSPMD step of make_train_step on a one-rank (1, 1) DeviceMesh,
# qwen3-0.6b at full width and depth (ARCH, SEQ, GLOBAL_BATCH, LR, f32
# AdamW). Four microbatches against one: the loss and the gradient norm
# within the reference's rel=1e-4 on the loss (tests/test_training.py:91),
# and every leaf of AdamW's first moment, (1 - b1) times the gradient after
# one step, within 1e-4 of its largest value (f32 sums over the batch taken
# in four parts; the parameters themselves can move by up to 2 LR where a
# gradient near 0 changes sign, so they are printed, not held)
GSPMD_MICROBATCHES, GSPMD_TOL = 4, 1e-4
# the dry run's cells run on the card's host: 16x16, as the reference's;
# the first is also profiled
GSPMD_DRYRUNS = (("qwen3-0.6b", "train_4k"), (MOE_ARCH, "train_4k"),
                 (ENC_ARCH, "train_4k"), (RWKV_ARCH, "train_4k"),
                 (ZAMBA_ARCH, "train_4k"))
# Phase 14's other families: one step of make_train_step of each at full
# width, f32 AdamW at LR, on plain tensors and on the (1, 1) mesh under the
# config's own layout (FSDP; whisper's sequence parallelism), held bit for
# bit, B4's, B8's and B9's launches equal between the two and to the step's
# schedule: arch -> (layers, None for all; seq; batch). phi3.5-moe-42b at
# phase 10's depth (its capacity factor 1.25, so tokens drop), rwkv6-7b at
# phase 6's, whisper-large-v3 at phase 11's decoder length and batch (two
# of its 1500-frame inputs), zamba2-1.2b whole
GSPMD_FAMILIES = {MOE_ARCH: (MOE_LAYERS, SEQ, GLOBAL_BATCH),
                  ENC_ARCH: (None, ENC_TOKENS, ENC_BATCH),
                  RWKV_ARCH: (RWKV_LAYERS, SEQ, GLOBAL_BATCH),
                  ZAMBA_ARCH: (None, SEQ, GLOBAL_BATCH)}
VERIFIER_FUSED = {"int8-fused": "compressed-fused", "bf16-fused": "bf16-fused",
                  "fp8-fused": "fp8-fused", "ef-int8-fused": "compressed-fused"}
# AdamW's leaf update (phase 3): held at every leaf shape of the benchmark's
# two configurations (f32), and with bf16 parameters or gradients at ragged
# (elements, offset) pairs: on 16 bytes (whole vectors) or one or three
# elements past them (every element one by one); timed at each
# configuration's largest leaf
ADAMW_SOURCE = "src/repro_torch/kernels/csrc/adamw.cu"
ADAMW_CONFIGS = ((RWKV_ARCH, RWKV_LAYERS), (MOE_ARCH, MOE_LAYERS))
ADAMW_RAGGED = ((1, 0), (3, 0), (4097, 0), (1_000_003, 0), (4097, 1), (1_000_003, 3))
ADAMW_HYPER = dict(lr=LR, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


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


def device_ms(fn, samples: int = 25) -> float:
    """Median, over ``samples`` calls of ``fn``, of the summed durations of
    the CUDA kernels one call launches (``torch.profiler``'s CUDA activity):
    the call's device time, whatever its host path takes. Before each call
    a buffer over the L2's size is read, so that the call finds its inputs
    in device memory and not in the L2 (read, not written: a written
    buffer's dirty lines would be written back during the timed call); a
    short sleep kernel before the call and a long one after it delimit its
    kernels, and the read's and the marks' own durations are not counted.
    A call counts only between an opening and a closing mark and with as
    many kernels as most calls have. The profiler now and then drops
    records (once 2 of a session's 60 calls, once 20 of 25): a session in
    which fewer than 80% of the calls count is run again, up to
    ``SESSIONS`` sessions."""
    flush = torch.ones(FLUSH_BYTES // 4, device=DEVICE)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(SESSIONS):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(samples):
                flush.sum()
                torch.cuda._sleep(OPEN_CYCLES)
                fn()
                torch.cuda._sleep(CLOSE_CYCLES)
            torch.cuda.synchronize()
        kernels = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
        calls, window = [], None
        for start, end, name in kernels:
            if MARK not in name:
                if window is not None:
                    window.append(end - start)
            elif end - start < SPLIT_US:
                window = []
            else:
                if window:
                    calls.append(window)
                window = None
        n_kernels = statistics.mode(len(c) for c in calls) if calls else 0
        sums = [sum(c) for c in calls if len(c) == n_kernels]
        if len(sums) >= 0.8 * samples:
            return statistics.median(sums) / 1e3
        log(f"device_ms: the profiler shows {len(sums)} of {samples} calls with their "
            f"{n_kernels} kernels (session {attempt + 1} of {SESSIONS})")
    raise AssertionError(f"device_ms: {SESSIONS} profiler sessions dropped records")


def host_us(fn) -> float:
    """Host microseconds per call of ``fn``: the host clock over
    ``HOST_CALLS`` calls issued behind a sleep kernel that keeps the device
    busy until after the last of them, so that no call waits on the device.
    The sleep is sized to three times what the warm-up calls took the host
    for as many calls, at the card's highest clock."""
    t0 = time.perf_counter()
    for _ in range(WARM_CALLS):
        fn()
    warm = (time.perf_counter() - t0) / WARM_CALLS
    torch.cuda.synchronize()
    torch.cuda._sleep(int(3 * HOST_CALLS * warm * MAX_CLOCK_HZ))
    slept = torch.cuda.Event()
    slept.record()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    t = time.perf_counter() - t0
    busy = not slept.query()
    torch.cuda.synchronize()
    if not busy:
        raise AssertionError(f"the device went idle during host_us's {HOST_CALLS} calls "
                             f"({t:.4g} s; the warm-up's took {warm:.4g} s each)")
    return t / HOST_CALLS * 1e6


def timings(kernel, library) -> dict:
    """The device-alone and host-alone fields of a kernel's row: its
    ``device_ms`` and ``host_us``, and its library call's
    ``library_device_ms`` (None without one). With a library call the two
    device times are taken in turns, kernel, library, library, kernel, and
    each is the mean of its two readings."""
    if library is None:
        return dict(device_ms=device_ms(kernel), host_us=host_us(kernel),
                    library_device_ms=None)
    k0, l0, l1, k1 = (device_ms(fn) for fn in (kernel, library, library, kernel))
    return dict(device_ms=(k0 + k1) / 2, host_us=host_us(kernel),
                library_device_ms=(l0 + l1) / 2)


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s raw bits as an integer tensor of its element size."""
    return t.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                   1: torch.uint8}[t.element_size()])


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


def main_path_shapes(model, overlap: bool = True) -> list:
    """Every ``(w, n_blocks, block)`` the fused rings give the kernels on
    the main paths: each leaf's chunk layout, and (with ``overlap``) each
    bucket's of the overlap mode's plan, at w=4 and w=2."""
    sizes = leaf_sizes(model.param_specs())
    buckets = plan_bucket_sizes(
        sizes, STEP_MODES["compressed-fused-overlap"].n_buckets,
        reverse=True) if overlap else []
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


def check_kernels(model, extra_shapes=()) -> dict:
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    c_pad, nb_embed, _ = _fused_chunk_layout(
        model.cfg.padded_vocab * model.cfg.d_model, 4, DEFAULT_BLOCK)
    timed = (4, nb_embed, c_pad // nb_embed)
    if timed[1:] != EMBED_CHUNK_W4:
        raise AssertionError(f"embed chunk at w=4 is {timed[1:]}")
    shapes = sorted(set(main_path_shapes(model)) | set(extra_shapes)) + [
        (2, 1, 33), (2, 7, 33), (4, 3, 256)]
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
                              library_ms=library_ms, **timings(kernel, library))
            log(f"{name} ({nb}, {block}): {ms:.5g} ms, plain {plain_ms:.5g} ms, "
                f"library {library_ms}, bound {bound_ms:.5g} ms ({bound_by}); "
                f"device alone {rows[name]['device_ms']:.5g} ms, library "
                f"{rows[name]['library_device_ms']}, host {rows[name]['host_us']:.4g} us")

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
    check_cast_off_16_bytes(gen)
    free_cuda()
    log(f"all {len(KERNELS)} kernels bit-exact against their plain versions "
        f"at {len(shapes)} shapes")
    return rows


def check_cast_off_16_bytes(gen: torch.Generator) -> None:
    """B5 through its wrapper on views one, two and three elements past a
    16-byte boundary (7 x 33 elements), bit for bit against
    ``x.to(bfloat16)``: x is not on 16 bytes, so the kernel casts every
    element one by one."""
    base = kernel_inputs(1, 7 * 33 + 3, gen, 3.0).reshape(-1)
    for off in (1, 2, 3):
        x = base[off:off + 7 * 33].view(7, 33)
        if not same_bits(qr.cast_pack_bf16(x), x.to(torch.bfloat16)):
            raise AssertionError(f"cast_pack_bf16 differs on a view {off} elements "
                                 "past 16 bytes")
    log("cast_pack_bf16 bit-exact on views off 16 bytes")


def visible_pairs(sq: int, skv: int, causal: bool, window, q_offset: int = 0) -> int:
    """(query, key) pairs B4's mask lets through, query row i at position i
    + ``q_offset``."""
    n = 0
    for qpos in range(q_offset, q_offset + sq):
        hi = min(qpos, skv - 1) if causal else skv - 1
        lo = max(0, qpos - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def fa_bound(name: str, dims, causal: bool, window, dtype, tensor_cores: bool = False,
             q_offset: int = 0):
    """Least time for the kernel's work: each input read once and each
    output written once over the memory rate, against its f32 operations
    on the visible pairs over the f32 rate; with ``tensor_cores``, against
    three times those operations (the split TF32 form's three products)
    over the TF32 tensor-core rate."""
    b, sq, skv, hq, hkv, d = dims
    elt = torch.empty((), dtype=dtype).element_size()
    q_bytes, kv_bytes = b * sq * hq * d * elt, b * skv * hkv * d * elt
    row_bytes = 4 * b * hq * sq
    ops = FA_PAIR_OPS[name] * d * visible_pairs(sq, skv, causal, window, q_offset) * b * hq
    n_bytes = {
        FA_FWD: 2 * q_bytes + 2 * kv_bytes + row_bytes,          # q k v -> O lse
        FA_BWD[0]: 2 * q_bytes + row_bytes,                      # O dO -> delta
        FA_BWD[1]: 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes,   # q k v dO lse delta -> dK dV
        FA_BWD[2]: 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,   # q k v dO lse delta -> dQ
    }[name]
    if name == FA_BWD[0]:
        ops = 2 * b * sq * hq * d
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = 3 * ops / TF32_OPS_PER_S if tensor_cores else ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rel_max(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a.float() - ref.float()).abs().max() / ref.float().abs().max())


def rel_norm(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a.float() - ref.float()).norm() / ref.float().norm())


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element's magnitude (0 at 0)."""
    x = x.float().abs()
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)
    return torch.where(x > 0, ulp, 0.0)


def fwd_over(a: torch.Tensor, ref: torch.Tensor) -> float:
    """A forward output's error over its limit (FA_FWD_TOL; passes at <= 1)."""
    gap, top = (a.float() - ref.float()).abs(), ref.float().abs().max()
    if ref.dtype == torch.bfloat16:
        return float((gap / (bf16_ulp(ref) + FA_FWD_TOL * top)).max())
    return float(gap.max() / (FA_FWD_TOL * top))


def bwd_over(a: torch.Tensor, ref: torch.Tensor) -> float:
    """A backward output's error over its limit (FA_BWD_TOL; passes at <= 1)."""
    return rel_norm(a, ref) / FA_BWD_TOL[ref.dtype]


def within(overs) -> bool:
    """Every error finite and within its limit (a NaN fails)."""
    return all(math.isfinite(x) and x <= 1 for x in overs)


def sdpa(q, k, v, causal: bool, scale=None):
    """The library call B4 is timed beside: (B, S, H, D) in and out, the
    scores at ``scale`` (SDPA's 1/sqrt(D) if None)."""
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=True, scale=scale)
    return out.transpose(1, 2)


def sdpa_kernel_names(q, k, v, do, causal: bool, scale=None) -> dict:
    """The CUDA kernels one SDPA forward and one backward launch, read once
    with ``torch.profiler`` (each name cut to 96 characters)."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    names = {}
    out = sdpa(*leaves, causal, scale)
    for part, fn in (("forward", lambda: sdpa(*leaves, causal, scale)),
                     ("backward", lambda: torch.autograd.grad(out, leaves, do,
                                                              retain_graph=True))):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        names[part] = sorted({e.name[:96] for e in prof.events()
                              if e.device_type == torch.autograd.DeviceType.CUDA})
    return names


def time_flash_attention(rows, q, k, v, do, o, lse, delta, dims, causal, window):
    """Kernel, plain version and library call of each B4 kernel, and the
    forward and backward through autograd beside SDPA's."""
    opts = dict(causal=causal, window=window)
    calls = {
        FA_FWD: (lambda: fa.flash_attention_fwd(q, k, v, **opts),
                 lambda: fa.flash_attention_plain(q, k, v, **opts),
                 lambda: sdpa(q, k, v, causal)),
        FA_BWD[0]: (lambda: fa.bwd_preprocess(o, do),
                    lambda: fa.bwd_preprocess_plain(o, do),
                    lambda: torch.linalg.vecdot(o, do)),
        FA_BWD[1]: (lambda: fa.bwd_dkdv(q, k, v, do, lse, delta, **opts),
                    lambda: fa.bwd_dkdv_plain(q, k, v, do, lse, delta, **opts),
                    None),
        FA_BWD[2]: (lambda: fa.bwd_dq(q, k, v, do, lse, delta, **opts),
                    lambda: fa.bwd_dq_plain(q, k, v, do, lse, delta, **opts),
                    None),
    }
    # SDPA's backward alone, from one saved output: the library time of the
    # whole B4 backward, given to F3 and F4 (no PyTorch call computes dK, dV
    # or dQ alone)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    saved = sdpa(*leaves, causal)

    def sdpa_bwd():
        return torch.autograd.grad(saved, leaves, do, retain_graph=True)

    lib_bwd_ms = cuda_ms(sdpa_bwd)
    for name, (kernel, plain, library) in calls.items():
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain, samples=5, calls=3)
        library_ms = cuda_ms(library) if library is not None else None
        if name in FA_BWD[1:]:
            library, library_ms = sdpa_bwd, lib_bwd_ms
        bound_ms, bound_by = fa_bound(name, dims, causal, window, q.dtype)
        extra = {}
        if name != FA_BWD[0]:
            tc_ms, tc_by = fa_bound(name, dims, causal, window, q.dtype,
                                    tensor_cores=True)
            extra = dict(bound_tc_ms=tc_ms, bound_tc_by=tc_by, blocks_per_sm={
                str(hd): fa.blocks_per_sm(name, hd, q.dtype) for hd in (128, 64)})
        extra.update(timings(kernel, library))
        rows[name].update(shape=list(dims), ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms, **extra)
        log(f"{name} {dims}: {ms:.5g} ms, plain {plain_ms:.5g} ms, library "
            f"{library_ms}, bound {bound_ms:.5g} ms ({bound_by}) {extra}")
    bwd_ms = sum(rows[name]["ms"] for name in FA_BWD)
    rows[FA_FWD].update(bwd_kernels_ms=bwd_ms, library_bwd_ms=lib_bwd_ms,
                        library_kernels=sdpa_kernel_names(q, k, v, do, causal))
    log(f"flash attention backward {dims}: F2 + F3 + F4 {bwd_ms:.5g} ms, sdpa's "
        f"backward {lib_bwd_ms:.5g} ms; sdpa's CUDA kernels "
        f"{rows[FA_FWD]['library_kernels']}")

    def kernel_fwd_bwd():
        out = fa.flash_attention(*leaves, **opts)
        return torch.autograd.grad(out, leaves, do)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(*leaves, causal), leaves, do)

    gap = rel_max(sdpa(q, k, v, causal), o)
    fb_ms, lib_fb_ms = cuda_ms(kernel_fwd_bwd), cuda_ms(sdpa_fwd_bwd)
    fb_dev, lib_fb_dev = device_ms(kernel_fwd_bwd), device_ms(sdpa_fwd_bwd)
    rows[FA_FWD].update(fwd_bwd_ms=fb_ms, library_fwd_bwd_ms=lib_fb_ms,
                        fwd_bwd_device_ms=fb_dev, library_fwd_bwd_device_ms=lib_fb_dev)
    log(f"flash attention forward+backward {dims}: kernels {fb_ms:.5g} ms, "
        f"sdpa {lib_fb_ms:.5g} ms; on the device alone {fb_dev:.5g} and "
        f"{lib_fb_dev:.5g} ms (sdpa's O against the plain O: {gap:.3g} of "
        f"its largest value)")


def check_flash_attention(shapes=None, q_offset: int = 0, rows=None,
                          scale=None) -> dict:
    """B4's kernels against their plain versions, each on the same inputs,
    at every shape of ``shapes`` (FA_SHAPES) with query row i at position i +
    ``q_offset`` and the scores at ``scale`` (B4's 1/sqrt(D) if None); every
    kernel run twice gives the same bits; timed at FA_TIMED, or with an
    offset at the first shape (``time_state_form``). ``rows`` (new ones by
    default) take the errors."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1 + q_offset)
    if rows is None:
        rows = {name: {"name": name, "route": "cuda", "source": FA_SOURCE,
                       "replaces": FA_REPLACES, "max_abs_err": 0.0, "max_rel_err": 0.0}
                for name in FA_PAIR_OPS}

    def check(name, label, kernel, plain, measure, over):
        outs, again, refs = kernel(), kernel(), plain()
        outs, again, refs = (x if isinstance(x, tuple) else (x,)
                             for x in (outs, again, refs))
        if not all(same_bits(a, b) for a, b in zip(outs, again)):
            raise AssertionError(f"{name} {label}: two runs differ")
        errs = [measure(a, r) for a, r in zip(outs, refs)]
        abs_errs = [float((a.float() - r.float()).abs().max())
                    for a, r in zip(outs, refs)]
        overs = [over(a, r) for a, r in zip(outs, refs)]
        if not within(overs) or not all(map(math.isfinite, errs + abs_errs)):
            raise AssertionError(f"{name} {label}: errors {errs} (abs {abs_errs}) "
                                 f"are {overs} of their limits")
        row = rows[name]
        row["max_abs_err"] = max(row["max_abs_err"], *abs_errs)
        row["max_rel_err"] = max(row["max_rel_err"], *errs)
        row["max_of_limit"] = max(row.get("max_of_limit", 0.0), *overs)
        return {"errors": errs, "of_limit": overs}

    for i, (label, dims, causal, window, dtype) in enumerate(shapes or FA_SHAPES):
        b, sq, skv, hq, hkv, d = dims
        q, k, v, do = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
                       for shape in ((b, sq, hq, d), (b, skv, hkv, d),
                                     (b, skv, hkv, d), (b, sq, hq, d)))
        # (an offset only where one is asked for: tools/kernel_times.py runs
        # this over a parent's package too)
        opts = dict(causal=causal, window=window, **(
            {"q_offset": q_offset} if q_offset else {}), **(
            {"scale": scale} if scale is not None else {}))
        o, lse = fa.flash_attention_plain(q, k, v, **opts)
        delta = fa.bwd_preprocess_plain(o, do)
        errs = {
            FA_FWD: check(FA_FWD, label, lambda: fa.flash_attention_fwd(q, k, v, **opts),
                          lambda: (o, lse), rel_max, fwd_over),
            FA_BWD[0]: check(FA_BWD[0], label, lambda: fa.bwd_preprocess(o, do),
                             lambda: delta, rel_norm, bwd_over),
            FA_BWD[1]: check(FA_BWD[1], label,
                             lambda: fa.bwd_dkdv(q, k, v, do, lse, delta, **opts),
                             lambda: fa.bwd_dkdv_plain(q, k, v, do, lse, delta, **opts),
                             rel_norm, bwd_over),
            FA_BWD[2]: check(FA_BWD[2], label,
                             lambda: fa.bwd_dq(q, k, v, do, lse, delta, **opts),
                             lambda: fa.bwd_dq_plain(q, k, v, do, lse, delta, **opts),
                             rel_norm, bwd_over),
        }
        # the backward as the autograd function runs it, from the kernel's O
        ko, klse = fa.flash_attention_fwd(q, k, v, **opts)
        pairs = list(zip(fa.flash_attention_bwd(q, k, v, ko, klse, do, **opts),
                         fa.flash_attention_bwd_plain(q, k, v, ko, klse, do, **opts)))
        whole = [rel_norm(a, r) for a, r in pairs]
        if not within(bwd_over(a, r) for a, r in pairs):
            raise AssertionError(f"backward {label}: dq dk dv error {whole}")
        log(f"B4 {label} {dims} causal={causal} window={window} {dtype}"
            f"{f' q_offset={q_offset}' if q_offset else ''}"
            f"{f' scale={scale}' if scale is not None else ''}: errors {errs}, "
            f"whole backward {whole}; bits identical run to run")
        if q_offset and i == 0:
            time_state_form(rows, f"q_offset {q_offset}", {
                FA_FWD: (lambda: fa.flash_attention_fwd(q, k, v, **opts),
                         lambda: fa.flash_attention_plain(q, k, v, **opts)),
                FA_BWD[0]: (lambda: fa.bwd_preprocess(o, do),
                            lambda: fa.bwd_preprocess_plain(o, do)),
                FA_BWD[1]: (lambda: fa.bwd_dkdv(q, k, v, do, lse, delta, **opts),
                            lambda: fa.bwd_dkdv_plain(q, k, v, do, lse, delta, **opts)),
                FA_BWD[2]: (lambda: fa.bwd_dq(q, k, v, do, lse, delta, **opts),
                            lambda: fa.bwd_dq_plain(q, k, v, do, lse, delta, **opts))},
                {name: fa_bound(name, dims, causal, window, dtype, q_offset=q_offset)
                 for name in FA_PAIR_OPS}, dims)
        elif not q_offset and label == FA_TIMED:
            time_flash_attention(rows, q, k, v, do, o, lse, delta, dims, causal, window)
        del q, k, v, do, o, lse, delta, ko, klse
        free_cuda()
    return rows


def time_state_form(rows, form: str, calls: dict, bounds: dict, dims) -> None:
    """Each kernel of ``calls`` (name -> (kernel, plain version)) in a
    state-carrying form, timed as the zero-state rows are (``ms``, its
    plain version's, ``device_ms``, ``host_us``) beside its bound, into the
    kernel's row under ``form``."""
    for name, (kernel, plain) in calls.items():
        bound_ms, bound_by = bounds[name]
        t = dict(shape=list(dims), ms=cuda_ms(kernel),
                 plain_ms=cuda_ms(plain, samples=5, calls=3),
                 bound_ms=bound_ms, bound_by=bound_by, **timings(kernel, None))
        rows[name].setdefault("forms", {})[form] = t
        log(f"{name} {form} {dims}: {t['ms']:.5g} ms (zero-state row "
            f"{rows[name].get('ms', float('nan')):.5g}), device alone "
            f"{t['device_ms']:.5g} ms, plain {t['plain_ms']:.5g} ms, bound "
            f"{bound_ms:.5g} ms ({bound_by})")


def wkv_bound(name: str, dims, dtype, tensor_cores: bool = False, state: bool = False):
    """Least time for a WKV kernel's work: its inputs read once and outputs
    written once (W1 writes y and the chunk states, W2 reads the states and
    writes four f32 gradients and du) over the memory rate, against its f32
    operations over the f32 rate, or with ``tensor_cores`` three times them
    (the split TF32 form's three products) over the TF32 tensor-core rate:
    per chunk the L x L and L x P products counted in full, two operations
    a multiply-add (W1: A, A v, r_dec S and the state update; W2: A and dA
    again, the intra-chunk dr, dk and dv, and dr's, dk's and dv's state
    terms and the dS update). With ``state``, the initial state read and
    the final state written (W2: the final state's gradient read and the
    initial state's written) count too."""
    b, s, h, p = dims
    lc = min(W.WKV_CHUNK, s)
    chunks = b * h * -(-s // lc)
    n, elt = b * s * h * p, torch.empty((), dtype=dtype).element_size()
    states, u = 4 * chunks * p * p + (8 * b * h * p * p if state else 0), 4 * h * p
    if name == WKV_FWD:
        n_bytes = 5 * n * elt + u + states
        ops = chunks * (4 * lc * lc * p + 4 * lc * p * p)
    else:
        n_bytes = 5 * n * elt + u + states + 4 * n * 4 + u
        ops = chunks * (10 * lc * lc * p + 8 * lc * p * p)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = 3 * ops / TF32_OPS_PER_S if tensor_cores else ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def wkv_inputs(dims, dtype, decay: str, gen):
    """``(r, k, v, logw, u, dy)`` on the card: unit normals (r, k, v as
    the time-mix's projections of normalized activations give them), u and
    dy normal, logw by ``decay``: "model" within the model's clamp,
    ``-min(exp(N), 2.5)``; "clamp" every step at it; "weak" ``-0.02
    exp(N)``, mostly within [-0.05, 0], where ``exp(cum_L)`` stays near
    1/3 to 1 a chunk and the state carried across chunks (and its
    gradient) weighs in every output, as in a trained model's slow
    channels."""
    def normal(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=DEVICE) * scale
    b, s, h, p = dims
    r, k, v, dy = (normal(dims) for _ in range(4))
    logw = {"model": lambda: -torch.clamp(torch.exp(normal(dims)), max=2.5),
            "clamp": lambda: torch.full(dims, -2.5, device=DEVICE),
            "weak": lambda: -0.02 * torch.exp(normal(dims))}[decay]()
    ins = [t.to(dtype) for t in (r, k, v, logw)]
    return ins, normal((h, p), 0.3), dy.to(dtype)


def boost_peak(k: torch.Tensor, logw: torch.Tensor) -> float:
    """The largest |k exp(-cum)| the forward's factorization forms."""
    lc = min(W.WKV_CHUNK, k.shape[1])
    cum = torch.cumsum(W._chunks(logw, lc, torch.float32), dim=3)
    return float((W._chunks(k, lc, torch.float32) * torch.exp(-cum)).abs().max())


def rebased_peak(r: torch.Tensor, k: torch.Tensor, logw: torch.Tensor) -> float:
    """The largest |r exp(cumprev - m)| or |k exp(m - cum)| on these
    inputs, m the cum of the chunk's middle row, as ``csrc/wkv6.cu``
    chooses it: the span the middle-row rebase gives, computed here, not
    read from the kernels."""
    lc = min(W.WKV_CHUNK, k.shape[1])
    lw = W._chunks(logw, lc, torch.float32)
    cum = torch.cumsum(lw, dim=3)
    mid = (lc + 1) // 2 - 1
    m = cum[..., mid:mid + 1, :]
    rp = W._chunks(r, lc, torch.float32) * torch.exp(cum - lw - m)
    kp = W._chunks(k, lc, torch.float32) * torch.exp(m - cum)
    return max(float(rp.abs().max()), float(kp.abs().max()))


def chunk_decay_range(logw: torch.Tensor) -> tuple:
    """The smallest and largest ``exp(cum_L)``, the decay a whole chunk
    applies to the carried state, over the chunks of ``logw``."""
    lc = min(W.WKV_CHUNK, logw.shape[1])
    decay = torch.exp(W._chunks(logw, lc, torch.float32).sum(dim=3))
    return float(decay.min()), float(decay.max())


def wkv_fwd_over(a: torch.Tensor, ref: torch.Tensor) -> float:
    """``fwd_over``, and exact agreement where the reference is all zero
    (the chunk states of a one-chunk sequence)."""
    if not bool(ref.abs().max() > 0):
        return 0.0 if not bool((a.float() - ref.float()).abs().max() > 0) \
            else math.inf
    return fwd_over(a, ref)


def check_wkv6() -> dict:
    """B8's kernels against their plain versions, each on the same inputs,
    at every shape of WKV_SHAPES; every kernel run twice gives the same
    bits; timed at WKV_TIMED."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    rows = {name: {"name": name, "route": "cuda", "source": WKV_SOURCE,
                   "replaces": WKV_REPLACES, "max_abs_err": 0.0,
                   "max_rel_err": 0.0, "max_of_limit": 0.0}
            for name in (WKV_FWD, WKV_BWD)}
    peak = 0.0

    check = scan_check(rows)
    for label, dims, dtype, decay in WKV_SHAPES:
        ins, u, dy = wkv_inputs(dims, dtype, decay, gen)
        y_states = W.wkv6_plain(*ins, u)    # y, the chunk states (and the final)
        states = y_states[1]
        grads = W.wkv6_bwd_plain(*ins, u, states, dy)
        fwd = check(WKV_FWD, label, lambda: W.wkv6_fwd(*ins, u), y_states,
                    rel_max, wkv_fwd_over)
        bwd = check(WKV_BWD, label, lambda: W.wkv6_bwd(*ins, u, states, dy),
                    grads, rel_norm, bwd_over)
        label_peak = boost_peak(ins[1], ins[3])
        label_rebased = rebased_peak(ins[0], ins[1], ins[3])
        peak = max(peak, label_peak)
        lo, hi = chunk_decay_range(ins[3])
        log(f"B8 {label} {dims} {dtype}: y, states, final state errors {fwd}; dr dk dv "
            f"dlogw du errors {bwd}; largest |k exp(-cum)| {label_peak:.4g}, "
            f"with m the middle row's cum the largest |r exp(cumprev - m)|, "
            f"|k exp(m - cum)| {label_rebased:.4g}; exp(cum_L) in "
            f"[{lo:.4g}, {hi:.4g}]; bits identical run to run")
        if label == WKV_TIMED:
            for name, kernel, plain in (
                    (WKV_FWD, lambda: W.wkv6_fwd(*ins, u),
                     lambda: W.wkv6_plain(*ins, u)),
                    (WKV_BWD, lambda: W.wkv6_bwd(*ins, u, states, dy),
                     lambda: W.wkv6_bwd_plain(*ins, u, states, dy))):
                ms, plain_ms = cuda_ms(kernel), cuda_ms(plain, samples=5, calls=3)
                bound_ms, bound_by = wkv_bound(name, dims, dtype)
                tc_ms, tc_by = wkv_bound(name, dims, dtype, tensor_cores=True)
                rows[name].update(shape=list(dims), ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by,
                                  bound_tc_ms=tc_ms, bound_tc_by=tc_by,
                                  library_ms=None, **timings(kernel, None))
                log(f"{name} {dims}: {ms:.5g} ms, plain {plain_ms:.5g} ms, "
                    f"library none (no PyTorch call computes the WKV), bound "
                    f"{bound_ms:.5g} ms ({bound_by}), on the tensor cores "
                    f"{tc_ms:.5g} ms ({tc_by}); device alone "
                    f"{rows[name]['device_ms']:.5g} ms, host "
                    f"{rows[name]['host_us']:.4g} us")
        del ins, u, dy, y_states, states, grads
        free_cuda()
    for row in rows.values():
        row["max_boost"] = peak
    return rows


def scan_check(rows):
    """``check(name, label, kernel, refs, measure, over)`` for B8's and B9's
    rows: the kernel run twice gives the same bits, and each output (an
    output not asked for, None, left out) is within its limit of the plain
    version's; the errors join the kernel's row."""
    def present(outs):
        return [t for t in outs if t is not None]

    def check(name, label, kernel, refs, measure, over):
        outs, again, refs = present(kernel()), present(kernel()), present(refs)
        if len(outs) != len(refs) or not all(same_bits(a, b) for a, b in zip(outs, again)):
            raise AssertionError(f"{name} {label}: two runs differ, or "
                                 f"{len(outs)} outputs for {len(refs)}")
        errs = [measure(a, r) if bool(r.abs().max() > 0) else 0.0
                for a, r in zip(outs, refs)]
        abs_errs = [float((a.float() - r.float()).abs().max())
                    for a, r in zip(outs, refs)]
        overs = [over(a, r) for a, r in zip(outs, refs)]
        if not within(overs) or not all(map(math.isfinite, errs + abs_errs)):
            raise AssertionError(f"{name} {label}: errors {errs} (abs {abs_errs}) "
                                 f"are {overs} of their limits")
        row = rows[name]
        row["max_abs_err"] = max(row["max_abs_err"], *abs_errs)
        row["max_rel_err"] = max(row["max_rel_err"], *errs)
        row["max_of_limit"] = max(row["max_of_limit"], *overs)
        return errs
    return check


def ssd_ops(name: str, dims, lc: int) -> int:
    """f32 operations of the SSD (S1's function) or of its backward (S2's)
    at chunks of ``lc``, a multiply-add two, exponentials and cumulative
    sums not counted. Over the causal pairs of a chunk (``l (l + 1) / 2``)
    once per batch row and chunk, as B and C are shared by the heads: the
    forward's C B^T (2N a pair); the backward's C B^T again, dC's and dB's
    intra-chunk products (6N). Per head, a pair: the decay and M xf (2P +
    1); M, dM = dy xf^T, M^T dy, dM's decay, Q and its two sums, the sum of
    dM over heads (4P + 6). Per head, a token: the readout C S and the
    state update (4NP) and x dt (P); dC's and dxf's state terms, the dS
    update and dB's state term (8NP), dg's two N-sums and the sums of dB and
    dC over heads (6N), xf, dx and d(dt) (4P). Per head, a chunk: the state's
    decay (NP); the dS decay and the last step's <S, dS> (3NP)."""
    b, s, h, p, n = dims

    def chunk(l):
        pairs = l * (l + 1) // 2
        if name == SSD_FWD:
            return 2 * n * pairs + h * (pairs * (2 * p + 1) + l * (4 * n * p + p)
                                        + n * p)
        return 6 * n * pairs + h * (pairs * (4 * p + 6)
                                    + l * (8 * n * p + 6 * n + 4 * p) + 3 * n * p)
    whole, rest = divmod(s, lc)
    return b * (whole * chunk(lc) + (chunk(rest) if rest else 0))


def ssd_bound(name: str, dims, dtype, tensor_cores: bool = False, state: bool = False):
    """Least time for an SSD kernel's work: the function's inputs read once
    and outputs written once over the memory rate (S1: x, dt, A, B, C in, y
    out; S2: those and dy in, dx, d(dt), dA, dB, dC out; the chunk states
    are the kernels' own and are not counted), against the function's f32
    operations (``ssd_ops``) at the chunk that needs fewest over the f32
    rate, or with ``tensor_cores`` three times them (the split TF32 form's
    three products) over the TF32 tensor-core rate; and, apart, B9's own
    algorithm's at its chunk of 128, every L x L product counted in full
    and per head, per token and head S1 2L(N + P) + 4NP (C B^T, M xf, the
    readout C S, the state update), S2 2L(3N + 2P) + 10NP (C B^T, dy
    xf^T, M^T dy, G B, G^T C; B dS, C S, dy S^T, dS xf^T, the dS update):
    a yardstick that stays when a kernel changes its chunk. With ``state``,
    the initial state read and the final state written (S2: the final
    state's gradient read and the initial state's written) count too.
    Returns ``(bound ms, "bytes" or "operations", the fewest operations'
    chunk, the yardstick in ms)``."""
    b, s, h, p, n = dims
    elt = torch.empty((), dtype=dtype).element_size()
    x_bytes, bc_bytes, dt_bytes, a_bytes = b * s * h * p * elt, b * s * n * elt, 4 * b * s * h, 4 * h
    ins = x_bytes + dt_bytes + a_bytes + 2 * bc_bytes
    carried = 8 * b * h * n * p if state else 0   # one state read, one written
    lc = B9_CHUNK
    if name == SSD_FWD:
        n_bytes = ins + x_bytes + carried
        yard = b * s * h * (2 * lc * (n + p) + 4 * n * p)
    else:
        n_bytes = 2 * ins + x_bytes + carried
        yard = b * s * h * (2 * lc * (3 * n + 2 * p) + 10 * n * p)
    best = min(range(1, s + 1), key=lambda c: ssd_ops(name, dims, c))
    t_bytes = n_bytes / HBM_BYTES_PER_S
    ops = ssd_ops(name, dims, best)
    t_ops = 3 * ops / TF32_OPS_PER_S if tensor_cores else ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            best, max(t_bytes, yard / F32_OPS_PER_S) * 1e3)


def ssd_inputs(dims, dtype, decay: str, gen, groups: int = 0):
    """``(x, dt, A, Bm, Cm, dy)`` on the card, as the model gives them at
    init: x, B, C and dy unit normals, dt = softplus(N(0, 1)) (dt_bias 0),
    and A by ``decay``: "init" the model's -e (A_log 1), where g falls about
    2 a step and ``exp(g)`` underflows within a few dozen steps, so the
    carried state weighs nothing; "weak" ``-0.01 exp(N)`` a head, where a
    chunk's ``exp(g_L)`` spans most of (0, 1) and the state carried across
    chunks (and its gradient) weighs in every output."""
    def normal(shape):
        return torch.randn(shape, generator=gen, device=DEVICE)
    b, s, h, p, n = dims
    x, dy = normal((b, s, h, p)), normal((b, s, h, p))
    # ``groups`` B/C groups, (B, S, G, N); 0: the (B, S, N) layout
    bc_shape = (b, s, groups, n) if groups else (b, s, n)
    bm, cm = normal(bc_shape), normal(bc_shape)
    dt = torch.nn.functional.softplus(normal((b, s, h)))
    A = {"init": lambda: torch.full((h,), -math.e, device=DEVICE),
         "weak": lambda: -0.01 * torch.exp(normal((h,)))}[decay]()
    return [x.to(dtype), dt, A, bm.to(dtype), cm.to(dtype)], dy.to(dtype)


def ssd_chunk_decay_range(dt: torch.Tensor, A: torch.Tensor) -> tuple:
    """The smallest and largest ``exp(g_L)``, the decay a whole chunk of the
    kernels applies to the carried state, over the whole chunks."""
    lc = SSD.SSD_CHUNK
    whole = dt.shape[1] // lc * lc
    if not whole:
        return (float("nan"), float("nan"))
    g = (dt[:, :whole] * A).reshape(dt.shape[0], -1, lc, dt.shape[2]).sum(dim=2)
    decay = torch.exp(g)
    return float(decay.min()), float(decay.max())


def check_ssd() -> dict:
    """B9's kernels against their plain versions, each on the same inputs,
    at every shape of SSD_SHAPES and the kernels' chunk; every kernel run
    twice gives the same bits; timed at SSD_TIMED."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)
    rows = {name: {"name": name, "route": "cuda", "source": SSD_SOURCE,
                   "replaces": SSD_REPLACES, "max_abs_err": 0.0,
                   "max_rel_err": 0.0, "max_of_limit": 0.0}
            for name in (SSD_FWD, SSD_BWD)}
    spans = {}
    check = scan_check(rows)
    for label, dims, dtype, decay in SSD_SHAPES:
        ins, dy = ssd_inputs(dims, dtype, decay, gen)
        y_states = SSD.ssd_scan_plain(*ins)    # y, the chunk states (and the final)
        states = y_states[1]
        grads = SSD.ssd_scan_bwd_plain(*ins, states, dy)
        fwd = check(SSD_FWD, label, lambda: SSD.ssd_scan_fwd(*ins), y_states,
                    rel_max, wkv_fwd_over)
        bwd = check(SSD_BWD, label, lambda: SSD.ssd_scan_bwd(*ins, states, dy),
                    grads, rel_norm, bwd_over)
        lo, hi = spans[label] = ssd_chunk_decay_range(ins[1], ins[2])
        log(f"B9 {label} {dims} {dtype}: y, states, final state errors {fwd}; dx ddt dA dB "
            f"dC errors {bwd}; exp(g_L) over a chunk of {SSD.SSD_CHUNK} in "
            f"[{lo:.4g}, {hi:.4g}]; largest state {float(states.abs().max()):.4g}; "
            f"bits identical run to run")
        if label == SSD_TIMED:
            for name, kernel, plain in (
                    (SSD_FWD, lambda: SSD.ssd_scan_fwd(*ins),
                     lambda: SSD.ssd_scan_plain(*ins)),
                    (SSD_BWD, lambda: SSD.ssd_scan_bwd(*ins, states, dy),
                     lambda: SSD.ssd_scan_bwd_plain(*ins, states, dy))):
                ms, plain_ms = cuda_ms(kernel), cuda_ms(plain, samples=5, calls=3)
                bound_ms, bound_by, best, yard_ms = ssd_bound(name, dims, dtype)
                tc_ms, tc_by = ssd_bound(name, dims, dtype, tensor_cores=True)[:2]
                rows[name].update(shape=list(dims), ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by,
                                  bound_tc_ms=tc_ms, bound_tc_by=tc_by,
                                  library_ms=None, bound_chunk=best,
                                  b9_chunk128_ms=yard_ms,
                                  states_bytes=states.numel() * 4,
                                  **timings(kernel, None))
                log(f"{name} {dims}: {ms:.5g} ms, plain {plain_ms:.5g} ms, "
                    f"library none (no PyTorch call computes the SSD scan), "
                    f"bound {bound_ms:.5g} ms ({bound_by}, at chunk {best}), on "
                    f"the tensor cores {tc_ms:.5g} ms ({tc_by}); "
                    f"B9's algorithm at chunk {B9_CHUNK} {yard_ms:.5g} ms; chunk "
                    f"states {states.numel() * 4} bytes; device alone "
                    f"{rows[name]['device_ms']:.5g} ms, host "
                    f"{rows[name]['host_us']:.4g} us")
        del ins, dy, y_states, states, grads
        free_cuda()
    for row in rows.values():
        row["chunk_decay_span"] = spans
    return rows


def check_zamba2_7b_kernels() -> dict:
    """Zamba2-7B's kernels: B4 at head_dim 224 with the shared attention's
    scale (FA_224_SHAPES) and B9 with two B/C groups (SSD_GROUP_SHAPES),
    each against its plain versions within B4's and B9's limits, the same
    bits run to run, each at its first shape timed on the device beside its
    bound on the tensor cores and with each instantiation's registers and
    spill bytes, and beside SDPA at the same shape and scale (its forward for
    F1, its backward alone for F3 and F4, and forward and backward through
    autograd against B4's); B9 at G = 1 in the (B, S, G, N) layout bit for
    bit as the (B, S, N) one."""
    out = {"b4": check_flash_attention(FA_224_SHAPES, scale=ZAMBA2_7B_SCALE)}
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)
    label, dims, causal, window, dtype = FA_224_SHAPES[0]
    b, sq, skv, hq, hkv, d = dims
    q, k, v, do = (torch.randn(shape, generator=gen, device=DEVICE)
                   for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d),
                                 (b, sq, hq, d)))
    opts = dict(causal=causal, window=window, scale=ZAMBA2_7B_SCALE)
    o, lse = fa.flash_attention_fwd(q, k, v, **opts)
    delta = fa.bwd_preprocess(o, do)
    # SDPA's backward alone, from one saved output: the library time of the
    # whole B4 backward, given to F3 and F4, as at the other head dims
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    saved = sdpa(*leaves, causal, ZAMBA2_7B_SCALE)

    def sdpa_bwd():
        return torch.autograd.grad(saved, leaves, do, retain_graph=True)

    library = {FA_FWD: lambda: sdpa(q, k, v, causal, ZAMBA2_7B_SCALE),
               FA_BWD[0]: lambda: torch.linalg.vecdot(o, do),
               FA_BWD[1]: sdpa_bwd, FA_BWD[2]: sdpa_bwd}
    for name, kernel in ((FA_FWD, lambda: fa.flash_attention_fwd(q, k, v, **opts)),
                         (FA_BWD[0], lambda: fa.bwd_preprocess(o, do)),
                         (FA_BWD[1], lambda: fa.bwd_dkdv(q, k, v, do, lse, delta, **opts)),
                         (FA_BWD[2], lambda: fa.bwd_dq(q, k, v, do, lse, delta, **opts))):
        tc_ms, tc_by = fa_bound(name, dims, causal, window, dtype, tensor_cores=True)
        res = (ctypes.c_int * 7)()
        which = list(fa._SIGNATURES).index(name)
        fa._lib().flash_attention_launch_config(which, d, 0, ctypes.addressof(res))
        row = out["b4"][name]
        row.update(timed_shape=list(dims), ms_224=cuda_ms(kernel), bound_tc_ms_224=tc_ms,
                   bound_tc_by_224=tc_by, registers_224=res[0], local_bytes_224=res[2],
                   dynamic_smem_224=res[5], blocks_per_sm_224=res[6],
                   library_ms_224=cuda_ms(library[name]),
                   **{f"{key}_224": val for key, val in timings(kernel, library[name]).items()})
        log(f"B4 {name} {label} {dims}: {row['ms_224']:.5g} ms, device alone "
            f"{row['device_ms_224']:.5g} ms, library {row['library_ms_224']:.5g} ms, "
            f"device alone {row['library_device_ms_224']:.5g} ms, bound on the tensor "
            f"cores {tc_ms:.5g} ms ({tc_by}); {res[0]} registers, {res[2]} local bytes, "
            f"{res[5]} dynamic shared bytes, {res[6]} blocks an SM")

    def kernel_fwd_bwd():
        return torch.autograd.grad(fa.flash_attention(*leaves, **opts), leaves, do)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(*leaves, causal, ZAMBA2_7B_SCALE), leaves, do)

    gap = rel_max(sdpa(q, k, v, causal, ZAMBA2_7B_SCALE), o)
    row = out["b4"][FA_FWD]
    row.update(fwd_bwd_ms_224=cuda_ms(kernel_fwd_bwd),
               library_fwd_bwd_ms_224=cuda_ms(sdpa_fwd_bwd),
               fwd_bwd_device_ms_224=device_ms(kernel_fwd_bwd),
               library_fwd_bwd_device_ms_224=device_ms(sdpa_fwd_bwd),
               library_bwd_ms_224=cuda_ms(sdpa_bwd), library_gap_224=gap,
               library_kernels_224=sdpa_kernel_names(q, k, v, do, causal,
                                                     ZAMBA2_7B_SCALE))
    log(f"B4 forward+backward {label} {dims}: kernels {row['fwd_bwd_ms_224']:.5g} ms, "
        f"sdpa {row['library_fwd_bwd_ms_224']:.5g} ms; on the device alone "
        f"{row['fwd_bwd_device_ms_224']:.5g} and "
        f"{row['library_fwd_bwd_device_ms_224']:.5g} ms; sdpa's backward alone "
        f"{row['library_bwd_ms_224']:.5g} ms (sdpa's O against B4's: {gap:.3g} of "
        f"its largest value); sdpa's CUDA kernels {row['library_kernels_224']}")
    del q, k, v, do, o, lse, delta, leaves, saved
    free_cuda()

    rows = {name: {"name": name, "route": "cuda", "source": SSD_SOURCE,
                   "replaces": SSD_REPLACES, "max_abs_err": 0.0,
                   "max_rel_err": 0.0, "max_of_limit": 0.0}
            for name in (SSD_FWD, SSD_BWD)}
    check = scan_check(rows)
    for i, (label, dims, dtype, decay) in enumerate(SSD_GROUP_SHAPES):
        ins, dy = ssd_inputs(dims[:5], dtype, decay, gen, groups=dims[5])
        y_states = SSD.ssd_scan_plain(*ins)
        states = y_states[1]
        grads = SSD.ssd_scan_bwd_plain(*ins, states, dy)
        fwd = check(SSD_FWD, label, lambda: SSD.ssd_scan_fwd(*ins), y_states,
                    rel_max, wkv_fwd_over)
        bwd = check(SSD_BWD, label, lambda: SSD.ssd_scan_bwd(*ins, states, dy),
                    grads, rel_norm, bwd_over)
        # one group in the grouped layout: the ungrouped launch, bit for bit
        one = [ins[0], ins[1], ins[2], ins[3][:, :, :1], ins[4][:, :, :1]]
        flat = one[:3] + [one[3][:, :, 0], one[4][:, :, 0]]
        for a, c in zip(SSD.ssd_scan_fwd(*one), SSD.ssd_scan_fwd(*flat)):
            if not same_bits(a, c):
                raise AssertionError(f"B9 {label}: G = 1 grouped differs from (B, S, N)")
        log(f"B9 {label} {dims} {dtype} {decay}: y, states, final state errors {fwd}; "
            f"dx ddt dA dB dC errors {bwd}; G = 1 in the grouped layout bit for bit")
        if i == 0:
            for name, kernel in ((SSD_FWD, lambda: SSD.ssd_scan_fwd(*ins)),
                                 (SSD_BWD, lambda: SSD.ssd_scan_bwd(*ins, states, dy))):
                tc_ms, tc_by = ssd_bound(name, dims[:5], dtype, tensor_cores=True)[:2]
                rows[name].update(shape=list(dims), ms=cuda_ms(kernel), bound_tc_ms=tc_ms,
                                  bound_tc_by=tc_by, **timings(kernel, None))
                log(f"B9 {name} G=2 {dims}: {rows[name]['ms']:.5g} ms, device alone "
                    f"{rows[name]['device_ms']:.5g} ms, bound on the tensor cores "
                    f"{tc_ms:.5g} ms ({tc_by}, B and C counted once)")
        del ins, dy, y_states, states, grads
        free_cuda()
    out["b9"] = rows
    return out


def check_state_forms(rows: dict) -> None:
    """Phase 3's state-carrying forms (FA_OFFSET_SHAPES; B8 and B9 from an
    initial state), each held against its plain version and timed beside
    the zero-state row."""
    check_flash_attention(FA_OFFSET_SHAPES, CARRY_CUT, rows)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(4)
    check = scan_check(rows)
    for label, dims, dtype, decay in WKV_SHAPES:
        if label != WKV_TIMED:
            continue
        ins, u, dy = wkv_inputs(dims, dtype, decay, gen)
        b, _, h, p = dims
        s0 = torch.randn((b, h, p, p), generator=gen, device=DEVICE)
        d_fin = torch.randn((b, h, p, p), generator=gen, device=DEVICE)
        ref = W.wkv6_plain(*ins, u, s0)
        fwd = check(WKV_FWD, f"{label} from a state", lambda: W.wkv6_fwd(*ins, u, s0),
                    ref, rel_max, wkv_fwd_over)
        states = ref[1]

        def bwd_call(states=states):
            return W.wkv6_bwd(*ins, u, states, dy, d_fin, with_initial=True)

        bwd = check(WKV_BWD, f"{label} from a state", bwd_call,
                    W.wkv6_bwd_plain(*ins, u, states, dy, d_fin, with_initial=True),
                    rel_norm, bwd_over)
        log(f"B8 {label} {dims} from a state: y, states, final state errors "
            f"{fwd}; dr dk dv dlogw du d_initial errors {bwd}")
        time_state_form(rows, "from a state", {
            WKV_FWD: (lambda: W.wkv6_fwd(*ins, u, s0), lambda: W.wkv6_plain(*ins, u, s0)),
            WKV_BWD: (bwd_call, lambda: W.wkv6_bwd_plain(
                *ins, u, states, dy, d_fin, with_initial=True))},
            {name: wkv_bound(name, dims, dtype, state=True) for name in (WKV_FWD, WKV_BWD)},
            dims)
        del ins, u, dy, s0, d_fin, ref, states
    for label, dims, dtype, decay in SSD_SHAPES:
        if label != SSD_TIMED:
            continue
        ins, dy = ssd_inputs(dims, dtype, decay, gen)
        b, _, h, p, n = dims
        s0 = torch.randn((b, h, n, p), generator=gen, device=DEVICE)
        d_fin = torch.randn((b, h, n, p), generator=gen, device=DEVICE)
        ref = SSD.ssd_scan_plain(*ins, s0)
        fwd = check(SSD_FWD, f"{label} from a state", lambda: SSD.ssd_scan_fwd(*ins, s0),
                    ref, rel_max, wkv_fwd_over)
        states = ref[1]

        def bwd_call(states=states):
            return SSD.ssd_scan_bwd(*ins, states, dy, d_fin, with_initial=True)

        bwd = check(SSD_BWD, f"{label} from a state", bwd_call,
                    SSD.ssd_scan_bwd_plain(*ins, states, dy, d_fin, with_initial=True),
                    rel_norm, bwd_over)
        log(f"B9 {label} {dims} from a state: y, states, final state errors "
            f"{fwd}; dx ddt dA dB dC d_initial errors {bwd}")
        time_state_form(rows, "from a state", {
            SSD_FWD: (lambda: SSD.ssd_scan_fwd(*ins, s0),
                      lambda: SSD.ssd_scan_plain(*ins, s0)),
            SSD_BWD: (bwd_call, lambda: SSD.ssd_scan_bwd_plain(
                *ins, states, dy, d_fin, with_initial=True))},
            {name: ssd_bound(name, dims, dtype, state=True)[:2]
             for name in (SSD_FWD, SSD_BWD)}, dims)
        del ins, dy, s0, d_fin, ref, states
    free_cuda()


def adamw_inputs(shape, p_dtype, g_dtype, step: int, gen, offset: int = 0):
    """``(p, g, m, v, bc1, bc2)`` of one leaf, each tensor ``offset``
    elements past the start of its allocation: weights and gradients of a
    model's size, every seventh gradient 0, a few gradients far outside
    their spread, moments of a few steps' size with every eleventh second
    moment 0; the bias corrections of ``step`` as ``adamw_update`` forms
    them."""
    n = math.prod(shape)

    def draw(scale, dtype=torch.float32):
        x = torch.randn(n + offset, generator=gen, device=DEVICE) * scale
        return x.to(dtype)[offset:].view(shape)

    p, g, m, v = draw(0.02, p_dtype), draw(1e-3, g_dtype), draw(1e-3), draw(1.0)
    v.square_().mul_(1e-6)
    flat_g, flat_v = g.view(-1), v.view(-1)
    flat_g[::7] = 0.0
    flat_v[::11] = 0.0
    flat_g[1::1009] = 3e4
    flat_g[2::1013] = -1e-20
    t = torch.tensor(step, dtype=torch.int32, device=DEVICE).float()
    return p, g, m, v, 1.0 - 0.9 ** t, 1.0 - 0.95 ** t


def adamw_bound_ms(numel: int, p_dtype, g_dtype) -> float:
    """p, g, m and v read once, p', m' and v' written once, at the HBM rate
    (the few operations an element are far below the line)."""
    size = {torch.float32: 4, torch.bfloat16: 2}
    return numel * (2 * size[p_dtype] + size[g_dtype] + 16) / HBM_BYTES_PER_S * 1e3


def check_adamw() -> dict:
    """AdamW's kernel against its plain version, bit for bit in p', m' and
    v', at every leaf shape of ADAMW_CONFIGS (f32) and at ADAMW_RAGGED with
    each pairing of f32 and bf16 parameters and gradients; timed at each
    configuration's largest leaf beside its bound and its plain version.
    No PyTorch call computes this arrangement (``torch.optim``'s fused
    AdamW orders its operations otherwise): no library column."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)
    row = {"name": "adamw_leaf", "route": "cuda", "source": ADAMW_SOURCE,
           "replaces": None, "library_ms": None, "library_device_ms": None,
           "timed": {}}
    largest, cases = {}, []
    for arch, layers in ADAMW_CONFIGS:
        specs = build_model(dataclasses.replace(get_arch(arch), n_layers=layers)
                            ).param_specs()
        shapes = sorted({tuple(spec.shape) for _, spec in _flatten(specs)})
        largest[arch] = max(shapes, key=math.prod)
        cases += [(shape, torch.float32, torch.float32, 0) for shape in shapes]
    pairs = [(a, b) for a in AD.DTYPES for b in AD.DTYPES]
    cases += [((n,), p_dt, g_dt, off) for n, off in ADAMW_RAGGED for p_dt, g_dt in pairs]
    for i, (shape, p_dt, g_dt, off) in enumerate(sorted(set(cases), key=str)):
        ins = adamw_inputs(shape, p_dt, g_dt, 1 + i % 5, gen, off)
        outs = AD.adamw_leaf(*ins, **ADAMW_HYPER)
        refs = AD.adamw_leaf_plain(*ins, **ADAMW_HYPER)
        if not all(same_bits(a, b) for a, b in zip(outs, refs)):
            errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(outs, refs)]
            raise AssertionError(f"adamw_leaf {shape} p {p_dt} g {g_dt} offset {off}: "
                                 f"kernel differs from its plain version (p', m', v' "
                                 f"max abs err {errs})")
        del ins, outs, refs
    free_cuda()
    log(f"adamw_leaf bit-exact against its plain version at {len(set(cases))} "
        f"shapes and layouts (every leaf shape of {[a for a, _ in ADAMW_CONFIGS]})")
    for arch, shape in largest.items():
        ins = adamw_inputs(shape, torch.float32, torch.float32, 3, gen)
        kernel = lambda: AD.adamw_leaf(*ins, **ADAMW_HYPER)  # noqa: E731
        plain = lambda: AD.adamw_leaf_plain(*ins, **ADAMW_HYPER)  # noqa: E731
        timed = dict(shape=list(shape), ms=cuda_ms(kernel),
                     plain_ms=cuda_ms(plain, samples=5, calls=3),
                     plain_device_ms=device_ms(plain, samples=5),
                     bound_ms=adamw_bound_ms(math.prod(shape), torch.float32,
                                             torch.float32),
                     bound_by="bytes", **timings(kernel, None))
        row["timed"][arch] = timed
        log(f"adamw_leaf {arch} largest leaf {shape} ({card_line()}): {timed['ms']:.5g} "
            f"ms, plain {timed['plain_ms']:.5g} ms, library none, bound "
            f"{timed['bound_ms']:.5g} ms (bytes); device alone "
            f"{timed['device_ms']:.5g} ms ({100 * timed['bound_ms'] / timed['device_ms']:.4g}% "
            f"of its roofline), plain {timed['plain_device_ms']:.5g} ms, host "
            f"{timed['host_us']:.4g} us")
        del ins, kernel, plain
        free_cuda()
    row.update(row["timed"][MOE_ARCH], seconds=time.perf_counter() - t0)
    log(f"adamw_leaf checked and timed in {row['seconds']:.3f} s")
    return {"adamw_leaf": row}


def fa_expected(n_layers: int, rings, remat: bool) -> dict:
    """B4's launches over steps at the ring sizes ``rings``: per step and
    layer each of the w ranks runs the forward (twice with remat: again in
    the recompute of backward) and each backward kernel once."""
    ranks = sum(rings)
    return {FA_FWD: (2 if remat else 1) * n_layers * ranks,
            **{name: n_layers * ranks for name in FA_BWD}}


def check_fa_launches(what: str, want: dict) -> dict:
    got = dict(fa.LAUNCHES)
    if got != want:
        raise AssertionError(f"{what}: B4 launches {got} != schedule {want}")
    return got


def check_small_against_cpu(mode: str, cfg=None) -> list:
    """A reduced model (reduced qwen3-0.6b by default), two steps of
    ``mode`` at w=4 on the card and on the CPU (the plain versions) from
    the same weights, with the config's optimizer; returns the losses on
    the card."""
    cfg = cfg or get_arch(ARCH).reduced()
    model = build_model(cfg)
    data = SyntheticTokens(cfg.vocab, 16, GLOBAL_BATCH, seed=0)
    params = model.init(0, device="cpu", dtype=torch.float32)
    losses = {}
    fa.reset_launches()
    for device in ("cpu", DEVICE):
        tr = ElasticTrainer(model, make_optimizer(cfg.optimizer), data,
                            global_batch=GLOBAL_BATCH, base_lr=1e-3,
                            mode=mode, device=device,
                            params=tree_map(lambda t, d=device: t.to(d), params))
        tr.run_slot(SlotPlan(workers=4, steps=2))
        losses[device] = tr.losses
    check_fa_launches(f"{cfg.name} {mode}", fa_expected(cfg.n_layers, [4, 4], cfg.remat))
    gap = max(abs(a - b) for a, b in zip(losses["cpu"], losses[DEVICE]))
    moe = f", capacity factor {cfg.moe_capacity}" if cfg.n_experts else ""
    log(f"{cfg.name} ({cfg.optimizer}{moe}), {mode}, card (attention through "
        f"B4) vs CPU losses {losses[DEVICE]} vs {losses['cpu']}: max gap {gap:.3g}")
    if not gap < 1e-3:
        raise AssertionError(f"{cfg.name} {mode}: card and CPU losses differ by {gap}")
    return losses[DEVICE]


def check_rwkv_small_against_cpu() -> None:
    """Reduced rwkv6-7b, two steps of the f32 ring at w=4 on the card (the
    time-mix through B8) and on the CPU (the plain recurrence) from the
    same weights."""
    cfg = get_arch(RWKV_ARCH).reduced()
    model = build_model(cfg)
    data = SyntheticTokens(cfg.vocab, 40, GLOBAL_BATCH, seed=0)
    params = model.init(0, device="cpu", dtype=torch.float32)
    losses = {}
    W.reset_launches()
    for device in ("cpu", DEVICE):
        tr = ElasticTrainer(model, make_optimizer("adamw"), data,
                            global_batch=GLOBAL_BATCH, base_lr=1e-3,
                            mode="ring", device=device,
                            params=tree_map(lambda t, d=device: t.to(d), params))
        tr.run_slot(SlotPlan(workers=4, steps=2))
        losses[device] = tr.losses
    want = dict.fromkeys(W.LAUNCHES, cfg.n_layers * 4 * 2)
    if dict(W.LAUNCHES) != want:
        raise AssertionError(f"reduced rwkv: B8 launches {W.LAUNCHES} != {want}")
    gap = max(abs(a - b) for a, b in zip(losses["cpu"], losses[DEVICE]))
    log(f"reduced rwkv, ring, card (time-mix through B8) vs CPU losses "
        f"{losses[DEVICE]} vs {losses['cpu']}: max gap {gap:.3g}")
    if not gap < 1e-3:
        raise AssertionError(f"reduced rwkv: card and CPU losses differ by {gap}")


def zamba_fa_expected(cfg, rings) -> dict:
    """B4's launches over steps at the ring sizes ``rings`` on Zamba2: per
    step each of the w ranks applies the shared attention block once a
    group of ``attn_every`` Mamba layers, outside remat, so the forward and
    each backward kernel run once an application."""
    groups = cfg.n_layers // cfg.attn_every
    return dict.fromkeys(FA_PAIR_OPS, groups * sum(rings))


def ssd_expected(cfg, rings) -> dict:
    """B9's launches over steps at the ring sizes ``rings``: per step, layer
    and rank S1 once (twice with remat: again in the recompute of
    backward) and S2 once."""
    ranks = sum(rings)
    return {SSD_FWD: (2 if cfg.remat else 1) * cfg.n_layers * ranks,
            SSD_BWD: cfg.n_layers * ranks}


def check_zamba_small_against_cpu() -> None:
    """Reduced zamba2-1.2b, two steps of the f32 ring at w=4 on the card (the
    SSD through B9, the shared attention through B4) and on the CPU (the
    plain forms) from the same weights, the first loss compared; and one
    rank's gradients at those weights on both, leaf by leaf."""
    cfg = get_arch(ZAMBA_ARCH).reduced()
    model = build_model(cfg)
    data = SyntheticTokens(cfg.vocab, 40, GLOBAL_BATCH, seed=0)
    params = model.init(0, device="cpu", dtype=torch.float32)
    losses, grads = {}, {}
    SSD.reset_launches()
    fa.reset_launches()
    batch = {k: torch.as_tensor(v) for k, v in data.batch(0).items()}
    for device in ("cpu", DEVICE):
        tr = ElasticTrainer(model, make_optimizer("adamw"), data,
                            global_batch=GLOBAL_BATCH, base_lr=1e-3,
                            mode="ring", device=device,
                            params=tree_map(lambda t, d=device: t.to(d), params))
        home = tr.group.devices[0]
        shard = shard_batch(batch, [home] * 4)[:1]
        _, (g,) = rank_grads(model, {home: tree_map(lambda t: t.to(home), params)},
                             shard, [home])
        grads[device] = {k: v.cpu() for k, v in g.items()}
        tr.run_slot(SlotPlan(workers=4, steps=2))
        losses[device] = tr.losses
    want = {**ssd_expected(cfg, [4, 4] + [1]), **zamba_fa_expected(cfg, [4, 4] + [1])}
    got = {**SSD.LAUNCHES, **fa.LAUNCHES}
    if got != want:
        raise AssertionError(f"reduced zamba2: B9, B4 launches {got} != {want}")
    gaps = [abs(a - b) for a, b in zip(losses["cpu"], losses[DEVICE])]
    norms = {k: rel_norm(grads[DEVICE][k], grads["cpu"][k]) for k in grads["cpu"]}
    worst = max(norms, key=norms.get)
    log(f"reduced zamba2, ring, card (SSD through B9, attention through B4) vs "
        f"CPU losses {losses[DEVICE]} vs {losses['cpu']}: gaps {gaps}; one "
        f"rank's gradients at the first weights: worst leaf {worst} "
        f"{norms[worst]:.3g}")
    if not (gaps[0] <= SMALL_FIRST_TOL and all(map(math.isfinite, gaps))
            and within(n / SMALL_GRAD_TOL for n in norms.values())):
        raise AssertionError(f"reduced zamba2: card and CPU differ: loss gaps "
                             f"{gaps}, gradient norms {norms}")


# -- phase 4: the main paths ------------------------------------------------

def ring_units(mode: str, sizes: list) -> list:
    """The flat sizes the mode reduces one ring call each: every leaf, or
    every bucket of the overlap mode's reverse-autodiff plan."""
    n_buckets = STEP_MODES[mode].n_buckets
    if n_buckets is None:
        return list(sizes)
    return plan_bucket_sizes(sizes, n_buckets, reverse=True)


def expected_launches(mode: str, sizes: list, rings=MAIN_RINGS) -> dict:
    """Launches of each kernel the mode's schedule makes over steps at the
    ring sizes ``rings`` (PLAN's by default): per step and ring call, each
    rank quantizes (or casts) twice, requantizes w-2 times, accumulates once
    and dequantizes (or upcasts) once."""
    send, hop, last, unpack = MODE_KERNELS[mode]
    n = len(ring_units(mode, sizes))
    out = dict.fromkeys(qr.LAUNCHES, 0)
    for w in rings:
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
        want_psums = steps * ((len(units) if variant.collective == "psum" else 0)
                              + LOSS_MEAN_PSUMS)
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
    fa.reset_launches()
    t0 = time.perf_counter()
    res = trainer.run_slot(PLAN)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(qr.LAUNCHES)
    fa_launches = check_fa_launches(
        mode, fa_expected(model.cfg.n_layers, MAIN_RINGS, model.cfg.remat))
    peak = torch.cuda.max_memory_allocated()

    losses = trainer.losses
    log(f"{mode}: losses {losses}, warm step s {res['timings']}, slot "
        f"{seconds:.4f} s, peak {peak / 2**30:.4f} GiB, launches "
        f"{ {k: v for k, v in launches.items() if v} }, B4 {fa_launches}")
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
    return {"trainer": trainer, "res": res, "launches": {**launches, **fa_launches},
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
    fa.reset_launches()
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
    # three rank_grads calls at each ring size
    fa_launches = check_fa_launches(f"{mode} check_reduction", fa_expected(
        model.cfg.n_layers, [4] * 3 + [2] * 3, model.cfg.remat))
    return {"worst": worst, "parts": parts, "fa_launches": fa_launches}


def kernel_share(model, trainer, data, module, what: str) -> dict:
    """The CUDA-event time of ``module``'s kernels (through its ``TIMED``
    list) over one rank's forward and backward (CUDA events around it), on
    rank 0's shard of a w=4 step, warm."""
    batch = {k: torch.as_tensor(v) for k, v in data.batch(trainer.step).items()}
    devices = trainer.group.devices[:4]
    shard, dev = shard_batch(batch, devices)[:1], devices[:1]
    for _ in range(2):
        rank_grads(model, trainer.params, shard, dev)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    module.TIMED = []
    try:
        start.record()
        rank_grads(model, trainer.params, shard, dev)
        end.record()
        end.synchronize()
        by_kernel = dict.fromkeys(module.LAUNCHES, 0.0)
        for name, s, e in module.TIMED:
            by_kernel[name] += s.elapsed_time(e)
    finally:
        module.TIMED = None
    total = start.elapsed_time(end)
    out = {"rank_ms": total, "kernel_ms": by_kernel,
           "share": sum(by_kernel.values()) / total}
    log(f"{what}'s share of one rank's forward and backward: {out}")
    return out


# -- phase 5: the modes without kernels ---------------------------------------

def plain_mode(mode: str, model, data) -> dict:
    """Two steps at w=4; returns B4's launches over them."""
    trainer = ElasticTrainer(model, make_optimizer("adamw"), data,
                             global_batch=GLOBAL_BATCH, base_lr=LR,
                             mode=mode, device=DEVICE)
    qr.reset_launches()
    fa.reset_launches()
    trainer.run_slot(SlotPlan(workers=4, steps=2))
    if any(qr.LAUNCHES.values()):
        raise AssertionError(f"{mode} launched ring kernels: {qr.LAUNCHES}")
    fa_launches = check_fa_launches(
        mode, fa_expected(model.cfg.n_layers, [4, 4], model.cfg.remat))
    if not all(math.isfinite(x) for x in trainer.losses):
        raise AssertionError(f"{mode} losses not finite: {trainer.losses}")
    sizes = leaf_sizes(next(iter(trainer.params.values())))
    check_wire(mode, trainer, sizes, [4, 4])
    log(f"{mode} at w=4, {PLAIN_MODE_LAYERS} layers: losses {trainer.losses}, "
        f"no ring kernel launched, B4 {fa_launches}, ring counts equal the formula")
    return fa_launches


# -- phase 6: the RWKV6 path --------------------------------------------------

@torch.no_grad()
def slot_evals(trainer) -> tuple:
    """The loss on the held-out batch, and on the slot's first batch (the
    tokens its first step fits), at the trainer's parameters."""
    from repro_torch.launch.schedule_and_train import HELDOUT_STEP
    home, params = next(iter(trainer.params.items()))
    out = []
    for step in (HELDOUT_STEP, 0):
        batch = {k: torch.as_tensor(v).to(home)
                 for k, v in trainer.data.batch(step).items()}
        out.append(float(trainer.model.loss(params, batch)))
    return tuple(out)


def all_launches() -> dict:
    return {**qr.LAUNCHES, **fa.LAUNCHES, **W.LAUNCHES, **SSD.LAUNCHES}


def reset_all_launches() -> None:
    for module in (qr, fa, W, SSD):
        module.reset_launches()


def ring_slot(model, data, mode: str = "ring"):
    """``PLAN`` in ``mode`` (the f32 ``ring`` by default) from
    ``model.init(0)``; returns
    ``(trainer, run_slot's result, {"heldout", "first_batch"}: each loss
    before and after, slot seconds, peak bytes, every kernel's launches)``,
    the counters set to 0 just before the slot and read just after. AdamW's
    launches are held to one a leaf a step (the result's
    ``adamw_launches``)."""
    trainer = ElasticTrainer(model, make_optimizer("adamw"), data,
                             global_batch=GLOBAL_BATCH, base_lr=LR,
                             mode=mode, device=DEVICE)
    before = slot_evals(trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    AD.reset_launches()
    t0 = time.perf_counter()
    res = trainer.run_slot(PLAN)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = all_launches()
    # one AdamW launch a leaf a step: every rank's replica is on the one card
    leaves = len(list(_flatten(model.param_specs())))
    res["adamw_launches"] = AD.LAUNCHES["adamw_leaf"]
    if res["adamw_launches"] != leaves * PLAN.steps:
        raise AssertionError(f"{model.cfg.name}: {res['adamw_launches']} AdamW launches, "
                             f"not {leaves} leaves x {PLAN.steps} steps")
    peak = torch.cuda.max_memory_allocated()
    after = slot_evals(trainer)
    evals = {"heldout": (before[0], after[0]), "first_batch": (before[1], after[1])}
    return trainer, res, evals, seconds, peak, launches


def rwkv_path(cfg) -> dict:
    """``PLAN`` on rwkv6-7b (``cfg``: full width, depth cut) through B8,
    its launches against the model's schedule, its loss on the slot's first
    batch falling; the same slot from the same weights with the time-mix
    through the plain recurrence on the card (``models.rwkv.wkv6_chunked``,
    autograd's backward), every step's loss compared; then B8's share of
    one rank's forward and backward. The held-out loss is recorded, not
    required to fall: at this width the first AdamW steps fit each batch's
    tokens and lower every other token's logit, in the reference as in the
    port (``tests/test_torch_rwkv.py --width-witness``, PERF.md)."""
    from repro_torch.models import rwkv as rwkv_model

    model = build_model(cfg)
    data = SyntheticTokens(cfg.vocab, SEQ, GLOBAL_BATCH, seed=0)
    trainer, res, evals, seconds, peak, launches = ring_slot(model, data)
    ranks = sum(MAIN_RINGS)
    want = {WKV_FWD: (2 if cfg.remat else 1) * cfg.n_layers * ranks,
            WKV_BWD: cfg.n_layers * ranks}
    launches, others = ({k: v for k, v in launches.items() if (k in want) == mine}
                        for mine in (True, False))
    if launches != want or any(others.values()):
        raise AssertionError(f"rwkv: B8 launches {launches} != schedule {want}, "
                             f"or other kernels launched: {others}")
    losses = trainer.losses
    heldout, first = evals["heldout"], evals["first_batch"]
    log(f"rwkv {cfg.name} {cfg.n_layers} layers, "
        f"{n_params(model.param_specs())} params: losses {losses}, held-out "
        f"{heldout[0]} -> {heldout[1]}, the slot's first batch {first[0]} -> "
        f"{first[1]}, warm step s {res['timings']}, slot "
        f"{seconds:.4f} s, peak {peak / 2**30:.4f} GiB, B8 {launches}")
    values = losses + list(heldout) + list(first)
    if not all(math.isfinite(x) for x in values) or not first[1] < first[0]:
        raise AssertionError(f"rwkv: losses not finite, or the first batch's "
                             f"not falling: {losses}, {evals}")
    if trainer.re_ring_events != 1 or len(losses) != PLAN.steps:
        raise AssertionError(f"rwkv: re_ring_events {trainer.re_ring_events}, "
                             f"{len(losses)} steps")
    share = kernel_share(model, trainer, data, W, "B8")
    del trainer
    free_cuda()

    kernel_wkv6 = rwkv_model.wkv6
    rwkv_model.wkv6 = lambda r, k, v, logw, u, state=None: rwkv_model.wkv6_chunked(
        r, k, v, logw, u, initial_state=state)
    try:
        plain, _, plain_evals, plain_s, _, plain_launches = ring_slot(model, data)
    finally:
        rwkv_model.wkv6 = kernel_wkv6
    plain_values = (plain.losses + list(plain_evals["heldout"])
                    + list(plain_evals["first_batch"]))
    gaps = [abs(a - b) for a, b in zip(values, plain_values)]
    log(f"rwkv through the plain recurrence: losses {plain.losses}, "
        f"{plain_evals}, slot {plain_s:.4f} s; largest gap to the kernels' "
        f"{max(gaps):.3g}")
    if any(plain_launches.values()) or len(gaps) != len(values) or not all(
            math.isfinite(g) and g <= RWKV_LOSS_TOL for g in gaps):
        raise AssertionError(f"rwkv: kernels' slot {values} against the plain "
                             f"slot {plain_values} (B8 launched {plain_launches})")
    del plain
    free_cuda()
    return {"launches": {**launches, "adamw_leaf": res["adamw_launches"]}, "summary": {
        "arch": cfg.name, "n_layers": cfg.n_layers,
        "params": n_params(model.param_specs()), "losses": losses,
        "heldout": list(heldout), "first_batch": list(first), "slot_s": seconds,
        "plain_slot_s": plain_s, "loss_gap_to_plain": max(gaps),
        "warm_step_s": {str(w): t for w, t in res["timings"].items()},
        "peak_gib": peak / 2**30, "b8_launches": launches,
        "b8_share_of_rank_grads": share}}


# -- phase 7: the Zamba2 path -------------------------------------------------

def ssd_calls_against_plain(model, trainer, data) -> dict:
    """One rank's forward and backward on the Zamba2 path (rank 0's shard of
    a w=4 step, at the trainer's weights) with every S1 and S2 call held
    against its plain version on the same inputs: y and the chunk states
    within FA_FWD_TOL of their largest value, each gradient within
    FA_BWD_TOL's relative norm; and S1's y against the SSD in f64 (the
    plain version on f64 inputs), beside the model's plain ``ssd_chunked``
    in f32 at its chunk of 256."""
    from repro_torch.models import ssm as ssm_model

    cfg = model.cfg
    batch = {k: torch.as_tensor(v) for k, v in data.batch(trainer.step).items()}
    devices = trainer.group.devices[:4]
    shard, dev = shard_batch(batch, devices)[:1], devices[:1]
    kernel_fwd, kernel_bwd = SSD.ssd_scan_fwd, SSD.ssd_scan_bwd
    out = {"fwd_calls": 0, "bwd_calls": 0, "fwd_of_limit": 0.0,
           "bwd_of_limit": 0.0, "kernel_vs_f64": 0.0, "chunked_vs_f64": 0.0}

    def fwd(x, dt, A, Bm, Cm, initial_state=None):
        y, states, final = kernel_fwd(x, dt, A, Bm, Cm, initial_state)
        y_ref, st_ref, fin_ref = SSD.ssd_scan_plain(x, dt, A, Bm, Cm, initial_state)
        exact = SSD.ssd_scan_plain(*(t.double() for t in (x, dt, A, Bm, Cm)))[0]
        chunked = ssm_model.ssd_chunked(x, dt, A, Bm, Cm, cfg.ssm_chunk)[0]
        out["fwd_calls"] += 1
        out["fwd_of_limit"] = max(out["fwd_of_limit"], wkv_fwd_over(y, y_ref),
                                  wkv_fwd_over(states, st_ref),
                                  wkv_fwd_over(final, fin_ref))
        out["kernel_vs_f64"] = max(out["kernel_vs_f64"], rel_max(y, exact))
        out["chunked_vs_f64"] = max(out["chunked_vs_f64"], rel_max(chunked, exact))
        return y, states, final

    def bwd(x, dt, A, Bm, Cm, states, dy, d_final=None, *, with_initial=False):
        grads = kernel_bwd(x, dt, A, Bm, Cm, states, dy, d_final,
                           with_initial=with_initial)
        refs = SSD.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, states, dy, d_final,
                                      with_initial=with_initial)
        out["bwd_calls"] += 1
        out["bwd_of_limit"] = max(out["bwd_of_limit"], *(
            bwd_over(g, r) for g, r in zip(grads, refs) if r is not None))
        return grads

    SSD.ssd_scan_fwd, SSD.ssd_scan_bwd = fwd, bwd
    try:
        rank_grads(model, trainer.params, shard, dev)
    finally:
        SSD.ssd_scan_fwd, SSD.ssd_scan_bwd = kernel_fwd, kernel_bwd
    log(f"zamba2: every SSD call of one rank's forward and backward against "
        f"the plain versions on its own inputs: {out}")
    want_calls = ssd_expected(cfg, [1])
    if (out["fwd_calls"], out["bwd_calls"]) != (want_calls[SSD_FWD],
                                                want_calls[SSD_BWD]):
        raise AssertionError(f"zamba2: {out['fwd_calls']} S1 and "
                             f"{out['bwd_calls']} S2 calls, want {want_calls}")
    if not (within([out["fwd_of_limit"], out["bwd_of_limit"]])
            and out["kernel_vs_f64"] <= out["chunked_vs_f64"]):
        raise AssertionError(f"zamba2: the kernels against the plain versions, "
                             f"or against the f64 SSD: {out}")
    return out


def zamba_path(cfg) -> dict:
    """``PLAN`` on zamba2-1.2b (``cfg``: full width) through B9 and B4, their
    launches against the model's schedule and no other kernel's, its loss
    on the slot's first batch falling; every S1 and S2 call of one rank's
    forward and backward against the plain versions on the path's own
    inputs; B9's and B4's shares of one rank's forward and backward. The
    held-out loss is recorded, not required to fall (as on the RWKV6 path).
    The slot is not held against the same slot through the plain SSD: the
    model at random init turns the reordered sums of any exact SSD into
    loss gaps of 1e-2 and more (``tools/zamba2_ssd_forms.py``, PERF.md)."""
    model = build_model(cfg)
    data = SyntheticTokens(cfg.vocab, SEQ, GLOBAL_BATCH, seed=0)
    want = {**ssd_expected(cfg, MAIN_RINGS), **zamba_fa_expected(cfg, MAIN_RINGS)}
    trainer, res, evals, seconds, peak, launches = ring_slot(model, data)
    launches, others = ({k: v for k, v in launches.items() if (k in want) == mine}
                        for mine in (True, False))
    if launches != want or any(others.values()):
        raise AssertionError(f"zamba2: B9, B4 launches {launches} != schedule "
                             f"{want}, or other kernels launched: {others}")
    losses = trainer.losses
    heldout, first = evals["heldout"], evals["first_batch"]
    log(f"zamba2 {cfg.name} {cfg.n_layers} layers, "
        f"{n_params(model.param_specs())} params: losses {losses}, held-out "
        f"{heldout[0]} -> {heldout[1]}, the slot's first batch {first[0]} -> "
        f"{first[1]}, warm step s {res['timings']}, slot {seconds:.4f} s, peak "
        f"{peak / 2**30:.4f} GiB, B9 and B4 {launches}")
    values = losses + list(heldout) + list(first)
    if not all(math.isfinite(x) for x in values) or not first[1] < first[0]:
        raise AssertionError(f"zamba2: losses not finite, or the first batch's "
                             f"not falling: {losses}, {evals}")
    if trainer.re_ring_events != 1 or len(losses) != PLAN.steps:
        raise AssertionError(f"zamba2: re_ring_events {trainer.re_ring_events}, "
                             f"{len(losses)} steps")
    shares = {"b9": kernel_share(model, trainer, data, SSD, "B9"),
              "b4": kernel_share(model, trainer, data, fa, "B4")}
    calls = ssd_calls_against_plain(model, trainer, data)
    del trainer
    free_cuda()
    return {"launches": {**launches, "adamw_leaf": res["adamw_launches"]}, "summary": {
        "arch": cfg.name, "n_layers": cfg.n_layers,
        "params": n_params(model.param_specs()), "losses": losses,
        "heldout": list(heldout), "first_batch": list(first), "slot_s": seconds,
        "ssd_calls": calls,
        "warm_step_s": {str(w): t for w, t in res["timings"].items()},
        "peak_gib": peak / 2**30, "launches": launches,
        "b9_share_of_rank_grads": shares["b9"],
        "b4_share_of_rank_grads": shares["b4"]}}


# -- phase 7b: the state-carrying path ----------------------------------------

@contextlib.contextmanager
def recorded(module, name: str, calls: list):
    """While active, ``module.<name>`` appends its positional arguments
    (tensors detached and cloned) and keywords to ``calls`` before it runs."""
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        calls.append(([a.detach().clone() if isinstance(a, torch.Tensor) else a
                       for a in args], kw))
        return fn(*args, **kw)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def halves_against_whole(whole, halves, leaves: dict, gen) -> dict:
    """``whole(leaves)``, the whole sequence's outputs on its second half
    (then its final states), against ``halves(leaves)``, the second half's
    from the states the first half returns: each output within FA_FWD_TOL
    of its largest value, and the gradients of ``<output, g>`` (a loss on
    the second half, ``g`` normal) in every leaf within FA_BWD_TOL's
    relative norm. The largest shares of the limits, the largest gap of an
    output over its largest value, and whether every output and gradient
    kept its bits."""
    outs, grads, g = {}, {}, None
    for name, fn in (("whole", whole), ("halves", halves)):
        lv = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
        out = fn(lv)
        if g is None:
            g = torch.randn(out[0].shape, generator=gen, device=DEVICE)
        grads[name] = dict(zip(lv, torch.autograd.grad(torch.sum(out[0] * g),
                                                       list(lv.values()))))
        outs[name] = [o.detach() for o in out]
    pairs = list(zip(outs["halves"], outs["whole"]))
    gpairs = [(grads["halves"][k], grads["whole"][k]) for k in leaves]
    return {"fwd_of_limit": max(fwd_over(a, b) for a, b in pairs),
            "bwd_of_limit": max(bwd_over(a, b) for a, b in gpairs),
            "largest_gap": max(rel_max(a, b) for a, b in pairs),
            "bits_identical": all(same_bits(a, b) for a, b in pairs + gpairs)}


def carry_inputs(cfg):
    """``cfg``'s model at full width with random weights from seed 0, and
    CARRY_BATCH rows of the first batch of SEQ tokens."""
    model = build_model(cfg)
    params = model.init(0, device=DEVICE, dtype=torch.float32)
    batch = {k: torch.as_tensor(v)[:CARRY_BATCH].to(DEVICE) for k, v in
             SyntheticTokens(cfg.vocab, SEQ, GLOBAL_BATCH, seed=0).batch(0).items()}
    return model, params, batch


def zamba_carry(cfg, gen) -> dict:
    """zamba2-1.2b's Mamba2 layers (each from its input in the whole
    sequence's forward) and its shared attention's applications, the
    sequence in two halves against the whole."""
    from repro_torch.models import layers as layers_model
    from repro_torch.models import ssm as ssm_model
    from repro_torch.models.transformer import unstack

    model, params, batch = carry_inputs(cfg)
    seen, calls = [], []
    with torch.no_grad(), mamba_inputs(seen), recorded(layers_model, "attention", calls):
        model.forward(params, batch)
    cut = CARRY_CUT

    def lp_of(lv):
        return _unflatten({k[3:]: v for k, v in lv.items() if k.startswith("lp/")})

    def whole_block(lv):
        out, state, conv = ssm_model.mamba2_block(cfg, lp_of(lv), lv["h"])
        return out[:, cut:], state, conv

    def block_halves(lv):
        lp = lp_of(lv)
        _, state, conv = ssm_model.mamba2_block(cfg, lp, lv["h"][:, :cut])
        return ssm_model.mamba2_block(cfg, lp, lv["h"][:, cut:], ssm_state=state,
                                      conv_state=conv)

    layers = [halves_against_whole(
        whole_block, block_halves,
        {**{f"lp/{k}": v for k, v in _flatten(lp)}, "h": h}, gen)
        for lp, h in zip(unstack(params["mamba"]), seen)]
    attention = []
    for (q, k, v), kw in calls:
        def whole_attention(lv, kw=kw):
            return (layers_model.attention(lv["q"], lv["k"], lv["v"], **kw)[:, cut:],)

        def attention_halves(lv, kw=kw):
            return (layers_model.attention(lv["q"][:, cut:], lv["k"], lv["v"],
                                           q_offset=cut, **kw),)

        attention.append(halves_against_whole(
            whole_attention, attention_halves, {"q": q, "k": k, "v": v}, gen))
    del model, params, seen, calls
    n, a = cfg.n_layers, len(attention)
    want = {SSD_FWD: n + 3 * n, SSD_BWD: 3 * n, FA_FWD: a + 2 * a,
            **{name: 2 * a for name in FA_BWD}}
    return {"mamba2_layers": layers, "attention": attention, "want": want}


def rwkv_carry(cfg, gen) -> dict:
    """rwkv6-7b's WKV in each layer (from its inputs in the whole sequence's
    forward), the sequence in two halves against the whole."""
    from repro_torch.models import rwkv as rwkv_model

    model, params, batch = carry_inputs(cfg)
    calls = []
    with torch.no_grad(), recorded(rwkv_model, "wkv6", calls):
        model.forward(params, batch)
    cut, names = CARRY_CUT, ("r", "k", "v", "logw")

    def whole(lv):
        y, final = rwkv_model.wkv6(*(lv[n] for n in names), lv["u"])
        return y[:, cut:], final

    def halves(lv):
        _, state = rwkv_model.wkv6(*(lv[n][:, :cut] for n in names), lv["u"])
        return rwkv_model.wkv6(*(lv[n][:, cut:] for n in names), lv["u"], state)

    layers = [halves_against_whole(whole, halves, dict(zip(names + ("u",), args[:5])),
                                   gen) for args, _ in calls]
    del model, params, calls
    n = cfg.n_layers
    return {"wkv_layers": layers, "want": {WKV_FWD: n + 3 * n, WKV_BWD: 3 * n}}


def state_carry_path() -> dict:
    """The sequence in two halves through every layer that carries state
    (CARRY_CUT's note): zamba2-1.2b's 38 Mamba2 layers and its shared
    attention, rwkv6-7b's WKV in RWKV_LAYERS layers; each within its
    limits, and B4's, B8's and B9's launches equal to the path's schedule
    (each half and the whole a forward and a backward, beside the forward
    that gave the layers' inputs), no other kernel launched."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)
    t0 = time.perf_counter()
    reset_all_launches()
    zamba = zamba_carry(get_arch(ZAMBA_ARCH), gen)
    free_cuda()
    rwkv = rwkv_carry(dataclasses.replace(get_arch(RWKV_ARCH), n_layers=RWKV_LAYERS),
                      gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = all_launches()
    want = {**zamba.pop("want"), **rwkv.pop("want")}
    mine = {k: v for k, v in launches.items() if k in want}
    others = {k: v for k, v in launches.items() if k not in want and v}
    parts = {"zamba2-1.2b mamba2_block": zamba["mamba2_layers"],
             "zamba2-1.2b shared attention": zamba["attention"],
             "rwkv6-7b wkv6": rwkv["wkv_layers"]}
    summary = {"cut": CARRY_CUT, "seq": SEQ, "batch": CARRY_BATCH,
               "seconds": seconds, "launches": mine}
    for what, rows in parts.items():
        summary[what] = {
            "calls": len(rows),
            "fwd_of_limit": max(r["fwd_of_limit"] for r in rows),
            "bwd_of_limit": max(r["bwd_of_limit"] for r in rows),
            "largest_gap": max(r["largest_gap"] for r in rows),
            "bits_identical": sum(r["bits_identical"] for r in rows)}
        log(f"state carry, {what} ({len(rows)} calls, {card_line()}): the second "
            f"half from the first's states against the whole, largest gap "
            f"{summary[what]['largest_gap']:.4g} of the largest value, shares of "
            f"the limits: forward {summary[what]['fwd_of_limit']:.4g}, gradients "
            f"{summary[what]['bwd_of_limit']:.4g}; bit-identical in "
            f"{summary[what]['bits_identical']} of {len(rows)}")
    fails = {what: [i for i, r in enumerate(rows) if not within(
        (r["fwd_of_limit"], r["bwd_of_limit"]))] for what, rows in parts.items()}
    if any(fails.values()) or mine != want or others:
        raise AssertionError(f"state carry: calls outside their limits {fails}; "
                             f"launches {mine} != schedule {want}, or others {others}")
    return {"launches": mine, "summary": summary}


# -- phase 8: GADGET's online loop --------------------------------------------

def ring_kernel_expected(rows, n_leaves: int) -> dict:
    """The int8 fused ring's launches over ``rows`` (one backend report a
    slot, none re-rung): per step at ring size w and per leaf, as
    ``expected_launches``; a ring of one sends nothing."""
    send, hop, last, unpack = MODE_KERNELS["compressed-fused"]
    out = dict.fromkeys(qr.LAUNCHES, 0)
    for row in rows:
        w = row["workers"]
        if row.get("re_rings"):
            raise AssertionError(f"the int8 job re-rang, which the loop does "
                                 f"not script: {row}")
        if w < 2:
            continue
        out[send] += row["steps"] * n_leaves * 2 * w
        out[hop] += row["steps"] * n_leaves * w * (w - 2)
        out[last] += row["steps"] * n_leaves * w
        out[unpack] += row["steps"] * n_leaves * w
    return out


def pdhg_against_highs() -> dict:
    """One slot of Algorithm 2 with the PDHG engine on the card against the
    HiGHS engine, on ``tests/test_theory.py``'s instance, which the
    reference holds within 25%."""
    from repro_torch.cluster import make_fat_tree
    from repro_torch.cluster.topology import ResourceState
    from repro_torch.cluster.trace import JobTraceConfig, generate_jobs
    from repro_torch.core.gvne import GvneConfig, solve_slot
    from repro_torch.core.problem import DDLJSInstance, ScheduleState

    graph = make_fat_tree(n_servers=6, n_racks=2, n_core=1, seed=3)
    jobs = generate_jobs(JobTraceConfig(n_jobs=6, horizon=5, seed=4))
    for j in jobs:
        j.arrival = 0
    state = ScheduleState(DDLJSInstance(graph=graph, jobs=jobs, horizon=5))
    out = {}
    for engine in ("highs", "pdhg"):
        t0 = time.perf_counter()
        r = solve_slot(ResourceState(graph), jobs, state,
                       GvneConfig(seed=0, lp_engine=engine))
        out[engine] = {"value": r.value, "lp_value": r.lp_value,
                       "seconds": time.perf_counter() - t0}
        for e in r.embeddings:
            e.validate_ring()
    log(f"solve_slot: {out}")
    if not out["pdhg"]["value"] >= 0.75 * out["highs"]["value"]:
        raise AssertionError(f"pdhg slot value {out['pdhg']['value']} below 75% "
                             f"of HiGHS's {out['highs']['value']}")
    return out


def gadget_loop() -> dict:
    """``repro_torch.launch.schedule_and_train`` on the card, with the
    launch counters set to 0 just before the driver's run and read just
    after; the example's checks, and every kernel's launches against the
    slots its jobs ran."""
    from repro_torch.launch import schedule_and_train as loop

    with tempfile.TemporaryDirectory(prefix="chip_smoke_loop_") as root:
        jobs = loop.make_jobs()
        bandwidths = {j.id: j.profile.bandwidth for j in jobs}
        trainers = loop.make_trainers(jobs, DEVICE, root)
        before = loop.heldout_losses(trainers)
        torch.cuda.synchronize()
        qr.reset_launches()
        fa.reset_launches()
        W.reset_launches()
        t0 = time.perf_counter()
        backend, result = loop.run_loop(jobs, trainers)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {**qr.LAUNCHES, **fa.LAUNCHES, **W.LAUNCHES}
        after = loop.heldout_losses(trainers)
        table = loop.slot_table(jobs, backend)
        outcome = loop.check_outcome(jobs, trainers, backend, result, bandwidths,
                                     {j: (before[j], after[j]) for j in before})
    for line in table + outcome:
        log(f"loop {line}")
    rows = {j.id: [r for r in backend.reports if r["job_id"] == j.id]
            for j in jobs}
    slot3 = [r for r in rows[0] if r["t"] == 3]
    if len(slot3) != 1 or slot3[0]["re_rings"] != 1 \
            or trainers[0].re_ring_events != 1:
        raise AssertionError(f"job 0's slot-3 ring did not re-ring once: {slot3}")
    worker_steps = {j: sum(r["worker_steps"] for r in rows[j]) for j in rows}
    layers = {j.id: trainers[j.id].model.cfg.n_layers for j in jobs}
    by_arch = {j.arch: j.id for j in jobs}
    rwkv, dense = by_arch["rwkv6-7b"], [by_arch["qwen3-0.6b"], by_arch["granite-3-2b"]]
    if any(trainers[j].model.cfg.remat for j in rows):
        raise AssertionError("the loop's reduced configs train without remat")
    want = {name: layers[rwkv] * worker_steps[rwkv] for name in W.LAUNCHES}
    want.update({name: sum(layers[j] * worker_steps[j] for j in dense)
                 for name in fa.LAUNCHES})
    int8_job = by_arch["granite-3-2b"]
    if trainers[int8_job].mode != "compressed-fused":
        raise AssertionError(f"job {int8_job} trains in {trainers[int8_job].mode}")
    n_leaves = len(leaf_sizes(next(iter(trainers[int8_job].params.values()))))
    want.update(ring_kernel_expected(rows[int8_job], n_leaves))
    if launches != want or not all(worker_steps.values()):
        raise AssertionError(f"loop launches {launches} != the jobs' slots "
                             f"{want} (worker steps {worker_steps})")
    for j in rows:
        if trainers[j].step != sum(r["steps"] for r in rows[j]):
            raise AssertionError(f"job {j}: {trainers[j].step} steps against "
                                 f"its reports {rows[j]}")
    log(f"loop: {seconds:.4f} s for {loop.SLOTS} slots; launches equal the "
        f"jobs' slots: {launches}; worker steps {worker_steps}")
    calibrated = {j.arch: [bandwidths[j.id], backend.calibrated.get(j.id)]
                  for j in jobs}
    return {"launches": launches, "summary": {
        "seconds": seconds, "slots": table, "outcome": outcome,
        "calibrated_bandwidth": calibrated, "worker_steps": worker_steps,
        "heldout": {j.arch: [before[j.id], after[j.id]] for j in jobs},
        "losses": {j.arch: trainers[j.id].losses for j in jobs},
        "re_rings": {j.arch: trainers[j.id].re_ring_events for j in jobs},
        "total_utility": result.total_utility,
        "solve_slot": pdhg_against_highs()}}


# -- phase 9: serving ----------------------------------------------------------

def timed_engine(engine) -> dict:
    """Wrap ``engine.admit`` and ``engine.step`` to add up their host
    seconds (each ends in a read of its result, so on the device's pace)
    and the tokens each handles, and to record the lane each request is
    admitted onto."""
    acc = {"prefill_s": 0.0, "prefill_tokens": 0, "decode_s": 0.0,
           "decode_tokens": 0, "lane_of": {}}
    admit, step = engine.admit, engine.step

    def timed_admit(limit=None):
        t0 = time.perf_counter()
        done = admit(limit)
        acc["prefill_s"] += time.perf_counter() - t0
        acc["prefill_tokens"] += sum(len(r.prompt) for r in done)
        for lane, req in enumerate(engine.lane_req):
            if req is not None:
                acc["lane_of"].setdefault(req.id, lane)
        return done

    def timed_step():
        n = int(engine.active.sum())
        t0 = time.perf_counter()
        done = step()
        acc["decode_s"] += time.perf_counter() - t0
        acc["decode_tokens"] += n
        return done

    engine.admit, engine.step = timed_admit, timed_step
    return acc


def check_engine(engine, n_requests: int, what: str) -> None:
    from repro_torch.launch.serve import audit_serving_engine

    problems = audit_serving_engine(engine)
    counts = (engine.compile_count, engine.prefill_compile_count,
              engine.aux_compile_count)
    if problems or counts != (1, 1, 1) or len(engine.finished) != n_requests:
        raise AssertionError(f"{what}: audit {problems}, captures {counts}, "
                             f"{len(engine.finished)} of {n_requests} served")


def encoder_cross_kv(model, params, frames):
    """An encoder-decoder's cross K and V of ``frames`` (B, F, D) for every
    decoder layer, as its cache lays them out: (layers, B, F, Hkv, hd)."""
    enc = model.encode(params, frames)
    blocks = params["dec_blocks"]
    return tuple(torch.stack([torch.einsum("bsd,dhk->bshk", enc, w)
                              for w in torch.unbind(blocks[name], 0)])
                 for name in ("xk", "xv"))


def held_against_forward(model, params, prompt, limit, what: str, *,
                         logits=None, frames=None, hold: bool = True) -> dict:
    """Logits at a prompt's last token against the port's training forward
    over the prompt (the ported kernels on the card), the forward's kernel
    launches counted. The logits are the engine's, given as ``logits``, or
    else decode's over the prompt at batch 1 through an f32 KV cache, an
    encoder-decoder's cross K/V those of ``frames`` (the engine leaves them
    at zero, as the reference's does). An MoE's forward is built at a
    capacity factor of E / k, where it drops no token, as decode never
    does. The gap is max |gap| over the largest logit, held within
    ``limit`` if ``hold``."""
    cfg = model.cfg
    fwd_model = model
    if cfg.family == "moe":
        fwd_model = build_model(dataclasses.replace(
            cfg, moe_capacity=cfg.n_experts / cfg.top_k))
    tokens = torch.as_tensor(prompt, device=DEVICE).long()[None]
    batch = {"tokens": tokens}
    if frames is not None:
        batch["frames"] = frames
    reset_all_launches()
    fwd = fwd_model.forward(params, batch)[0][0, -1]
    torch.cuda.synchronize()
    launches = {k: v for k, v in all_launches().items() if v}
    if logits is None:
        cache = init_from_specs(model.cache_specs(1, tokens.shape[1],
                                                  dtype=torch.float32), None, DEVICE)
        if frames is not None:
            cache["xk"], cache["xv"] = encoder_cross_kv(model, params, frames)
        for t in range(tokens.shape[1]):
            out, cache = model.decode_step(params, cache, tokens[:, t:t + 1], t)
        logits = out[0, -1]
    vocab = cfg.vocab     # the padded tail is -1e30 on both sides
    gap = rel_max(logits[:vocab], fwd[:vocab])
    if not math.isfinite(gap) or (hold and gap > limit):
        raise AssertionError(f"{what}: decode against the forward {gap:.4g} "
                             f"over its limit {limit:.4g}")
    return {"gap": gap, "limit": limit if hold else None, "launches": launches}


def held_against_oracle(model, params, req, kept, limit) -> dict:
    """Every generated step's logits of a request served by the engine
    against ``greedy_generate_reference`` (batch 1, token by token) on the
    card, while their tokens agree; the tokens must agree wherever the
    oracle's top-2 margin (over its largest |logit|) is above ``limit``
    (with ``limit`` infinite, the gaps are only returned)."""
    from repro_torch.launch.serve import greedy_generate_reference

    oracle = []
    out = greedy_generate_reference(model, params, req.prompt[None, :],
                                    req.max_new, SERVE_MAX_SEQ, logits=oracle)
    ref_tokens = out[0, len(req.prompt):].tolist()
    gaps, diverged = [], None
    vocab = model.cfg.vocab     # the padded tail is -1e30 on both sides
    for j, (got, want) in enumerate(zip(kept, oracle)):
        got, want = got[:vocab], want[0, :vocab]
        gaps.append(rel_max(got, want))
        if req.tokens[j] != ref_tokens[j]:
            top2 = torch.topk(want.float(), 2).values
            margin = float((top2[0] - top2[1]) / want.float().abs().max())
            diverged = {"step": j, "margin": margin}
            if margin > limit:
                raise AssertionError(f"request {req.id}: token {j} "
                                     f"{req.tokens[j]} != the oracle's "
                                     f"{ref_tokens[j]} at margin {margin:.4g}")
            break
    if len(kept) != req.max_new or len(oracle) != req.max_new \
            or not all(math.isfinite(g) and g <= limit for g in gaps):
        raise AssertionError(f"request {req.id}: engine against the oracle "
                             f"{gaps} (limit {limit:.4g}), {len(kept)} and "
                             f"{len(oracle)} steps")
    return {"steps_compared": len(gaps), "worst_gap": max(gaps),
            "diverged_at_a_tie": diverged}


def decode_device_ms(engine, model, params, prompt_len: int = SERVE_FULL_PROMPT
                     ) -> dict:
    """The decode step at full occupancy: every lane admitted with a fresh
    request of ``prompt_len`` tokens, one step run, then CUDA events over
    replays of its captured graph (each rewrites the same K/V: the
    attention cache is unchanged); beside its byte bound, the bytes the
    step must move: every weight but the embedding table once (its B rows;
    an MoE's every expert), each lane's K/V before its position once (and
    an encoder-decoder's whole cross K/V), the new K/V, the logits and
    tokens written."""
    from repro_torch.launch.serve import Request

    cfg = model.cfg
    rng = np.random.default_rng(2)
    for i in range(engine.max_batch):
        engine.submit(Request(id=1000 + i, prompt=rng.integers(
            0, cfg.vocab, size=prompt_len), max_new=SERVE_NEW))
    engine.admit()
    engine.step()
    if not engine.active.all():
        raise AssertionError("decode timing: not every lane is active")
    graph = engine.graphs()["decode"]
    ms = cuda_ms(graph.replay, samples=10, calls=10)
    b = engine.max_batch
    kv_token = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2   # bf16 K and V
    weights = sum(v.numel() * v.element_size()
                  for path, v in _flatten(params) if path != "embed")
    weights += b * cfg.d_model * 4
    # the replayed step is at each lane's position before the host advanced
    kv_read = int((engine.positions - 1).sum()) * kv_token
    if "xk" in engine.cache:
        kv_read += sum(engine.cache[k].numel() * engine.cache[k].element_size()
                       for k in ("xk", "xv"))
    written = b * kv_token + b * cfg.padded_vocab * 4 + b * 8
    nbytes = weights + kv_read + written
    return {"device_ms": ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bytes": nbytes, "weight_bytes": weights, "kv_read_bytes": kv_read,
            "positions": engine.positions.tolist()}


def same_on_fresh_engine(make_engine, engine, acc, req_id: int, filler) -> int:
    """Request ``req_id``, served by ``engine`` (``acc`` its
    ``timed_engine`` record) on a lane that another request held before,
    against the same request on a fresh engine from ``make_engine`` in the
    same lane (requests of ``filler``'s prompt with lower ids take the
    lanes below it: admission is by id): logits and tokens bit-identical.
    Returns the lane."""
    from repro_torch.launch.serve import Request, serve_requests

    served = next(r for r in engine.finished if r.id == req_id)
    lane = acc["lane_of"][req_id]
    reused = any(other == lane for i, other in acc["lane_of"].items() if i != req_id)
    fresh = make_engine()
    again = Request(id=req_id, prompt=served.prompt, max_new=served.max_new)
    fillers = [Request(id=-1 - i, prompt=filler, max_new=served.max_new)
               for i in range(lane)]
    fresh.keep_logits[req_id] = []
    fresh_acc = timed_engine(fresh)
    serve_requests(fresh, fillers + [again])
    a, b = engine.keep_logits[req_id], fresh.keep_logits[req_id]
    same = len(a) == len(b) == served.max_new and all(
        torch.equal(x, y) for x, y in zip(a, b))
    if not (reused and fresh_acc["lane_of"][req_id] == lane and same
            and again.tokens == served.tokens):
        raise AssertionError(f"{engine.arch}: request {req_id} on lane {lane} "
                             f"(reused: {reused}) differs from the same request "
                             f"on a fresh engine's lane "
                             f"{fresh_acc['lane_of'][req_id]}")
    return lane


def percentiles(xs) -> dict:
    return {"p50": float(np.percentile(xs, 50)), "p90": float(np.percentile(xs, 90))}


@torch.no_grad()
def serve_qwen3() -> dict:
    """qwen3-0.6b at full width and depth answers SERVE_REQUESTS staggered
    requests through ``ServingEngine``: every request served, a clean
    audit, each graph captured once, no ported kernel launched by decode;
    two requests held against the forward (F1) and the oracle."""
    from repro_torch.launch.serve import Request, ServingEngine, serve_requests

    cfg = get_arch(SERVE_ARCH)
    model = build_model(cfg)
    params = model.init(0, device=DEVICE, dtype=torch.float32)
    rng = np.random.default_rng(0)
    lens = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, size=SERVE_REQUESTS)
    reqs = [Request(id=i, prompt=rng.integers(0, cfg.vocab, size=int(n)),
                    max_new=SERVE_NEW, arrival=SERVE_STAGGER * i)
            for i, n in enumerate(lens)]
    held = sorted(range(SERVE_REQUESTS), key=lambda i: (lens[i], i))[:SERVE_HELD]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(model, params, max_batch=SERVE_BATCH,
                           max_seq=SERVE_MAX_SEQ, prefill_chunk=SERVE_CHUNK)
    for i in held:
        engine.keep_logits[i] = []
    acc = timed_engine(engine)
    reset_all_launches()
    t0 = time.perf_counter()
    serve_requests(engine, reqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    decode_launches = {k: v for k, v in all_launches().items() if v}
    check_engine(engine, SERVE_REQUESTS, "qwen3 serving")
    if decode_launches or any(len(r.tokens) != SERVE_NEW for r in reqs):
        raise AssertionError(f"qwen3 serving: kernels {decode_launches}, "
                             f"tokens {[len(r.tokens) for r in reqs]}")
    peak = torch.cuda.max_memory_allocated()
    rates = {"prefill_tokens_per_s": acc["prefill_tokens"] / acc["prefill_s"],
             "decode_tokens_per_s": acc["decode_tokens"] / acc["decode_s"],
             "prefill_tokens": acc["prefill_tokens"],
             "decode_tokens": acc["decode_tokens"]}
    limit = SERVE_REF_GAP[SERVE_ARCH] * SERVE_GAP_FACTOR
    forward, oracle = {}, {}
    launches: dict = {}
    t1 = time.perf_counter()
    for i in held:
        res = held_against_forward(model, params, reqs[i].prompt, limit,
                                   f"qwen3 request {i}",
                                   logits=engine.keep_logits[i][0])
        forward[i] = res["gap"]
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
        oracle[i] = held_against_oracle(model, params, reqs[i],
                                        engine.keep_logits[i], limit)
    if set(launches) != {FA_FWD} or launches[FA_FWD] != cfg.n_layers * SERVE_HELD:
        raise AssertionError(f"qwen3 forward checks launched {launches}")
    held_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    timing = decode_device_ms(engine, model, params)
    timing["seconds"] = time.perf_counter() - t1
    ticks = [r.ttft_clock for r in reqs]
    secs = [r.first_token_time - r.submit_time for r in reqs]
    out = {"arch": cfg.name, "params": n_params(model.param_specs()),
           "requests": SERVE_REQUESTS, "prompt_lens": lens.tolist(),
           "seconds": seconds, "held_checks_s": held_s, "clock": engine.clock,
           "decode_steps": engine.decode_steps, **rates,
           "ttft_ticks": percentiles(ticks), "ttft_s": percentiles(secs),
           "peak_gib": peak / 2**30, "decode_step": timing,
           "forward_gap": forward, "oracle": oracle, "limit": limit,
           "forward_launches": launches}
    log(f"serving qwen3-0.6b ({card_line()}): {SERVE_REQUESTS} requests in "
        f"{seconds:.4f} s; prefill {out['prefill_tokens_per_s']:.1f} tokens/s, "
        f"decode {out['decode_tokens_per_s']:.1f} tokens/s; TTFT ticks "
        f"{out['ttft_ticks']}, s {out['ttft_s']}; peak {out['peak_gib']:.4f} GiB")
    log(f"serving qwen3-0.6b decode step at {SERVE_BATCH} lanes: "
        f"{timing['device_ms']:.4f} ms on the device against its byte bound "
        f"{timing['bound_ms']:.4f} ms ({card_line()})")
    log(f"serving qwen3-0.6b held: decode against the forward {forward}, "
        f"against the oracle {oracle}, limit {limit:.4g} "
        f"({SERVE_GAP_FACTOR} x the reference's {SERVE_REF_GAP[SERVE_ARCH]})")
    del engine, params
    free_cuda()
    return {"launches": launches, "summary": out}


def serve_config(arch: str, n_layers=None, reduced: bool = False):
    """The config of ``arch`` (``MAMBA2``: zamba2-1.2b's with
    family="ssm"), reduced if asked, its depth cut to ``n_layers`` if
    given."""
    name, _, family = arch.partition("/")
    cfg = get_arch(name)
    if reduced:
        cfg = cfg.reduced()
    if family:
        cfg = dataclasses.replace(cfg, family=family)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg


def recurrent_prompts(vocab: int) -> list:
    """The prompts of ``serve_recurrent``'s requests (from seed 1)."""
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, size=int(rng.integers(
        RECURRENT_PROMPT[0], RECURRENT_PROMPT[1] + 1)))
        for _ in range(RECURRENT_REQUESTS)]


@torch.no_grad()
def serve_recurrent(arch: str, n_layers) -> dict:
    """``arch`` (depth cut to ``n_layers`` if given) serves
    RECURRENT_REQUESTS requests through RECURRENT_BATCH lanes, so that lanes
    are evicted, zeroed and reused; the last request admitted, on a reused
    lane, gives logits bit-identical to the same request on a fresh engine
    in the same lane; decode against the forward (held for rwkv6-7b,
    printed for zamba2-1.2b and Mamba2LM)."""
    from repro_torch.launch.serve import Request, ServingEngine, serve_requests

    cfg = serve_config(arch, n_layers)
    model = build_model(cfg)
    params = model.init(0, device=DEVICE, dtype=torch.float32)
    prompts = recurrent_prompts(cfg.vocab)
    reqs = [Request(id=i, prompt=p, max_new=RECURRENT_NEW)
            for i, p in enumerate(prompts)]
    last = reqs[-1].id

    def make_engine():
        return ServingEngine(model, params, max_batch=RECURRENT_BATCH,
                             max_seq=SERVE_MAX_SEQ, prefill_chunk=SERVE_CHUNK)

    engine = make_engine()
    engine.keep_logits[0] = []
    engine.keep_logits[last] = []
    acc = timed_engine(engine)
    reset_all_launches()
    t0 = time.perf_counter()
    serve_requests(engine, reqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    decode_launches = {k: v for k, v in all_launches().items() if v}
    check_engine(engine, RECURRENT_REQUESTS, f"{arch} serving")
    if decode_launches:
        raise AssertionError(f"{arch}: kernels {decode_launches}")
    lane = same_on_fresh_engine(make_engine, engine, acc, last, prompts[0])
    ref_gap = SERVE_REF_GAP[arch]
    hold = arch in HELD_RECURRENT
    limit = ref_gap * SERVE_GAP_FACTOR
    fwd = held_against_forward(model, params, prompts[0], limit, arch,
                               logits=engine.keep_logits[0][0], hold=hold)
    out = {"arch": arch, "n_layers": cfg.n_layers,
           "params": n_params(model.param_specs()),
           "prompt_lens": [len(p) for p in prompts], "seconds": seconds,
           "lanes": acc["lane_of"], "reused_lane": lane,
           "bit_identical_on_reused_lane": True,
           "prefill_tokens_per_s": acc["prefill_tokens"] / acc["prefill_s"],
           "decode_tokens_per_s": acc["decode_tokens"] / acc["decode_s"],
           "forward_gap": fwd["gap"], "reference_gap": ref_gap,
           "held": hold, "limit": limit if hold else None,
           "forward_launches": fwd["launches"]}
    if hold:
        note = f"held to {limit:.4g}"
    elif arch == MAMBA2:
        note = (f"printed; the reference's own gap at reduced size is "
                f"{ref_gap}, and reduced Mamba2LM is held to {limit:.4g} "
                f"(decode_steps_on_cpu)")
    else:
        note = (f"not held: at random init this model turns any f32 "
                f"reordering into logit gaps of this size; the reference's "
                f"own gap at reduced size is {ref_gap}")
    log(f"serving {arch} ({cfg.n_layers} layers, {card_line()}): "
        f"{RECURRENT_REQUESTS} requests on {RECURRENT_BATCH} lanes in "
        f"{seconds:.4f} s, lanes {acc['lane_of']}; request {last} on reused "
        f"lane {lane} bit-identical to a fresh engine's; decode against the "
        f"forward {fwd['gap']:.4g} ({note}); forward launched {fwd['launches']}")
    del engine, params
    free_cuda()
    return {"launches": fwd["launches"], "summary": out}


def step_against_cpu(card: dict, cpu32: dict, cpu64: dict, reduced: bool) -> dict:
    """One decode step's logits and cache leaves (``"logits"``, the cache's
    keys and at full width the new K and V, each on the CPU) from the card
    against the CPU's f32 and f64 steps from the same cache. Returns per key
    its largest share of its limit (``share``, over 1 fails) and the gaps
    behind it: max |card - f64|, |CPU f32 - f64|, |card - CPU f32|, the
    largest |f64|, and for a leaf stacked over layers each layer's max
    |card - f64| and |CPU f32 - f64|."""
    out = {}
    for k, got in card.items():
        if all(w.dtype == got.dtype and torch.equal(w, got)
               for w in (cpu32[k], cpu64[k])):
            # all three the same bits (a bf16 cache leaf at full width,
            # where the CPU steps store the card's new K and V)
            out[k] = {"share": 0.0, "dtype": str(got.dtype).replace("torch.", ""),
                      "card_f64": 0.0, "cpu_f64": 0.0, "card_cpu": 0.0,
                      "max_f64": float(got.abs().max())}
            continue
        bf16 = got.dtype == torch.bfloat16
        got, want32, want64 = (t.double() for t in (got, cpu32[k], cpu64[k]))
        card_f64, cpu_f64 = (got - want64).abs(), (want32 - want64).abs()
        gaps = {"dtype": str(card[k].dtype).replace("torch.", ""),
                "card_f64": float(card_f64.max()),
                "cpu_f64": float(cpu_f64.max()),
                "card_cpu": float((got - want32).abs().max()),
                "max_f64": float(want64.abs().max())}
        if k != "logits":
            gaps["by_layer"] = list(zip(card_f64.flatten(1).amax(1).tolist(),
                                        cpu_f64.flatten(1).amax(1).tolist()))
        if reduced:
            scale, gap, ref = float(want32.abs().max()), (got - want32).abs(), want32
            base = (STEP_LOGITS_REL if k == "logits" else STEP_CACHE_REL) * scale
        else:
            scale, gap, ref = gaps["max_f64"], card_f64, want64
            base = gaps["cpu_f64"] + STEP_F64_REL * scale
        allowed = base + (BF16_ROUNDING * ref.abs() if bf16 else 0.0)
        if not bool(torch.isfinite(got).all()):
            share = math.inf
        elif scale == 0:
            share = 0.0 if float(gap.max()) == 0 else math.inf
        else:
            share = float((gap / allowed).max())
        out[k] = {"share": share, **gaps}
    return out


@contextlib.contextmanager
def mamba_inputs(seen: list):
    """While active, every Mamba2 layer of the hybrid's decode step
    (``mamba2_block`` in ``models/ssm.py``) appends its input ``h`` to
    ``seen``."""
    from repro_torch.models import ssm

    block = ssm.mamba2_block

    def recorded(cfg, lp, h, **kw):
        seen.append(h.clone())
        return block(cfg, lp, h, **kw)

    ssm.mamba2_block = recorded
    try:
        yield
    finally:
        ssm.mamba2_block = block


@contextlib.contextmanager
def forced_from_card(card: dict, own: dict):
    """While active, the hybrid's decode step (``models/ssm.py``) runs from
    the card's values: each Mamba2 layer takes the card's input
    (``card["h"]``, one a layer, in order) in place of the one it computed,
    and the shared attention's ``write_kv`` stores at the lane's slot what
    the card stored there (``card["k"]``, ``card["v"]``: the lane's cache
    after the card's step, one entry an application, K before V). ``own``
    collects what the step computed itself: ``"h"``, each layer's input
    before it was replaced, and ``"k_new"``/``"v_new"``, each new K and V
    before rounding."""
    from repro_torch.models import ssm

    block, write = ssm.mamba2_block, ssm.write_kv
    own.update(h=[], k_new=[], v_new=[])

    def forced(cfg, lp, h, **kw):
        own["h"].append(h)
        return block(cfg, lp, card["h"][len(own["h"]) - 1].to(h.dtype), **kw)

    def shared(cache_l, slots, new, active):
        gi, leaf = divmod(len(own["k_new"]) + len(own["v_new"]), 2)
        key = ("k", "v")[leaf]
        write(cache_l, slots, new, active)
        cache_l[slots] = card[key][gi][slots]
        own[key + "_new"].append(new[:, 0])

    ssm.mamba2_block, ssm.write_kv = forced, shared
    try:
        yield
    finally:
        ssm.mamba2_block, ssm.write_kv = block, write


@contextlib.contextmanager
def f32_casts_in_f64():
    """While active, ``Tensor.float()`` gives f64 and ``Tensor.to`` with
    float32 gives f64: the model's decode casts to f32 where it computes in
    f32, and under this it computes there in f64 (its constants built in
    f32, such as the RoPE frequencies, keep their f32 values)."""
    float_, to_ = torch.Tensor.float, torch.Tensor.to

    def to_f64(t, *args, **kw):
        args = tuple(torch.float64 if a is torch.float32 else a for a in args)
        if kw.get("dtype") is torch.float32:
            kw["dtype"] = torch.float64
        return to_(t, *args, **kw)

    torch.Tensor.float, torch.Tensor.to = torch.Tensor.double, to_f64
    try:
        yield
    finally:
        torch.Tensor.float, torch.Tensor.to = float_, to_


@torch.no_grad()
def decode_steps_on_cpu(arch: str, reduced: bool) -> dict:
    """Request 0 of ``serve_recurrent`` (its prompt modulo a reduced vocab)
    alone on a fresh engine of RECURRENT_BATCH lanes on the card; at each
    of its decode steps the lane's cache before the step and the weights go
    to the CPU, where the same ``decode_step_lanes`` runs in f32 and in
    f64, and the card's logits and lane cache after the step are held
    against them (``step_against_cpu``). Full-width zamba2's CPU steps are
    teacher-forced (``forced_from_card``) from an eager rerun of the card's
    step, and each Mamba2 layer's input and the new K and V are held too.
    Reduced Mamba2LM's decode against its forward (S1 on the card) is held
    within SERVE_GAP_FACTOR times the reference's gap."""
    from repro_torch.launch.serve import Request, ServingEngine, serve_requests
    from repro_torch.models.model import cache_lane

    cfg = serve_config(arch, reduced=reduced)
    model = build_model(cfg)
    params = model.init(0, device=DEVICE, dtype=torch.float32)
    prompt = recurrent_prompts(serve_config(arch).vocab)[0] % cfg.vocab
    engine = ServingEngine(model, params, max_batch=RECURRENT_BATCH,
                           max_seq=SERVE_MAX_SEQ, prefill_chunk=SERVE_CHUNK)
    engine.keep_logits[0] = []
    t0 = time.perf_counter()
    cpu32 = tree_map(lambda t: t.to("cpu", copy=True), params)
    cpu64 = tree_map(lambda t: t.double() if t.is_floating_point() else t, cpu32)
    copy_s = time.perf_counter() - t0
    decode = engine._decode
    steps, cpu_s = [], [0.0]

    def checked(tokens, positions, active):
        lane = next(i for i, r in enumerate(engine.lane_req)
                    if r is not None and r.id == 0)
        before = {k: v.to("cpu") for k, v in cache_lane(engine.cache, lane).items()}
        forced = not reduced and "k" in before
        if forced:
            eager_cache = {k: v.clone() for k, v in engine.cache.items()}
        nxt, logits = decode(tokens, positions, active)
        card = {k: v.to("cpu") for k, v in cache_lane(engine.cache, lane).items()}
        card["logits"] = logits[lane].to("cpu")
        one = [x[lane:lane + 1].to("cpu") for x in (tokens, positions, active)]
        if forced:
            # the same step again, eagerly, for each Mamba2 layer's input
            seen = []
            with mamba_inputs(seen):
                out, new = model.decode_step_lanes(params, eager_cache, tokens,
                                                   positions, active)
            if not (same_bits(out[:, -1], logits) and all(
                    same_bits(new[k], engine.cache[k]) for k in new)):
                raise AssertionError(f"{arch}: the eager decode step is not "
                                     f"the engine's captured one")
            card["h"] = torch.stack([h[lane:lane + 1] for h in seen]).to("cpu")
            slot = min(int(one[1]), engine.max_seq - 1)
            card["k_new"], card["v_new"] = card["k"][:, :, slot], card["v"][:, :, slot]
            del eager_cache, out, new, seen

        def step(params, cache):
            own = {}
            with forced_from_card(card, own) if forced else contextlib.nullcontext():
                out, new = model.decode_step_lanes(params, cache, *one)
            run = {"logits": out[0, -1], **new}
            run.update({k: torch.stack(v) for k, v in own.items()})
            return run

        t1 = time.perf_counter()
        run32 = step(cpu32, {k: v.clone() for k, v in before.items()})
        with f32_casts_in_f64():
            # the same step in f64: f32 leaves in f64, bf16 leaves (the K/V
            # cache) stored in bf16 as the step stores them
            run64 = step(cpu64, {
                k: v.double() if v.dtype == torch.float32 else v.clone()
                for k, v in before.items()})
        if run64["logits"].dtype != torch.float64:
            raise AssertionError(f"{arch}: the f64 step gave "
                                 f"{run64['logits'].dtype} logits")
        cpu_s[0] += time.perf_counter() - t1
        steps.append(step_against_cpu(card, run32, run64, reduced))
        return nxt, logits

    engine._decode = checked
    new = RECURRENT_NEW if reduced else STEP_FULL_NEW
    t0 = time.perf_counter()
    serve_requests(engine, [Request(id=0, prompt=prompt, max_new=new)])
    seconds = time.perf_counter() - t0
    # per key, the step where it comes nearest its limit
    at_worst = {k: max(((i, st[k]) for i, st in enumerate(steps)),
                       key=lambda x: x[1]["share"]) for k in steps[0]}
    worst = {k: v["share"] for k, (_, v) in at_worst.items()}
    what = f"{arch}{' reduced' if reduced else ''}"
    out = {"arch": arch, "reduced": reduced, "steps": len(steps),
           "worst_share_of_limit": worst, "seconds": seconds,
           "cpu_steps_s": cpu_s[0], "weights_to_cpu_s": copy_s,
           "at_worst": {k: {"step": i, **{g: v for g, v in d.items()
                                          if g != "by_layer"}}
                        for k, (i, d) in at_worst.items()}}
    log(f"serving {what}: gaps at each key's worst step {json.dumps(out['at_worst'])}")
    for k, (i, d) in at_worst.items():
        if "by_layer" in d:
            log(f"serving {what}: {k} at step {i}, each layer's max |card - "
                f"f64| and |CPU f32 - f64|: {d['by_layer']}")
    if len(steps) != new - 1 or not all(
            math.isfinite(v) and v <= 1.0 for v in worst.values()):
        raise AssertionError(f"{what}: {len(steps)} decode steps against the "
                             f"CPU, worst share of each limit {worst}")
    if reduced and arch == MAMBA2:
        limit = SERVE_GAP_FACTOR * SERVE_REF_GAP[MAMBA2]
        fwd = held_against_forward(model, params, prompt, limit, what,
                                   logits=engine.keep_logits[0][0])
        out["forward_gap"], out["forward_limit"] = fwd["gap"], limit
        out["forward_launches"] = fwd["launches"]
    log(f"serving {what} ({card_line()}): each of request 0's {len(steps)} "
        f"decode steps on the card against the same step on the CPU (f32, "
        f"f64) from the card's cache"
        + ("" if reduced or arch == MAMBA2 else ", each Mamba2 layer from the "
           "card's input and the card's new K and V stored")
        + f": worst share of its limit {worst}; {seconds:.4f} s "
        f"({cpu_s[0]:.4f} s of CPU steps)"
        + (f"; decode against the forward {out['forward_gap']:.4g} (limit "
           f"{out['forward_limit']:.4g})" if "forward_gap" in out else ""))
    del engine, params, cpu32, cpu64
    free_cuda()
    return out


def serve_job_instance(device: str):
    """``tests/test_serving.py::_co_setup``: a training job and a serve job
    whose requests burst from slot 6, horizon 16, on 2 servers of 2 GPUs;
    the serve job's engine on ``device`` (reduced qwen3-0.6b, f32 weights
    from seed 0) and the analytic inner backend."""
    from repro_torch.cluster.topology import Link, Server, SubstrateGraph
    from repro_torch.core.problem import DDLJSInstance, Job
    from repro_torch.core.utility import sqrt_utility
    from repro_torch.launch.serve import ServingEngine
    from repro_torch import sched

    model = build_model(get_arch(SERVE_ARCH).reduced())
    params = model.init(0, device=device, dtype=torch.float32)
    servers = [Server(i, 0, {"gpus": 2.0, "mem": 8.0}) for i in range(2)]
    links = []
    for s in servers:
        links += [Link(s.node, "r0", 100.0), Link("r0", s.node, 100.0)]
    graph = SubstrateGraph(servers, links, n_racks=1, n_core=0)
    train = Job(id=0, arrival=0, max_workers=4,
                demands={"gpus": 1.0, "mem": 1.0}, budgets={"gpus": 500.0},
                bandwidth=5.0, zeta=1.0, utility=sqrt_utility(4.0))
    slo = sched.ServeSLO(ttft_slots=2, tpot_slots=1.0, weight=80.0)
    job = sched.make_serve_job(1, arrival=CO_BURST, offered_tokens=800.0,
                               slo=slo, tokens_per_worker_slot=64.0,
                               max_workers=3, bandwidth=5.0)
    inst = DDLJSInstance(graph=graph, jobs=[train, job], horizon=CO_HORIZON)
    engine = ServingEngine(model, params, max_batch=4, max_seq=32,
                           prefill_chunk=4)
    stream = sched.DiurnalRequestStream(sched.RequestStreamConfig(
        job_id=1, start=CO_BURST, base_rate=2.0, burst_prob=0.6,
        burst_size=4, prompt_len=(4, 8), max_new=(3, 6), seed=7))
    backend = sched.ServingBackend({1: engine}, tokens_per_worker_slot=64.0)
    return inst, stream, backend, engine, slo


@torch.no_grad()
def serve_in_gadget() -> dict:
    """GADGET with a serve job whose engine is on the card, the sanitizer
    checking SLO attainment against the event log every slot: the burst
    takes workers from the training ring and hands them back, the engine's
    decode step is captured once, and the event log equals the same run's
    with the engine on the CPU."""
    from repro_torch import sched

    logs = {}
    for device in (DEVICE, "cpu"):
        inst, stream, backend, engine, slo = serve_job_instance(device)
        t0 = time.perf_counter()
        res = sched.OnlineDriver(inst, events=stream, backend=backend,
                                 sanitize=True).run("gadget")
        seconds = time.perf_counter() - t0
        logs[device] = [dataclasses.astuple(e) + (type(e).__name__,)
                        for e in res.events]
        if device == DEVICE:
            card_res, card_engine, card_s = res, engine, seconds
            attainment = sched.slo_attainment_from_events(res.events, 1, slo)
            reported = backend.reports[-1]["slo_attainment"]
    per = {0: [0] * CO_HORIZON, 1: [0] * CO_HORIZON}
    for e in card_res.events:
        if isinstance(e, sched.EmbeddingCommitted):
            per[e.job_id][e.t] += e.n_workers
    burst = range(CO_BURST, CO_HORIZON)
    ok = (all(per[0][t] == 4 and per[1][t] == 0 for t in range(CO_BURST))
          and min(per[0][t] for t in burst) <= 2
          and max(per[1][t] for t in burst) >= 2 and per[0][-1] == 4
          and card_engine.compile_count == 1 and reported == attainment
          and logs[DEVICE] == logs["cpu"])
    if not ok:
        raise AssertionError(f"GADGET with a serve job: workers {per}, decode "
                             f"captures {card_engine.compile_count}, attainment "
                             f"{reported} against the log's {attainment}, event "
                             f"log equal to the CPU's: {logs[DEVICE] == logs['cpu']}")
    log(f"serving in GADGET's loop ({card_line()}): training workers a slot "
        f"{per[0]}, serve workers {per[1]}; SLO attainment {attainment} (the "
        f"sanitizer re-derived it every slot); {len(card_res.events)} events, "
        f"the CPU run's; {card_s:.4f} s; decode captured "
        f"{card_engine.compile_count}x over {card_engine.decode_steps} steps")
    return {"workers": per, "slo_attainment": attainment, "seconds": card_s,
            "decode_steps": card_engine.decode_steps}


def f32_cache_model(cfg):
    """``cfg``'s model whose zero cache, the engine's and the oracle's, is
    f32 where its specs give bf16."""
    model = build_model(cfg)
    model.init_cache = lambda b, max_seq, device: init_from_specs(
        model.cache_specs(b, max_seq, dtype=torch.float32), None, device)
    return model


def engine_against_oracle(model, params, reqs, ids, limit) -> dict:
    """Copies of ``reqs`` served by a fresh ``ServingEngine(max_batch=
    SERVE_BATCH, max_seq=SERVE_MAX_SEQ, prefill_chunk=SERVE_CHUNK)``, each
    request of ``ids`` then against the per-lane oracle
    (``held_against_oracle`` at ``limit``)."""
    from repro_torch.launch.serve import Request, ServingEngine, serve_requests

    engine = ServingEngine(model, params, max_batch=SERVE_BATCH,
                           max_seq=SERVE_MAX_SEQ, prefill_chunk=SERVE_CHUNK)
    copies = {r.id: Request(id=r.id, prompt=r.prompt, max_new=r.max_new,
                            arrival=r.arrival) for r in reqs}
    for i in ids:
        engine.keep_logits[i] = []
    serve_requests(engine, list(copies.values()))
    check_engine(engine, len(reqs), f"{model.cfg.name} (f32 cache) serving")
    return {i: held_against_oracle(model, params, copies[i], engine.keep_logits[i],
                                   limit) for i in ids}


def oracle_across_batch(model, params, req) -> dict:
    """The per-lane oracle with ``req``'s prompt in each of SERVE_BATCH
    rows, its first row against the oracle at batch 1 (printed): how far
    the model moves between products of 8 rows and of 1, the engine's
    decode step and its batch-1 prefill, with no engine code in between."""
    from repro_torch.launch.serve import Request, greedy_generate_reference

    logits = []
    prompts = np.repeat(req.prompt[None, :], SERVE_BATCH, axis=0)
    out = greedy_generate_reference(model, params, prompts, req.max_new,
                                    SERVE_MAX_SEQ, logits=logits)
    row = Request(id=req.id, prompt=req.prompt, max_new=req.max_new,
                  tokens=out[0, len(req.prompt):].tolist())
    return held_against_oracle(model, params, row, [x[0] for x in logits],
                               math.inf)


@torch.no_grad()
def serve_family(arch: str, n_layers) -> dict:
    """``arch`` (depth cut to ``n_layers`` if given) answers FAMILY_REQUESTS
    staggered requests through ``ServingEngine(max_batch=SERVE_BATCH,
    max_seq=SERVE_MAX_SEQ, prefill_chunk=SERVE_CHUNK)``: every request
    served, a clean audit, each graph captured once, no ported kernel
    launched by decode. Each lane is its own request's, as the reference's
    engine makes it by running its one-lane step under ``vmap``: every
    step of every request is bit-identical to the same request served by a
    fresh engine with the arrivals reversed (other lanes, other
    neighbours), and one more request on a reused lane to the same request
    alone on a fresh engine. Against the per-lane oracle (the request alone
    at batch 1, token by token): the reduced config, every step of every
    request through an engine with an f32 cache, held within
    SERVE_GAP_FACTOR times the reference's own f32-cache gap; at full
    width, the SERVE_HELD shortest requests printed, with the bf16 cache
    and with an f32 one on both sides, beside the oracle's own gap between
    batch 8 and batch 1. Decode through an f32 cache against
    the forward: held at reduced size within the same limit, printed at
    full width. Tokens/s, TTFT and the decode step's device ms."""
    from repro_torch.launch.serve import Request, ServingEngine, serve_requests

    cfg = get_arch(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg)
    params = model.init(0, device=DEVICE, dtype=torch.float32)
    rng = np.random.default_rng(3)
    lens = rng.integers(FAMILY_PROMPT[0], FAMILY_PROMPT[1] + 1,
                        size=FAMILY_REQUESTS)
    reqs = [Request(id=i, prompt=rng.integers(0, cfg.vocab, size=int(n)),
                    max_new=FAMILY_NEW, arrival=SERVE_STAGGER * i)
            for i, n in enumerate(lens)]
    n = FAMILY_REQUESTS
    held = sorted(range(n), key=lambda i: (lens[i], i))[:SERVE_HELD]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def make_engine():
        return ServingEngine(model, params, max_batch=SERVE_BATCH,
                             max_seq=SERVE_MAX_SEQ, prefill_chunk=SERVE_CHUNK)

    engine = make_engine()
    for r in reqs:
        engine.keep_logits[r.id] = []
    acc = timed_engine(engine)
    reset_all_launches()
    t0 = time.perf_counter()
    serve_requests(engine, reqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    decode_launches = {k: v for k, v in all_launches().items() if v}
    check_engine(engine, n, f"{arch} serving")
    if decode_launches or any(len(r.tokens) != FAMILY_NEW for r in reqs):
        raise AssertionError(f"{arch} serving: kernels {decode_launches}, "
                             f"tokens {[len(r.tokens) for r in reqs]}")
    peak = torch.cuda.max_memory_allocated()
    rates = {"prefill_tokens_per_s": acc["prefill_tokens"] / acc["prefill_s"],
             "decode_tokens_per_s": acc["decode_tokens"] / acc["decode_s"]}
    t1 = time.perf_counter()
    oracle = {i: held_against_oracle(model, params, reqs[i], engine.keep_logits[i],
                                     math.inf)["worst_gap"] for i in held}
    oracle_s = time.perf_counter() - t1
    # the same requests on a fresh engine, arriving in the reverse order
    swapped = [Request(id=r.id, prompt=r.prompt, max_new=FAMILY_NEW,
                       arrival=SERVE_STAGGER * (n - 1 - r.id)) for r in reqs]
    other = make_engine()
    for r in swapped:
        other.keep_logits[r.id] = []
    other_acc = timed_engine(other)
    serve_requests(other, swapped)
    moved = sum(other_acc["lane_of"][r.id] != acc["lane_of"][r.id] for r in reqs)
    differ = [r.id for r, o in zip(reqs, swapped)
              if r.tokens != o.tokens or not all(
                  torch.equal(x, y) for x, y in zip(engine.keep_logits[r.id],
                                                   other.keep_logits[r.id]))]
    if differ or not moved:
        raise AssertionError(f"{arch}: requests {differ} differ on a fresh engine "
                             f"with the arrivals reversed ({moved} moved lanes)")
    del other
    # one more request once every lane is free: admitted onto lane 0, which
    # served a request before
    again = Request(id=n, prompt=reqs[-1].prompt, max_new=FAMILY_NEW)
    engine.keep_logits[again.id] = []
    serve_requests(engine, [again])
    lane = same_on_fresh_engine(make_engine, engine, acc, again.id, reqs[0].prompt)
    free_cuda()
    model32 = f32_cache_model(cfg)
    oracle_f32 = {i: o["worst_gap"] for i, o in engine_against_oracle(
        model32, params, reqs, held, math.inf).items()}
    across_batch = {i: oracle_across_batch(model32, params, reqs[i])["worst_gap"]
                    for i in held}
    shortest = reqs[held[0]].prompt
    frames = (stub_batch(cfg, 1, 1)["frames"].to(DEVICE)
              if cfg.family == "encdec" else None)
    forward = held_against_forward(model, params, shortest, math.inf, arch,
                                   frames=frames, hold=False)
    # the reduced config, its prompts those of the full one modulo its vocab
    small_cfg = get_arch(arch).reduced()
    small = f32_cache_model(small_cfg)
    small_params = small.init(0, device=DEVICE, dtype=torch.float32)
    limit = SERVE_GAP_FACTOR * SERVE_REF_GAP_F32_CACHE[arch]
    small_reqs = [Request(id=r.id, prompt=r.prompt % small_cfg.vocab,
                          max_new=FAMILY_NEW, arrival=r.arrival) for r in reqs]
    small_oracle = engine_against_oracle(small, small_params, small_reqs,
                                         range(n), limit)
    small_frames = (stub_batch(small_cfg, 1, 1)["frames"].to(DEVICE)
                    if frames is not None else None)
    small_forward = held_against_forward(small, small_params,
                                         shortest % small_cfg.vocab, limit,
                                         small_cfg.name, frames=small_frames)
    launches = dict(forward["launches"])
    for k, v in small_forward["launches"].items():
        launches[k] = launches.get(k, 0) + v
    del small_params
    free_cuda()
    timing = decode_device_ms(engine, model, params, FAMILY_TIMED_PROMPT)
    ticks = [r.ttft_clock for r in reqs]
    secs = [r.first_token_time - r.submit_time for r in reqs]
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "params": n_params(model.param_specs()), "requests": n,
           "prompt_lens": lens.tolist(), "seconds": seconds,
           "oracle_checks_s": oracle_s, "decode_steps": engine.decode_steps,
           **rates, "ttft_ticks": percentiles(ticks), "ttft_s": percentiles(secs),
           "peak_gib": peak / 2**30, "decode_step": timing,
           "oracle_bf16_cache": oracle, "oracle_f32_cache": oracle_f32,
           "oracle_f32_batch_8_vs_1": across_batch,
           "bit_identical_reversed_arrivals": True, "lanes_moved": moved,
           "reused_lane": lane, "bit_identical_on_reused_lane": True,
           "forward_gap": forward["gap"],
           "reduced": {"limit": limit, "forward_gap": small_forward["gap"],
                       "oracle": small_oracle}}
    log(f"serving {arch} ({cfg.n_layers} layers, {out['params']} params, "
        f"{card_line()}): {n} requests in {seconds:.4f} s; "
        f"prefill {rates['prefill_tokens_per_s']:.1f} tokens/s, decode "
        f"{rates['decode_tokens_per_s']:.1f} tokens/s; TTFT ticks "
        f"{out['ttft_ticks']}, s {out['ttft_s']}; peak {out['peak_gib']:.4f} "
        f"GiB; decode step {timing['device_ms']:.4f} ms on the device against "
        f"its byte bound {timing['bound_ms']:.4f} ms")
    log(f"serving {arch}: every request bit-identical on a fresh engine with "
        f"the arrivals reversed ({moved} of {n} on other lanes); request "
        f"{again.id} on reused lane {lane} bit-identical to a fresh engine's; "
        f"{small_cfg.name} held within {limit:.4g}: every step of its {n} "
        f"requests (f32 cache) against the per-lane oracle {small_oracle}, "
        f"decode against the forward {small_forward['gap']:.4g}; printed at "
        f"full width: against the per-lane oracle with a bf16 cache {oracle}, "
        f"with an f32 one {oracle_f32}, the oracle (f32 cache) at batch "
        f"{SERVE_BATCH} against itself at batch 1 {across_batch}, decode (f32 "
        f"cache) against the forward {forward['gap']:.4g}")
    del engine, params
    free_cuda()
    return {"launches": launches, "summary": out}


def serving_path() -> dict:
    """Phase 9: qwen3-0.6b, then zamba2-1.2b and rwkv6-7b, then
    phi3.5-moe-42b and whisper-large-v3, then GADGET."""
    t0 = time.perf_counter()
    parts = {}   # each part's wall seconds, everything in it included

    def part(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        parts[name] = time.perf_counter() - t
        return res

    qwen = part("qwen3", serve_qwen3)
    launches = dict(qwen["launches"])
    summary = {"qwen3": qwen["summary"]}
    runs = [(arch, serve_recurrent, layers) for arch, layers in RECURRENT_SERVE.items()]
    runs += [(arch, serve_family, layers) for arch, layers in FAMILY_SERVE.items()]
    for arch, serve, layers in runs:
        res = part(arch, serve, arch, layers)
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
        summary[arch] = res["summary"]
    summary["per_step_on_cpu"] = []
    for arch in STEP_CHECKED:
        for reduced in (True, False):
            res = part(f"{arch} steps on the CPU{' reduced' if reduced else ''}",
                       decode_steps_on_cpu, arch, reduced)
            for k, v in res.pop("forward_launches", {}).items():
                launches[k] = launches.get(k, 0) + v
            summary["per_step_on_cpu"].append(res)
    summary["gadget"] = part("gadget", serve_in_gadget)
    summary["part_seconds"] = parts
    summary["seconds"] = time.perf_counter() - t0
    log(f"serving: phase 9 took {summary['seconds']:.3f} s: {json.dumps(parts)}")
    return {"launches": launches, "summary": summary}


# -- phase 10: the MoE path ---------------------------------------------------

def moe_reduction_against_f32(model, trainer, data, mode: str) -> dict:
    """One step's gradients of every rank at w=4 (the trainer's weights,
    its next batch), each leaf reduced by the mode's collective: every
    rank's result bit-identical, and within the reference's limit of the
    f32 ring's sum; leaf by leaf, so that one leaf's w inputs and outputs
    are live at a time. Also the seconds of the mode's reduction of all
    leaves, each leaf's call between two device syncs."""
    batch = {k: torch.as_tensor(v) for k, v in data.batch(trainer.step).items()}
    devices = trainer.group.devices[:4]
    ring = LocalRing(devices)
    _, grads = rank_grads(model, trainer.params, shard_batch(batch, devices),
                          devices)
    worst, worst_path, ring_s = 0.0, None, 0.0
    for path in list(grads[0]):
        ins = [g.pop(path) for g in grads]
        seconds, _, got = synced_s(lambda: LEAF_COLLECTIVES[mode](ins, ring))
        ring_s += seconds
        if not all(same_bits(got[0], x) for x in got[1:]):
            raise AssertionError(f"{mode} {path}: ranks disagree")
        exact = ring_all_reduce(ins, ring)[0]
        rel = float((got[0] - exact).abs().max() / (exact.abs().max() + 1e-30))
        if not rel < REL_LIMIT[mode]:
            raise AssertionError(f"{mode} {path}: rel err {rel} >= {REL_LIMIT[mode]}")
        if rel >= worst:
            worst, worst_path = rel, path
        del ins, got, exact
    return {"worst_leaf_rel": worst, "worst_leaf": worst_path,
            "ring_s_w4": ring_s}


def moe_reduced_against_cpu() -> dict:
    """Reduced phi3.5-moe-42b at its own capacity factor (8.0: no token
    dropped) and at the full config's (1.25), and reduced arctic-480b (its
    dense residual MLP, Adafactor), two MOE_MODE steps at w=4 on the card
    and on the CPU; at 1.25 the tokens the routing drops on the CPU's first
    step are counted, and there must be some."""
    from repro_torch.models import layers as model_layers

    base = get_arch(MOE_ARCH).reduced()
    full_cf = get_arch(MOE_ARCH).moe_capacity
    dropped = []
    moe_ffn = model_layers.moe_ffn

    def counting(x, router, *args, top_k, capacity_factor):
        if x.device.type == "cpu":
            t = x.shape[0] * x.shape[1]
            ids = torch.topk(x.reshape(t, -1).float() @ router.float(), top_k).indices
            counts = torch.bincount(ids.reshape(-1), minlength=router.shape[-1])
            cap = model_layers.moe_capacity(t, router.shape[-1], top_k,
                                            capacity_factor)
            dropped.append(int(torch.clamp(counts - cap, min=0).sum()))
        return moe_ffn(x, router, *args, top_k=top_k,
                       capacity_factor=capacity_factor)

    out = {}
    for label, cfg, drops in (
            ("phi3.5-moe-42b reduced", base, False),
            (f"phi3.5-moe-42b reduced, capacity factor {full_cf}",
             dataclasses.replace(base, moe_capacity=full_cf), True),
            ("arctic-480b reduced", get_arch("arctic-480b").reduced(), False)):
        dropped.clear()
        model_layers.moe_ffn = counting
        try:
            losses = check_small_against_cpu(MOE_MODE, cfg)
        finally:
            model_layers.moe_ffn = moe_ffn
        out[label] = {"losses": losses, "dropped_on_the_cpu": sum(dropped)}
        if drops and not sum(dropped):
            raise AssertionError(f"{label}: no token dropped")
    log(f"MoE reduced, card against CPU: {out}")
    return out


def moe_path() -> dict:
    """``PLAN`` in MOE_MODE on phi3.5-moe-42b at full width cut to MOE_LAYERS
    layers: B1-B3 and B4 launches against the schedule and no other kernel,
    ring bytes and messages against ``wire_formula``, the slot's first
    batch's loss falling, one step's reduced gradients bit-identical across
    ranks and within the reference's limit of the f32 ring; then the
    reduced MoE configs on card and CPU."""
    cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_LAYERS)
    model = build_model(cfg)
    data = SyntheticTokens(cfg.vocab, SEQ, GLOBAL_BATCH, seed=0)
    trainer, res, evals, seconds, peak, launches = ring_slot(model, data, MOE_MODE)
    params = next(iter(trainer.params.values()))
    sizes = leaf_sizes(params)
    want = {**expected_launches(MOE_MODE, sizes),
            **fa_expected(cfg.n_layers, MAIN_RINGS, cfg.remat)}
    got = {k: launches[k] for k in want}
    others = {k: v for k, v in launches.items() if k not in want and v}
    if len(sizes) != MOE_LEAVES or got != want or others:
        raise AssertionError(f"moe: {len(sizes)} leaves, launches {got} != "
                             f"schedule {want}, or other kernels {others}")
    check_wire(MOE_MODE, trainer, sizes, MAIN_RINGS)
    largest = max(_flatten(params), key=lambda kv: kv[1].numel())
    c_pad, nb, _ = _fused_chunk_layout(largest[1].numel(), 4, DEFAULT_BLOCK)
    losses = trainer.losses
    heldout, first = evals["heldout"], evals["first_batch"]
    log(f"moe {cfg.name} {cfg.n_layers} of 32 layers, "
        f"{n_params(model.param_specs())} params: losses {losses}, held-out "
        f"{heldout[0]} -> {heldout[1]}, the slot's first batch {first[0]} -> "
        f"{first[1]}, warm step s {res['timings']}, slot {seconds:.4f} s, peak "
        f"{peak / 2**30:.4f} GiB ({card_line()}); largest leaf {largest[0]} "
        f"{tuple(largest[1].shape)}, {largest[1].numel()} elements, its chunk "
        f"at w=4 {nb} blocks of {c_pad // nb}; launches equal the schedule, "
        f"ring bytes and messages the formulas")
    values = losses + list(heldout) + list(first)
    if not all(math.isfinite(x) for x in values) or not first[1] < first[0]:
        raise AssertionError(f"moe: losses not finite, or the first batch's "
                             f"not falling: {losses}, {evals}")
    if trainer.re_ring_events != 1 or len(losses) != PLAN.steps:
        raise AssertionError(f"moe: re_ring_events {trainer.re_ring_events}, "
                             f"{len(losses)} steps")
    reduction = moe_reduction_against_f32(model, trainer, data, MOE_MODE)
    reduction["ring_share_w4"] = reduction["ring_s_w4"] / res["timings"][4]
    log(f"moe: one step's reduced gradients, ranks bit-identical; against the "
        f"f32 ring, and the ring's seconds at w=4: {reduction}")
    share = kernel_share(model, trainer, data, fa, "B4")
    del trainer, params
    free_cuda()
    small = moe_reduced_against_cpu()
    return {"launches": {**{k: v for k, v in got.items() if v},
                         "adamw_leaf": res["adamw_launches"]}, "summary": {
        "arch": cfg.name, "n_layers": cfg.n_layers, "mode": MOE_MODE,
        "params": n_params(model.param_specs()), "losses": losses,
        "heldout": list(heldout), "first_batch": list(first), "slot_s": seconds,
        "warm_step_s": {str(w): t for w, t in res["timings"].items()},
        "peak_gib": peak / 2**30, "launches": got, "largest_leaf": largest[0],
        "largest_leaf_elements": largest[1].numel(),
        "largest_leaf_chunk_w4": [nb, c_pad // nb], **reduction,
        "b4_share_of_rank_grads": share, "reduced_against_cpu": small}}


# -- phase 11: the encoder-decoder and VLM paths ----------------------------------

class _PlainAttention(torch.autograd.Function):
    """B4's plain versions on the card, forward (its kv blocks of
    ``block_k``) and backward (the explicit formulas of F2-F4), in place of
    the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, block_k, q_offset):
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset)
        o, lse = fa.flash_attention_plain(q, k, v, block_k=block_k, **ctx.opts)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **ctx.opts),
                None, None, None, None)


def stub_batch(cfg, seq: int, batch: int) -> dict:
    """The pipeline's tokens and labels from seed 0, and the family's stub
    inputs (precomputed frame or patch embeddings, scale 0.02) from numpy
    with the same seed."""
    out = dict(SyntheticTokens(cfg.vocab, seq, batch, seed=0).batch(0))
    rng = np.random.default_rng(0)
    if cfg.family == "vlm":
        out["patch_embeds"] = (rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = (rng.standard_normal(
            (batch, cfg.n_frames, cfg.d_model)) * 0.02).astype(np.float32)
    return {k: torch.as_tensor(v) for k, v in out.items()}


def attention_calls(cfg) -> int:
    """Attention calls of one forward: the encoder's, and the decoder's
    self- and cross-attention a layer; one a layer elsewhere."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def one_rank(model, params, batch, device, plain_block=None, dtype=None):
    """``(loss, {path: grad}, seconds)`` of one rank on ``batch``, with
    attention through B4's kernels, or (given ``plain_block``) through B4's
    plain versions on the same device, their kv blocks of that length;
    given ``dtype``, attention computes in it (q, k and v cast to it, its
    output cast back)."""
    from repro_torch.models import layers as model_layers

    kernels = model_layers.flash_attention

    def attention(q, k, v, *, causal, window, q_offset):
        q2, k2, v2 = (t.to(dtype or q.dtype) for t in (q, k, v))
        if plain_block:
            o = _PlainAttention.apply(q2, k2, v2, causal, window, plain_block, q_offset)
        else:
            o = kernels(q2, k2, v2, causal=causal, window=window, q_offset=q_offset)
        return o.to(q.dtype)

    model_layers.flash_attention = attention
    try:
        t, _, (losses, (grads,)) = synced_s(lambda: rank_grads(
            model, {device: params}, [{k: v.to(device) for k, v in batch.items()}],
            [device]))
    finally:
        model_layers.flash_attention = kernels
    return float(losses[0]), grads, t


def grads_gap(a: dict, b: dict) -> tuple:
    """The largest ``max|a - b| / max|b|`` over the leaves, and its leaf."""
    gaps = {p: rel_max(a[p], b[p]) for p in b}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def b4_calls_against_plain(model, params, batch) -> dict:
    """One rank's forward and backward on ``batch`` with every B4 call held
    on its own inputs against B4's plain versions in f64 (the exact
    function): the kernel's error no larger than the plain f32 version's
    plus B4's limit (O and lse: max |error| over the largest value, plus
    FA_FWD_TOL; each gradient: relative norm, plus FA_BWD_TOL). By kind of
    call, ``"Sq x Skv"`` (and causal or not): calls, the largest share of
    that limit, and the largest errors of the kernel and of the plain f32
    version."""
    kernel_fwd, kernel_bwd = fa.flash_attention_fwd, fa.flash_attention_bwd
    kinds = {}

    def kind(q, k, causal):
        key = f"{q.shape[1]}x{k.shape[1]}{' causal' if causal else ''}"
        return kinds.setdefault(key, {
            "fwd_calls": 0, "bwd_calls": 0, "fwd_of_limit": 0.0,
            "bwd_of_limit": 0.0, "fwd_kernel_err": 0.0, "fwd_plain_err": 0.0,
            "bwd_kernel_err": 0.0, "bwd_plain_err": 0.0})

    def record(row, part, kernel_errs, plain_errs, tol):
        row[f"{part}_calls"] += 1
        row[f"{part}_kernel_err"] = max(row[f"{part}_kernel_err"], *kernel_errs)
        row[f"{part}_plain_err"] = max(row[f"{part}_plain_err"], *plain_errs)
        row[f"{part}_of_limit"] = max(row[f"{part}_of_limit"], *(
            e / (p + tol) for e, p in zip(kernel_errs, plain_errs)))

    def fwd(q, k, v, *, causal=True, window=None, q_offset=0):
        out = kernel_fwd(q, k, v, causal=causal, window=window, q_offset=q_offset)
        plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                         q_offset=q_offset)
        exact = fa.flash_attention_plain(q.double(), k.double(), v.double(),
                                         causal=causal, window=window,
                                         q_offset=q_offset)
        record(kind(q, k, causal), "fwd", [rel_max(a, x) for a, x in zip(out, exact)],
               [rel_max(a, x) for a, x in zip(plain, exact)], FA_FWD_TOL)
        return out

    def bwd(q, k, v, o, lse, do, *, causal=True, window=None, q_offset=0):
        opts = dict(causal=causal, window=window, q_offset=q_offset)
        grads = kernel_bwd(q, k, v, o, lse, do, **opts)
        plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **opts)
        exact = fa.flash_attention_bwd_plain(
            *(t.double() for t in (q, k, v, o, lse, do)), **opts)
        record(kind(q, k, causal), "bwd", [rel_norm(a, x) for a, x in zip(grads, exact)],
               [rel_norm(a, x) for a, x in zip(plain, exact)], FA_BWD_TOL[q.dtype])
        return grads

    fa.flash_attention_fwd, fa.flash_attention_bwd = fwd, bwd
    try:
        one_rank(model, params, batch, DEVICE)
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = kernel_fwd, kernel_bwd
    return kinds


def against_plain_attention(cfg) -> dict:
    """One rank's loss and gradients at full width (``cfg``) through B4's
    kernels, their launches counted against the model's schedule; every B4
    call of that rank's forward and backward held on its own inputs
    against B4's plain versions in f64, no further than the plain f32
    versions are plus B4's limits (at random init these calls' scores reach
    the hundreds, where f32 itself is off by more than B4's limits of the
    plain version, which random inputs meet); then the rank's loss and
    gradients through B4's plain versions, through them with their kv
    blocks of 64 instead of 128, and through them in f64 (the rest of the
    rank in f32), all printed beside the kernels': at random init these
    models' attention is nearly one-hot (no qk-norm, query and key weights
    of std 1/sqrt(heads)), so any reordering of a sum flips some choices
    and, over many layers, moves every gradient; the f64 run shows how far
    the kernels' and the plain f32 versions' gradients each are from the
    rank's with exact attention."""
    model = build_model(cfg)
    params = model.init(0, device=DEVICE, dtype=torch.float32)
    seq = ENC_TOKENS if cfg.family == "encdec" else SEQ
    batch = stub_batch(cfg, seq, ENC_BATCH)
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    loss, grads, seconds = one_rank(model, params, batch, DEVICE)
    launches = {k: v for k, v in all_launches().items() if v}
    peak = torch.cuda.max_memory_allocated()
    calls = attention_calls(cfg)
    want = {FA_FWD: (2 if cfg.remat else 1) * calls, **dict.fromkeys(FA_BWD, calls)}
    kinds = b4_calls_against_plain(model, params, batch)
    n_fwd = sum(r["fwd_calls"] for r in kinds.values())
    n_bwd = sum(r["bwd_calls"] for r in kinds.values())
    if launches != want or (n_fwd, n_bwd) != (want[FA_FWD], calls):
        raise AssertionError(f"{cfg.name}: launches {launches} != {want}, or "
                             f"{n_fwd} and {n_bwd} calls checked")
    def gap(a_loss, a_grads, b_loss, b_grads):
        return (abs(a_loss - b_loss) / abs(b_loss), *grads_gap(a_grads, b_grads))

    reset_all_launches()
    plain_loss, plain_grads, plain_s = one_rank(model, params, batch, DEVICE, 128)
    again_loss, again_grads, _ = one_rank(model, params, batch, DEVICE, 64)
    gaps = {"kernels_vs_plain": gap(loss, grads, plain_loss, plain_grads),
            "plain_vs_plain_blocks_64": gap(again_loss, again_grads, plain_loss,
                                            plain_grads)}
    del again_grads
    exact_loss, exact_grads, _ = one_rank(model, params, batch, DEVICE, 128,
                                          torch.float64)
    gaps["kernels_vs_f64_attention"] = gap(loss, grads, exact_loss, exact_grads)
    gaps["plain_vs_f64_attention"] = gap(plain_loss, plain_grads, exact_loss,
                                         exact_grads)
    if any(all_launches().values()):
        raise AssertionError(f"{cfg.name}: the plain runs launched {all_launches()}")
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "params": n_params(model.param_specs()), "seq": seq,
           "batch": ENC_BATCH, "loss": loss, "plain_loss": plain_loss,
           "b4_calls": kinds, "gaps_loss_grad_leaf": gaps, "rank_s": seconds,
           "plain_rank_s": plain_s, "peak_gib": peak / 2**30,
           "launches": launches}
    log(f"{cfg.name} ({cfg.n_layers} layers, {out['params']} params, "
        f"{card_line()}): one rank's loss {loss} through B4 ({launches}; "
        f"{seconds:.4f} s, peak {out['peak_gib']:.4f} GiB); every B4 call "
        f"against the plain versions on its own inputs, share of the limits "
        f"{kinds}; through B4's plain versions {plain_loss} ({plain_s:.4f} s); "
        f"(loss gap, worst gradient leaf gap, leaf) {gaps}")
    values = [loss, plain_loss, again_loss, exact_loss] + [
        g for v in gaps.values() for g in v[:2]]
    if not (all(map(math.isfinite, values)) and within(
            x for r in kinds.values() for x in (r["fwd_of_limit"], r["bwd_of_limit"]))):
        raise AssertionError(f"{cfg.name}: B4's calls against the plain versions "
                             f"{kinds}, or values not finite {values}")
    del params, grads, plain_grads, exact_grads
    free_cuda()
    return out


def reduced_rank_against_cpu(arch: str) -> dict:
    """Reduced ``arch``: one rank's loss and gradients on the card (B4's
    kernels) and on the CPU (the plain versions) from the same weights:
    the loss within ENC_LOSS_TOL, each gradient leaf's relative norm within
    SMALL_GRAD_TOL. Beside it, what that limit tells apart: on the CPU, the
    rank with every weight moved by one ulp (seeded signs), printed; on the
    card, the rank with attention through B4 in bf16, held outside it."""
    cfg = get_arch(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)
    on_card = tree_map(lambda t: t.to(DEVICE), params)
    batch = stub_batch(cfg, 16, 4)
    reset_all_launches()
    card_loss, card, _ = one_rank(model, on_card, batch, DEVICE)
    calls = attention_calls(cfg)
    want = {FA_FWD: (2 if cfg.remat else 1) * calls, **dict.fromkeys(FA_BWD, calls)}
    launches = {k: v for k, v in all_launches().items() if v}
    cpu_loss, cpu, _ = one_rank(model, params, batch, torch.device("cpu"))

    def worst(grads) -> tuple:
        norms = {k: rel_norm(v.cpu(), cpu[k]) for k, v in grads.items()}
        leaf = max(norms, key=norms.get)
        return norms[leaf], leaf

    gap, leaf = worst(card)
    loss_gap = abs(card_loss - cpu_loss) / abs(cpu_loss)
    gen = torch.Generator().manual_seed(0)
    nudged = tree_map(lambda t: torch.nextafter(t, torch.where(
        torch.rand(t.shape, generator=gen) < 0.5, -math.inf, math.inf)), params)
    ulp = worst(one_rank(model, nudged, batch, torch.device("cpu"))[1])
    bf16 = worst(one_rank(model, on_card, batch, DEVICE, dtype=torch.bfloat16)[1])
    log(f"{cfg.name}, one rank on the card (B4 {launches}) against the CPU: "
        f"losses {card_loss} and {cpu_loss} (gap {loss_gap:.3g}), worst "
        f"gradient leaf {leaf} {gap:.3g} (relative norm, limit "
        f"{SMALL_GRAD_TOL}; max |gap| over its largest value "
        f"{grads_gap({k: v.cpu() for k, v in card.items()}, cpu)}); on the "
        f"CPU with every weight one ulp off {ulp}; on the card with B4 in "
        f"bf16 {bf16}")
    if launches != want or not (loss_gap <= ENC_LOSS_TOL and gap <= SMALL_GRAD_TOL
                                and bf16[0] > SMALL_GRAD_TOL):
        raise AssertionError(f"{cfg.name}: launches {launches} (want {want}), "
                             f"card against CPU loss {loss_gap}, grads {gap}, "
                             f"with B4 in bf16 {bf16}")
    return {"loss_gap": loss_gap, "worst_grad_gap": gap, "worst_leaf": leaf,
            "one_ulp_on_the_cpu": ulp, "b4_bf16_on_the_card": bf16}


def encdec_path() -> dict:
    """Phase 11: whisper-large-v3 at full width and depth, reduced whisper
    on card and CPU, then internvl2-26b (with patch embeddings) and
    phi3-medium-14b at full width cut to VLM_LAYERS layers."""
    cfgs = [get_arch(ENC_ARCH)] + [
        dataclasses.replace(get_arch(a), n_layers=VLM_LAYERS) for a in VLM_ARCHS]
    launches, summary = {}, {}
    for cfg in cfgs:
        res = against_plain_attention(cfg)
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
        summary[cfg.name] = res
        if cfg.name == ENC_ARCH:
            summary[f"{ENC_ARCH} reduced"] = reduced_rank_against_cpu(ENC_ARCH)
    return {"launches": launches, "summary": summary}


# -- phase 12: fault tolerance, calibration, the CLIs -------------------------

def state_copy(trainer) -> dict:
    """A copy, on the card, of the trainer's first replica's parameters and
    optimizer state, flat."""
    return {k: v.clone() for k, v in _flatten(
        {"params": next(iter(trainer.params.values())),
         "opt": next(iter(trainer.opt_state.values()))})}


def poison(trainer) -> None:
    """Every floating leaf of every replica of the trainer's parameters and
    moments to NaN: from here on only a restore that reads the checkpoint
    gives finite losses."""
    for tree in list(trainer.params.values()) + list(trainer.opt_state.values()):
        for _, v in _flatten(tree):
            if v.is_floating_point():
                v.fill_(float("nan"))


def ft_rings() -> list:
    """The ring size of each step the runner runs (FT_RAN)."""
    return [w for w, steps in FT_RAN for _ in range(steps)]


def reduced_bits_identical(model, trainer, data, mode: str, w: int) -> int:
    """One step's gradients at the trainer's state reduced by ``mode`` over
    a ring of ``w``: every rank's reduced leaf bit-identical (phase 4's
    check). Returns the number of leaves."""
    batch = {k: torch.as_tensor(v) for k, v in data.batch(trainer.step).items()}
    devices = trainer.group.devices[:w]
    _, grads = rank_grads(model, trainer.params, shard_batch(batch, devices), devices)
    reduced = reduce_grads(grads, LocalRing(devices), mode)
    for path in reduced[0]:
        if not all(same_bits(reduced[0][path], r[path]) for r in reduced[1:]):
            raise AssertionError(f"{mode} {path}: ranks disagree")
    return len(reduced[0])


def rank_step_ms(model, trainer, data, w: int) -> list:
    """Each rank's forward and backward on its shard of a w-ring step, CUDA
    events around it, warm."""
    batch = {k: torch.as_tensor(v) for k, v in data.batch(trainer.step).items()}
    devices = trainer.group.devices[:w]
    shards = shard_batch(batch, devices)
    out = []
    for r in range(w):
        one, dev = shards[r:r + 1], devices[r:r + 1]
        rank_grads(model, trainer.params, one, dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        rank_grads(model, trainer.params, one, dev)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def ft_path() -> dict:
    """``FaultTolerantRunner`` over ``ElasticTrainer`` on qwen3-0.6b at full
    width cut to FT_LAYERS layers, FT_MODE, FT_PLANS with FT_SURVIVORS left
    in slot FT_FAIL_SLOT; at the failure the injector fills the trainer's
    params and moments with NaN. Held: one recovery, step 8, one restore; the
    restored state bit-identical to the state at the end of slot 0; every
    loss bit-identical to a plain trainer's over FT_RAN from the same
    weights; B1-B3 (int8) and B4's launches equal to FT_RAN's schedule in
    both runs; the reduced gradients bit-identical across ranks; each
    rank's heartbeat alive when read at once and dead when read past the
    timeout."""
    from repro_torch.training import FaultTolerantRunner, Heartbeat, HeartbeatMonitor
    from repro_torch.training.checkpoint import latest_step

    cfg = dataclasses.replace(get_arch(ARCH), n_layers=FT_LAYERS)
    model = build_model(cfg)
    data = SyntheticTokens(cfg.vocab, SEQ, GLOBAL_BATCH, seed=0)
    init = model.init(0, device=DEVICE, dtype=torch.float32)
    sizes = leaf_sizes(init)
    want = {**expected_launches(FT_MODE, sizes, ft_rings()),
            **fa_expected(cfg.n_layers, ft_rings(), cfg.remat)}
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ft_")
    try:
        trainer = ElasticTrainer(model, make_optimizer("adamw"), data,
                                 global_batch=GLOBAL_BATCH, base_lr=LR,
                                 mode=FT_MODE, device=DEVICE,
                                 checkpoint_dir=ckpt_dir,
                                 params=tree_map(lambda t: t.clone(), init))
        slot_ends, slot_res, io_s = [], [], {"write": [], "read": []}
        run_slot, restore, save = trainer.run_slot, trainer.restore, trainer._save

        def recording_run_slot(plan):
            res = run_slot(plan)
            slot_res.append(res)
            if not slot_ends:
                slot_ends.append(state_copy(trainer))
            return res

        def timed_save():
            t0 = time.perf_counter()
            save()
            io_s["write"].append(time.perf_counter() - t0)

        def timed_restore():
            t0 = time.perf_counter()
            ok = restore()
            torch.cuda.synchronize()
            io_s["read"].append(time.perf_counter() - t0)
            slot_ends.append(state_copy(trainer))
            return ok

        trainer.run_slot, trainer.restore, trainer._save = (
            recording_run_slot, timed_restore, timed_save)

        def injector(slot):
            if slot == FT_FAIL_SLOT:
                poison(trainer)
                return FT_SURVIVORS
            return None

        runner = FaultTolerantRunner(trainer, fail_injector=injector)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        t0 = time.perf_counter()
        res = runner.run([SlotPlan(w, n) for w, n in FT_PLANS])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in all_launches().items() if v}
        peak = torch.cuda.max_memory_allocated()
        files = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".npz"))
        ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, files[-1]))
        saved, restored = slot_ends
        same_state = sorted(saved) == sorted(restored) and all(
            same_bits(saved[k], restored[k]) for k in saved)
        ft_losses = list(trainer.losses)
        if not (res["recoveries"] == 1 and res["final_step"] == 8
                and trainer.restores == 1 and latest_step(ckpt_dir) == 8
                and same_state and launches == {k: v for k, v in want.items() if v}):
            raise AssertionError(
                f"fault tolerance: {res}, restores {trainer.restores}, restored "
                f"state bit-identical {same_state}, launches {launches} against "
                f"the schedule {want}")
        n_leaves = reduced_bits_identical(model, trainer, data, FT_MODE, 4)
        ms = rank_step_ms(model, trainer, data, 4)
        monitor = HeartbeatMonitor(timeout=FT_TIMEOUT, straggler_factor=FT_STRAGGLER)
        for rank, t in enumerate(ms):
            monitor.beat(Heartbeat(worker=rank, step=trainer.step,
                                   t=time.monotonic(), step_time=t / 1e3))
        # read now, every rank has just beaten; read past the timeout with
        # no beat since, every rank is dead
        now = time.monotonic()
        dead = (monitor.dead(now), monitor.dead(now + 2 * FT_TIMEOUT))
        if dead != ([], list(range(len(ms)))):
            raise AssertionError(f"heartbeats: dead now and past the timeout {dead}")
        warm = {}
        for r in slot_res:
            for w, t in r["timings"].items():
                warm[w] = min(warm.get(w, math.inf), t)
        del trainer, runner, saved, restored, slot_ends
        free_cuda()
        plain = ElasticTrainer(model, make_optimizer("adamw"), data,
                               global_batch=GLOBAL_BATCH, base_lr=LR,
                               mode=FT_MODE, device=DEVICE, params=init)
        reset_all_launches()
        for w, n in FT_RAN:
            plain.run_slot(SlotPlan(w, n))
        torch.cuda.synchronize()
        plain_launches = {k: v for k, v in all_launches().items() if v}
        if plain.losses != ft_losses or plain_launches != launches:
            raise AssertionError(f"fault tolerance: losses {ft_losses} against "
                                 f"the plain trainer's {plain.losses}, launches "
                                 f"{plain_launches}")
        del plain
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    out = {"arch": ARCH, "n_layers": FT_LAYERS, "params": n_params(model.param_specs()),
           "mode": FT_MODE, "plans": FT_PLANS, "ran": FT_RAN, **res,
           "losses": ft_losses, "launches": launches, "seconds": seconds,
           "peak_gib": peak / 2**30, "checkpoint_bytes": ckpt_bytes,
           "checkpoints": len(files), "checkpoint_write_s": io_s["write"],
           "checkpoint_read_s": io_s["read"],
           "warm_step_s": {str(w): t for w, t in warm.items()},
           "rank_step_ms": ms, "stragglers": monitor.stragglers(),
           "reduced_leaves_bit_identical": n_leaves}
    log(f"fault tolerance ({card_line()}): {ARCH} at {FT_LAYERS} layers, "
        f"{out['params']} params, {FT_MODE}: recovered {res['recoveries']}x, "
        f"step {res['final_step']}, restored state bit-identical to slot 0's "
        f"end after the in-memory state was set to NaN; losses {ft_losses} "
        f"bit-identical to the plain trainer over {FT_RAN}; launches {launches} "
        f"equal the schedule; checkpoint {ckpt_bytes} B, written in "
        f"{io_s['write']} s, read in {io_s['read']} s ({len(files)} files); "
        f"warm step s {out['warm_step_s']}; rank ms {ms}, stragglers "
        f"{out['stragglers']}; none dead now, all {len(ms)} dead "
        f"{2 * FT_TIMEOUT} s on with no beat")
    return {"launches": launches, "summary": out}


def module_run(module: str, *args: str) -> subprocess.Popen:
    """``python -m module args`` from the checkout's ``src``, started."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-m", module, *args], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finished(proc: subprocess.Popen, what: str) -> list:
    """The lines of a started run's stdout; raises unless it exits 0 within
    CLI_TIMEOUT seconds."""
    try:
        out, err = proc.communicate(timeout=CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise AssertionError(f"{what}: exit {proc.returncode}: {err[-3000:]}")
    return out.strip().splitlines()


def check_serve_cli(lines: list, arch: str) -> dict:
    res = json.loads(lines[-1])
    if not (res["device"].startswith("cuda") and res["requests"] == SERVE_CLI_BATCH
            and res["decode_compiles"] == 1):
        raise AssertionError(f"serving CLI {arch}: {res}")
    return res


def check_serve_batched(lines: list) -> dict:
    """``serve_batched`` raises unless its own checks hold (each family
    served 6/6 with a clean audit and each step captured once, the burst
    taking training workers and handing them back, the reported SLO
    attainment the log's); here only that every engine was on the card."""
    res = json.loads(lines[-1])
    engines, co = res["engines"], res["coschedule"]
    devices = [e["device"] for e in engines.values()] + [co["device"]]
    if not all(d.startswith("cuda") for d in devices):
        raise AssertionError(f"serve_batched: devices {devices}")
    for e in engines.values():
        e.pop("tokens")
    return res


def calibration_cli() -> dict:
    """``python -m repro_torch.cluster.calibrate`` at the reference's grid;
    its samples read back and fitted; the fit moves a profile's bandwidth."""
    from repro_torch.cluster.calibrate import (
        calibrate_profile, fit_comm_model, load_timings)
    from repro_torch.core.rar_model import profile_from_arch

    tmp = tempfile.mkdtemp(prefix="chip_smoke_calibrate_")
    try:
        path = os.path.join(tmp, "ring_timings.json")
        t0 = time.perf_counter()
        lines = finished(module_run("repro_torch.cluster.calibrate", "--out", path),
                         "calibrate")
        seconds = time.perf_counter() - t0
        samples = load_timings(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fit = fit_comm_model(samples)
    prof = profile_from_arch(n_params=1.2e9, tokens_per_batch=4096 * 8)
    moved = calibrate_profile(prof, samples)
    if not (len(samples) == CALIBRATION_SAMPLES == fit.n_samples
            and fit.bandwidth > 0 and moved.bandwidth != prof.bandwidth):
        raise AssertionError(f"calibration: {len(samples)} samples, {fit}")
    out = {"samples": [dataclasses.asdict(x) for x in samples],
           "bandwidth_elems_per_s": fit.bandwidth, "overhead_s": fit.overhead,
           "rms_s": fit.residual, "n_samples": fit.n_samples,
           "profile_bandwidth": [prof.bandwidth, moved.bandwidth],
           "seconds": seconds, "printed": lines[-1]}
    log(f"calibration ({card_line()}): every rank on cuda:0, so b is a "
        f"device-to-device copy's bandwidth, not a wire's: b "
        f"{fit.bandwidth:.6g} elements/s ({fit.bandwidth * 4 / 1e9:.6g} GB/s "
        f"of f32), gamma {fit.overhead * 1e6:.6g} us, rms {fit.residual:.6g} s "
        f"over {fit.n_samples} samples; {seconds:.4f} s")
    return out


def clis_path() -> dict:
    """Phase 12's subprocesses: the serving CLI for SERVE_CLI_ARCHS and
    ``serve_batched``, side by side, then the calibration alone."""
    t0 = time.perf_counter()
    runs = {arch: module_run("repro_torch.launch.serve", "--arch", arch)
            for arch in SERVE_CLI_ARCHS}
    runs["serve_batched"] = module_run("repro_torch.launch.serve_batched")
    out = {arch: check_serve_cli(finished(runs[arch], f"serving CLI {arch}"), arch)
           for arch in SERVE_CLI_ARCHS}
    out["serve_batched"] = check_serve_batched(
        finished(runs["serve_batched"], "serve_batched"))
    out["serving_seconds"] = time.perf_counter() - t0
    log(f"CLIs on the card ({card_line()}): the serving CLI "
        f"{ {a: out[a] for a in SERVE_CLI_ARCHS} }; serve_batched "
        f"{json.dumps(out['serve_batched'])}; {out['serving_seconds']:.4f} s "
        f"side by side")
    out["calibration"] = calibration_cli()
    return out


# -- phase 14: the GSPMD path -------------------------------------------------

def on_one_rank(mesh, tree, placements):
    """Each leaf of ``tree`` as a DTensor on a one-rank mesh: its local
    shard is the tensor itself, so no copy is made."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: on_one_rank(mesh, v, placements[k]) for k, v in tree.items()}
    return DTensor.from_local(tree, mesh, list(placements), run_check=False)


def local_leaves(tree) -> dict:
    from torch.distributed.tensor import DTensor

    return {p: v.to_local() if isinstance(v, DTensor) else v
            for p, v in _flatten(tree)}


def start_dryruns(cfg) -> dict:
    """Phase 14's dry runs, each a process of its own (the fake world is
    process-global), started together so that they run on the host while
    the steps run on the card: the phase's cell on a fake (1, 1) mesh with
    f32 parameters (it prints its record), ``python -m
    repro_torch.launch.dryrun`` on the 16x16 fake mesh for each cell of
    GSPMD_DRYRUNS, and ``profile_cell --metric flops --top 5`` of the
    first."""
    code = (
        "import json, torch\n"
        "from repro_torch.configs.base import ArchConfig, ShapeConfig\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.launch.mesh import mesh_of, start_fake_world\n"
        "start_fake_world(1)\n"
        f"cfg = ArchConfig(**json.loads({json.dumps(cfg.as_dict())!r}))\n"
        f"rec = dryrun.run_cell(cfg, ShapeConfig('chip', {SEQ}, "
        f"{GLOBAL_BATCH}, 'train'), multi_pod=False, out_dir=None, verbose=False, "
        "mesh=mesh_of((1, 1), ('data', 'model')), param_dtype=torch.float32)\n"
        "print(json.dumps(rec))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    arch, shape = GSPMD_DRYRUNS[0]
    return {"t0": time.perf_counter(),
            "cell": subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True),
            **{f"dryrun {a} {sh}": module_run("repro_torch.launch.dryrun", "--arch",
                                              a, "--shape", sh)
               for a, sh in GSPMD_DRYRUNS},
            "profile": module_run("repro_torch.launch.profile_cell", "--arch",
                                  arch, "--shape", shape, "--metric", "flops",
                                  "--top", "5")}


def finish_dryruns(runs: dict, arg_bytes: int) -> dict:
    """The dry runs' records and their seconds since they started; the
    (1, 1) cell's argument bytes held to the real tensors'."""
    lines = {k: finished(p, k) for k, p in runs.items() if k != "t0"}
    seconds = time.perf_counter() - runs["t0"]
    pred = json.loads(lines["cell"][-1])
    if pred["memory"]["argument_size_in_bytes"] != arg_bytes:
        raise AssertionError(f"dry run's argument bytes {pred['memory']} != the "
                             f"real tensors' {arg_bytes}")
    records = {}
    for arch, shape in GSPMD_DRYRUNS:
        out = lines[f"dryrun {arch} {shape}"]
        if out[-1] != "[dryrun] all cells OK":
            raise AssertionError(f"dry run CLI, {arch} {shape}: {out[-3:]}")
        with open(ROOT / "results" / "dryrun_torch" / "16x16"
                  / f"{arch}__{shape}.json") as f:
            records[f"{arch} {shape}"] = json.load(f)
    first = "%s %s" % GSPMD_DRYRUNS[0]
    return {"seconds_since_start": seconds, "cell": pred, "record": records[first],
            "records": records, "profile": lines["profile"][-6:]}


def step_expected(cfg) -> dict:
    """B4's, B8's and B9's launches of one step of ``cfg`` on one rank: a
    forward of each call (twice with remat: again in the recompute of
    backward) and a backward."""
    fwd = 2 if cfg.remat else 1
    if cfg.family == "rwkv":
        return {WKV_FWD: fwd * cfg.n_layers, WKV_BWD: cfg.n_layers}
    if cfg.family == "hybrid":
        return {**zamba_fa_expected(cfg, [1]), **ssd_expected(cfg, [1])}
    calls = attention_calls(cfg)
    return {FA_FWD: fwd * calls, **dict.fromkeys(FA_BWD, calls)}


def gspmd_family(arch: str, layers, seq: int, batch_size: int) -> dict:
    """One step of ``make_train_step`` of ``arch`` (GSPMD_FAMILIES) on plain
    tensors, then on a one-rank (1, 1) ``DeviceMesh`` (``nccl``) under the
    config's layout and ``activate(rules)``, from the same weights: every
    leaf of the parameters, the optimizer state and the metrics bit for bit
    (the plain step's wait on the host), each step's launches of B4, B8
    and B9 equal and on the step's schedule."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import activate, make_rules, param_shardings
    from repro_torch.launch.dryrun import opt_state_shardings
    from repro_torch.launch.mesh import mesh_of
    from repro_torch.training.train_step import make_train_step

    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_model(cfg)
    opt = make_optimizer("adamw")
    batch = {k: v.to(DEVICE) for k, v in stub_batch(cfg, seq, batch_size).items()}
    params = model.init(0, device=DEVICE, dtype=torch.float32)
    step = make_train_step(model, opt, lr=LR)
    want_k = step_expected(cfg)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    plain_s, plain_issued, out = synced_s(lambda: step(params, opt.init(params), batch))
    plain_peak = torch.cuda.max_memory_allocated()
    launches = {"plain": nonzero(all_launches())}
    if launches["plain"] != want_k:
        raise AssertionError(f"{arch} plain step: launches {launches['plain']} != "
                             f"the schedule {want_k}")
    want = {k: v.cpu() for k, v in local_leaves(
        {"p": out[0], "o": out[1], "m": out[2]}).items()}
    del out
    free_cuda()
    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = mesh_of((1, 1), ("data", "model"))
        rules = make_rules(mesh, fsdp=cfg.fsdp,
                           sequence_parallel=cfg.sequence_parallel)
        specs = model.param_specs()
        pd = on_one_rank(mesh, params, param_shardings(rules, specs))
        od = on_one_rank(mesh, opt.init(params),
                         opt_state_shardings("adamw", rules, specs))
        bd = {k: on_one_rank(mesh, v, rules.placements_for(
            ("batch",) + (None,) * (v.dim() - 1))) for k, v in batch.items()}
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        with activate(rules):
            mesh_s, mesh_issued, (p1, o1, m1) = synced_s(lambda: step(pd, od, bd))
        mesh_peak = torch.cuda.max_memory_allocated()
        launches["mesh"] = nonzero(all_launches())
        if launches["mesh"] != launches["plain"]:
            raise AssertionError(f"{arch}: (1, 1)-mesh step's launches "
                                 f"{launches['mesh']} != the plain step's "
                                 f"{launches['plain']}")
        got = local_leaves({"p": p1, "o": o1, "m": m1})
        differ = [k for k in want if not same_bits(got[k].cpu(), want[k])]
        if sorted(got) != sorted(want) or differ:
            raise AssertionError(f"{arch}: (1, 1)-mesh step differs from the plain "
                                 f"step in {len(differ)} leaves: {differ[:5]}")
        del pd, od, bd, p1, o1, m1, got
    finally:
        dist.destroy_process_group()
    del params, want_k
    free_cuda()
    summary = {
        "layers": cfg.n_layers, "seq": seq, "batch": batch_size,
        "params": n_params(model.param_specs()),
        "layout": {"fsdp": cfg.fsdp, "sequence_parallel": cfg.sequence_parallel},
        "loss": float(want["m/loss"]), "grad_norm": float(want["m/grad_norm"]),
        "mesh_step_bit_identical": True, "leaves": len(want),
        "plain_step_s": plain_s, "mesh_step_s": mesh_s,
        "plain_step_issue_s": plain_issued, "mesh_step_issue_s": mesh_issued,
        "plain_step_peak_gib": plain_peak / 2**30,
        "mesh_step_peak_gib": mesh_peak / 2**30, "launches": launches}
    log(f"GSPMD step ({card_line()}): {arch} {cfg.n_layers} layers, seq {seq}, "
        f"batch {batch_size}: (1, 1) mesh bit-identical to the plain step over "
        f"{len(want)} leaves; launches {launches['mesh']}; {plain_s:.3f} s plain, "
        f"{mesh_s:.3f} s mesh")
    return summary


def gspmd_path() -> dict:
    """Phase 14: one step of ``make_train_step`` on qwen3-0.6b at full width
    and depth, on plain tensors and on DTensors over a one-rank (1, 1)
    ``DeviceMesh`` (``nccl``) under ``activate(rules)``, held bit for bit;
    then the same step in GSPMD_MICROBATCHES microbatches against it; B4's
    launches against the schedule of each; then the same pair of steps of
    each of GSPMD_FAMILIES (:func:`gspmd_family`); the dry run's prediction
    of the qwen3 cell; and the dry runs of GSPMD_DRYRUNS and the profile on
    the 16x16 fake mesh."""
    from repro_torch.training.train_step import make_train_step

    cfg = get_arch(ARCH)
    model = build_model(cfg)
    opt = make_optimizer("adamw")
    data = SyntheticTokens(cfg.vocab, SEQ, GLOBAL_BATCH, seed=0)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.batch(0).items()}
    params = model.init(0, device=DEVICE, dtype=torch.float32)
    step = make_train_step(model, opt, lr=LR)
    want_fa = fa_expected(cfg.n_layers, [1], cfg.remat)
    launches = {}
    runs = start_dryruns(cfg)
    try:
        return gspmd_steps(cfg, model, opt, batch, params, step, want_fa,
                           launches, runs)
    finally:
        for proc in runs.values():
            if isinstance(proc, subprocess.Popen) and proc.poll() is None:
                proc.kill()
                proc.communicate()


def gspmd_steps(cfg, model, opt, batch, params, step, want_fa, launches,
                runs) -> dict:
    """:func:`gspmd_path`'s steps and checks, while its dry runs run."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import activate, make_rules, param_shardings
    from repro_torch.launch.dryrun import opt_state_shardings
    from repro_torch.launch.mesh import mesh_of
    from repro_torch.training.train_step import make_train_step

    fa.reset_launches()
    plain_s, plain_issued, (p_plain, o_plain, m_plain) = synced_s(
        lambda: step(params, opt.init(params), batch))
    launches["plain"] = check_fa_launches("plain step", want_fa)

    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = mesh_of((1, 1), ("data", "model"))
        rules = make_rules(mesh)
        specs = model.param_specs()
        pd = on_one_rank(mesh, params, param_shardings(rules, specs))
        od = on_one_rank(mesh, opt.init(params),
                         opt_state_shardings("adamw", rules, specs))
        bd = {k: on_one_rank(mesh, v, rules.placements_for(("batch", None)))
              for k, v in batch.items()}
        arg_bytes = sum(t.nbytes for t in local_leaves({"p": pd, "o": od, "b": bd}).values())
        free_cuda()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        with activate(rules):
            mesh_s, mesh_issued, (p1, o1, m1) = synced_s(lambda: step(pd, od, bd))
        peak = torch.cuda.max_memory_allocated()
        launches["mesh"] = check_fa_launches("(1, 1)-mesh step", want_fa)
        got, want = local_leaves({"p": p1, "o": o1, "m": m1}), local_leaves(
            {"p": p_plain, "o": o_plain, "m": m_plain})
        differ = [k for k in want if not same_bits(got[k], want[k])]
        if differ:
            raise AssertionError(f"(1, 1)-mesh step differs from the plain step "
                                 f"in {len(differ)} leaves: {differ[:5]}")
        del p_plain, o_plain, got, want
        free_cuda()

        step_mb = make_train_step(model, opt, lr=LR, n_microbatches=GSPMD_MICROBATCHES)
        fa.reset_launches()
        with activate(rules):
            mb_s, mb_issued, (p4, o4, m4) = synced_s(lambda: step_mb(pd, od, bd))
        launches["microbatched"] = check_fa_launches(
            f"{GSPMD_MICROBATCHES}-microbatch step",
            fa_expected(cfg.n_layers, [1] * GSPMD_MICROBATCHES, cfg.remat))
        l1, l4 = local_leaves(m1), local_leaves(m4)
        metric_gap = {k: abs(float(l4[k]) - float(l1[k])) / abs(float(l1[k]))
                      for k in ("loss", "grad_norm")}
        m_gap = grads_gap(local_leaves(o4["m"]), local_leaves(o1["m"]))
        pa, pb = local_leaves(p4), local_leaves(p1)
        p_gap = max(float((pa[k] - pb[k]).abs().max()) for k in pb)
        if max(metric_gap.values()) > GSPMD_TOL or m_gap[0] > GSPMD_TOL:
            raise AssertionError(f"{GSPMD_MICROBATCHES} microbatches against one: "
                                 f"{metric_gap}, first moment {m_gap}")
        del pd, od, bd, p1, o1, p4, o4, pa, pb
        free_cuda()
    finally:
        dist.destroy_process_group()
    del params, batch
    free_cuda()
    families = {arch: gspmd_family(arch, *shape)
                for arch, shape in GSPMD_FAMILIES.items()}

    dry = finish_dryruns(runs, arg_bytes)
    pred = dry["cell"]
    summary = {
        "arch": cfg.name, "layers": cfg.n_layers, "seq": SEQ,
        "global_batch": GLOBAL_BATCH, "optimizer": "adamw f32",
        "loss": float(m_plain["loss"]), "grad_norm": float(m_plain["grad_norm"]),
        "mesh_step_bit_identical": True, "plain_step_s": plain_s,
        "mesh_step_s": mesh_s, "microbatched_step_s": mb_s,
        # each step's host seconds until it returned, before the closing sync
        "plain_step_issue_s": plain_issued, "mesh_step_issue_s": mesh_issued,
        "microbatched_step_issue_s": mb_issued,
        "mesh_step_peak_gib": peak / 2**30,
        "mesh_step_temp_gib": (peak - base) / 2**30,
        "b4_launches": launches,
        "microbatches": GSPMD_MICROBATCHES, "microbatch_metric_gap": metric_gap,
        "microbatch_first_moment_gap": m_gap, "microbatch_param_max_abs_gap": p_gap,
        "dryrun_argument_bytes": pred["memory"]["argument_size_in_bytes"],
        "real_argument_bytes": arg_bytes,
        "dryrun_temp_gib": pred["memory"]["temp_size_in_bytes"] / 2**30,
        "dryrun_temp_over_measured_temp":
            pred["memory"]["temp_size_in_bytes"] / (peak - base),
        "dryruns_seconds_since_start": dry["seconds_since_start"],
        "dryrun_1x1": {k: pred[k] for k in ("flops_per_device", "bytes_per_device",
                                            "collective_wire_bytes", "bottleneck",
                                            "compile_s")},
        "dryrun_16x16": {"record": dry["record"], "profile": dry["profile"]},
        "families": families,
        "families_dryrun_16x16": {
            k: {f: r[f] for f in ("flops_per_device", "bytes_per_device",
                                  "collective_wire_bytes", "bottleneck",
                                  "useful_flops_fraction", "memory", "compile_s")}
            for k, r in dry["records"].items()},
    }
    log(f"GSPMD step ({card_line()}): {cfg.name} {cfg.n_layers} layers, seq "
        f"{SEQ}, batch {GLOBAL_BATCH}: (1, 1) mesh bit-identical to the plain "
        f"step; {GSPMD_MICROBATCHES} microbatches within {GSPMD_TOL} "
        f"({metric_gap}, first moment {m_gap}); B4 {launches}; dry run's temp "
        f"over the measured {summary['dryrun_temp_over_measured_temp']:.4f}")
    return {"launches": launches, "summary": summary,
            "family_launches": {a: f["launches"] for a, f in families.items()}}


# -- phase 13: the analyses on the card ---------------------------------------

def verifier_launches(name: str, worlds, ds) -> dict:
    """The ring kernels' launches of recording the fused variant ``name``
    over ``worlds`` x ``ds`` on each input family: one call a record, on
    its mode's ring schedule (``expected_launches`` of one unit at ring
    size w)."""
    out = dict.fromkeys(qr.LAUNCHES, 0)
    for w in worlds:
        for d in ds:
            want = expected_launches(VERIFIER_FUSED[name], [d], rings=[w])
            if name.startswith("ef-"):
                want["dequant"] += w
            for kernel, n in want.items():
                out[kernel] += n * len(AC.FAMILIES)
    return out


def nonzero(counts: dict) -> dict:
    return {k: n for k, n in counts.items() if n}


def analysis_path() -> dict:
    """Phase 13: the collective verifier in this process on the card (each
    fused variant's kernel launches held to its ring schedule, then the
    whole sweep and the mutation suite with the counters set to 0 just
    before), every kernel instantiation's resources and blocks per SM, and
    both analysis CLIs as processes of their own."""
    from repro_torch.dist.registry import RING_VARIANTS

    t0 = time.perf_counter()
    per_variant = {}
    for variant in RING_VARIANTS:
        if variant.name not in VERIFIER_FUSED:
            continue
        reset_all_launches()
        found = AC.verify_ring_variant(variant, AC.DEFAULT_WORLDS,
                                       AC.DEFAULT_DS, device=DEVICE)
        torch.cuda.synchronize()
        got = nonzero(all_launches())
        want = nonzero(verifier_launches(variant.name, AC.DEFAULT_WORLDS,
                                         AC.DEFAULT_DS))
        if found or got != want:
            raise AssertionError(
                f"verifier on {variant.name}: findings "
                f"{[str(f) for f in found]}; launches {got}, schedule {want}")
        per_variant[variant.name] = got
    reset_all_launches()
    findings, stats = AC.run_verifier(device=DEVICE)
    silent = AC.run_self_test(device=DEVICE)
    torch.cuda.synchronize()
    launches = dict(all_launches())
    if findings or silent:
        raise AssertionError(f"verifier on the card: findings "
                             f"{[str(f) for f in findings]}; silent {silent}")
    missing = [k for k in qr.LAUNCHES if not launches[k]]
    if missing:
        raise AssertionError(f"the verifier's sweep launched no {missing}")
    verifier_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    configs = AK.card_launch_configs()
    bad = [r for r in configs if r["verdict"].startswith("reject")
           or r["dynamic_smem"] > AK.SMEM_PER_BLOCK
           or r["predicted_blocks_per_sm"] != r["reported_blocks_per_sm"]]
    if bad:
        raise AssertionError(f"launch configs rejected: {bad}")
    configs_s = time.perf_counter() - t1

    t2 = time.perf_counter()
    runs = {"collectives": module_run("repro_torch.analysis.collectives"),
            "kernels": module_run("repro_torch.analysis.kernels", "--execute")}
    printed = {what: finished(proc, what)[-1] for what, proc in runs.items()}
    if not (f" on {DEVICE}" in printed["collectives"]
            and " 0 finding(s)" in printed["collectives"]
            and "0 silent -> OK" in printed["collectives"]
            and printed["kernels"].endswith("-> OK")):
        raise AssertionError(f"analysis CLIs: {printed}")
    clis_s = time.perf_counter() - t2
    summary = {
        "verifier": dataclasses.asdict(stats), "findings": len(findings),
        "silent_fixtures": len(silent), "fused_variant_launches": per_variant,
        "spills": {r["kernel"]: r["local_bytes"] for r in configs
                   if r["local_bytes"]},
        "clis": printed, "verifier_s": verifier_s,
        "launch_configs_s": configs_s, "clis_s": clis_s}
    log(f"analysis on the card ({card_line()}): verifier {stats.records} "
        f"records, {stats.hops} hops, {len(findings)} findings, "
        f"{len(silent)} silent fixtures in {verifier_s:.4f} s; "
        f"{len(configs)} kernel instantiations, predicted blocks per SM "
        f"equal to the occupancy API's, in {configs_s:.4f} s; both CLIs "
        f"exit 0 in {clis_s:.4f} s side by side")
    return {"launches": launches, "launch_configs": configs,
            "summary": summary}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs "
              "a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_s = {}
    mark = [time.perf_counter()]

    def done(phase: str) -> None:
        now = time.perf_counter()
        phase_s[phase] = now - mark[0]
        mark[0] = now
        log(f"{phase} took {phase_s[phase]:.3f} s")

    built = build.build_all()
    log(f"built {sorted(built)}")
    done("phase 2 (build)")

    cfg = get_arch(ARCH)
    model = build_model(cfg)
    moe_model = build_model(dataclasses.replace(get_arch(MOE_ARCH),
                                                n_layers=MOE_LAYERS))
    rows = check_kernels(model, main_path_shapes(moe_model, overlap=False))
    rows.update(check_flash_attention())
    rows.update(check_wkv6())
    rows.update(check_ssd())
    rows.update(check_adamw())
    check_state_forms(rows)
    zamba2_7b = check_zamba2_7b_kernels()
    log(f"zamba2-7b kernels {json.dumps(zamba2_7b)}")
    for mode in MODE_KERNELS:
        check_small_against_cpu(mode)
    check_rwkv_small_against_cpu()
    check_zamba_small_against_cpu()
    done("phase 3 (kernels)")

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
        share = kernel_share(model, trainer, data, fa, "B4")
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
            "b4_launches": {k: run["launches"][k] for k in FA_PAIR_OPS},
            "b4_launches_check_reduction": red["fa_launches"],
            "b4_share_of_rank_grads": share,
        }
        log(f"summary {mode} " + json.dumps(summary["modes"][mode]))
        del trainer, run
        free_cuda()
    done("phase 4 (qwen3 main paths)")
    cut = dataclasses.replace(cfg, n_layers=PLAIN_MODE_LAYERS)
    cut_model = build_model(cut)
    for mode in PLAIN_MODES:
        for name, n in plain_mode(mode, cut_model, data).items():
            rows[name]["launches"] += n
            rows[name]["launches_by_mode"][mode] = n
        free_cuda()
    done("phase 5 (modes without kernels)")
    rwkv = rwkv_path(dataclasses.replace(get_arch(RWKV_ARCH),
                                         n_layers=RWKV_LAYERS))
    log("summary rwkv " + json.dumps(rwkv["summary"]))
    free_cuda()
    done("phase 6 (rwkv6)")
    zamba = zamba_path(get_arch(ZAMBA_ARCH))
    log("summary zamba2 " + json.dumps(zamba["summary"]))
    free_cuda()
    done("phase 7 (zamba2)")
    carry = state_carry_path()
    log("summary carry " + json.dumps(carry["summary"]))
    free_cuda()
    done("phase 7b (state carry)")
    gloop = gadget_loop()
    log("summary loop " + json.dumps(gloop["summary"]))
    free_cuda()
    done("phase 8 (GADGET's loop)")
    serving = serving_path()
    log("summary serving " + json.dumps(serving["summary"], default=str))
    free_cuda()
    done("phase 9 (serving)")
    moe = moe_path()
    log("summary moe " + json.dumps(moe["summary"]))
    free_cuda()
    done("phase 10 (MoE)")
    encdec = encdec_path()
    log("summary encdec " + json.dumps(encdec["summary"]))
    free_cuda()
    done("phase 11 (encoder-decoder and VLM)")
    ft = ft_path()
    log("summary ft " + json.dumps(ft["summary"]))
    free_cuda()
    clis = clis_path()
    log("summary clis " + json.dumps(clis))
    done("phase 12 (fault tolerance, calibration, CLIs)")
    analysis = analysis_path()
    log("summary analysis " + json.dumps(analysis["summary"]))
    done("phase 13 (analysis on the card)")
    free_cuda()
    gspmd = gspmd_path()
    log("summary gspmd " + json.dumps(gspmd["summary"]))
    free_cuda()
    done("phase 14 (the GSPMD path)")
    for path, launches in (("rwkv ring", rwkv["launches"]),
                           ("zamba2 ring", zamba["launches"]),
                           ("state carry, two halves", carry["launches"]),
                           ("gadget loop", gloop["launches"]),
                           ("serving forward checks", serving["launches"]),
                           ("phi3.5-moe compressed-fused", moe["launches"]),
                           ("encoder-decoder and VLM ranks", encdec["launches"]),
                           ("fault-tolerant qwen3", ft["launches"]),
                           ("gspmd step on a (1, 1) mesh",
                            {k: sum(v[k] for v in gspmd["launches"].values())
                             for k in FA_PAIR_OPS}),
                           *((f"gspmd {arch} step, plain and on a (1, 1) mesh",
                              {k: f["plain"].get(k, 0) + f["mesh"].get(k, 0)
                               for k in {**f["plain"], **f["mesh"]}})
                             for arch, f in gspmd["family_launches"].items())):
        for name, n in launches.items():
            if n:
                rows[name]["launches"] += n
                rows[name]["launches_by_mode"][path] = n
    # held before the verifier's launches join the rows: its 96- and
    # 777-element records alone must not stand for a path
    missing = [name for name, row in rows.items() if not row["launches"]]
    if missing:
        raise AssertionError(f"kernels no main path launched: {missing}")
    for name, n in analysis["launches"].items():
        if n:
            rows[name]["launches"] += n
            rows[name]["launches_by_mode"]["collective verifier"] = n
    log("phase seconds " + json.dumps(phase_s))

    print(json.dumps({"launch_configs": analysis["launch_configs"]}),
          flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
