"""Launch-config checker for the port's CUDA kernels —
``python -m repro_torch.analysis.kernels``.

The counterpart of ``repro.analysis.kernels``. The reference checks facts of
a TPU core (a tile budget in 16 MB of VMEM, 128-lane alignment), which have
no counterpart on Hopper. What carries over is the wire layout; what takes
the TPU checks' place is the launch each wrapper of ``repro_torch.kernels``
makes for a given shape, checked without a device:

  * **threads** — at most 1024 a block, a multiple of the 32-thread warp,
    and equal to the kernel's ``__launch_bounds__``;
  * **dynamic shared memory** — at most the 232,448 B a block can opt into
    on an H100;
  * **grid** — ``x`` at most 2^31 - 1, ``y`` and ``z`` at most 65,535;
  * **dispatch** — B4's head dim one that ``flash_attention.cu``'s
    ``DISPATCH`` instantiates (32, 64, 80, 128, 224), B8's one of ``wkv6.cu``'s,
    B9's ``(state, head_dim)`` one of ``ssd_scan.cu``'s; a quantized
    kernel's row count one that ``quant_ring._rows`` accepts;
  * **scale-trailer consistency** — the int8/fp8 hop message (payload ++
    bitcast f32 trailer, ``SCALE_BYTES`` per sub-block) must agree with
    ``compressed_wire_bytes``, ``fused_wire_bytes``, the scheduler's
    ``rar_compressed_bytes_per_worker`` and ``HopMessageLayout``, and
    ``SCALE_BYTES`` must equal the f32 itemsize the bitcast assumes; the
    bf16 message is the bare 2-byte payload.

The constants come from the ``.cu`` sources, not from a copy: every
``constexpr int k... = ...;`` at file scope, each kernel's
``__launch_bounds__`` and each ``DISPATCH``'s cases are read with regular
expressions, and so is each ``constexpr`` shared-memory size function
(``fwd_floats``, ``dkdv_smem`` and the others): its ``return`` expression
is evaluated over those constants (:func:`source_formulas`). The card's
report of the dynamic bytes each launcher passes holds that reading to the
compiled code.

``--execute`` runs each accepted small configuration of the quantized-ring
kernels through their wrappers and checks the packed message length: on the
card through the CUDA kernels (the counterpart of interpret mode), with
``--device cpu`` through the plain versions. On the card the same run reads
every kernel instantiation's resources with the ``*_launch_config`` query
each ``.cu`` exports (``cudaFuncGetAttributes`` and
``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the launcher's threads
and dynamic bytes), predicts its blocks per SM from Hopper's limits
(:func:`predicted_blocks_per_sm`) and holds the prediction to the occupancy
API's; a spill to local memory is a warning, as lane misalignment is in the
reference.
"""

from __future__ import annotations

import argparse
import ast
import ctypes
import dataclasses
import functools
import operator
import re
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["KernelSpec", "FlashSpec", "WkvSpec", "SsdSpec", "Launch",
           "CheckResult", "check_spec", "default_suite",
           "predicted_blocks_per_sm", "card_launch_configs", "main"]

CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"

# Hopper's limits (H100, compute capability 9.0: the CUDA programming
# guide's table of compute capabilities, and the CUDA toolkit's
# cuda_occupancy.h for the allocation units)
MAX_THREADS_PER_BLOCK = 1024
WARP = 32
SMEM_PER_BLOCK = 232_448          # what a block can opt into, dynamic
SMEM_PER_SM = 233_472
RESERVED_SMEM_PER_BLOCK = 1_024   # the runtime's own, on every block
SMEM_UNIT = 128                   # shared memory is allocated in these
THREADS_PER_SM = 2_048
BLOCKS_PER_SM = 32
REGS_PER_SM = 65_536
REG_UNIT = 256                    # registers a warp are allocated in these
SUB_PARTITIONS = 4                # an SM's register file is split four ways
GRID_X_MAX = 2 ** 31 - 1
GRID_YZ_MAX = 65_535
# what the reference gates --execute on: configurations this small run
EXECUTE_MAX_ELEMENTS = 1 << 20

FLOAT_BYTES = 4
TYPES = {False: "float", True: "__nv_bfloat16"}


# ---------------------------------------------------------------------------
# constants read from the sources
# ---------------------------------------------------------------------------

_CONSTEXPR = re.compile(r"^constexpr int (k\w+) = ([^;]+);", re.M)
_BOUNDS = re.compile(r"__launch_bounds__\(([^,)]+)(?:,\s*\d+)?\)\s*(\w+)\s*\(")
_FA_CASE = re.compile(r"case (\d+): return bf16 \?")
_SSD_CASE = re.compile(r"if \(state == (\d+) && head_dim == (\d+)\)")
_FLOATS = re.compile(r"template <([^>]*)>\s*__host__ __device__ constexpr int "
                     r"(\w+_floats)\(\) \{\s*return (.*?);\s*\}", re.S)
_SMEM = re.compile(r"template <([^>]*)>\s*constexpr size_t (\w+_smem)\(\) "
                   r"\{(?:\s*//[^\n]*)?\s*return (.*?);\s*\}", re.S)
_TEMPLATE_CALL = re.compile(r"(\w+)<([^<>()]*)>\(\)")
_COMPARE = {ast.Gt: operator.gt, ast.Lt: operator.lt, ast.GtE: operator.ge,
            ast.LtE: operator.le, ast.Eq: operator.eq}


def _int_expr(text: str, names: Dict[str, int],
              calls: Optional[Dict[str, Callable[[], int]]] = None) -> int:
    """An integer C expression of literals, names, + - * / and parentheses
    (``/`` truncating, as C's on these positive operands), comparisons,
    ``a if c else b`` (C's ``c ? a : b``, rewritten) and calls without
    arguments of ``calls``."""
    def ev(node) -> int:
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.Name):
            return names[node.id]
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return -ev(node.operand)
        if isinstance(node, ast.BinOp):
            a, b = ev(node.left), ev(node.right)
            if isinstance(node.op, ast.Add):
                return a + b
            if isinstance(node.op, ast.Sub):
                return a - b
            if isinstance(node.op, ast.Mult):
                return a * b
            if isinstance(node.op, ast.Div):
                return a // b
        if isinstance(node, ast.IfExp):
            return ev(node.body) if ev(node.test) else ev(node.orelse)
        if isinstance(node, ast.Compare) and len(node.ops) == 1 and \
                type(node.ops[0]) in _COMPARE:
            return int(_COMPARE[type(node.ops[0])](
                ev(node.left), ev(node.comparators[0])))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and not node.args and calls and node.func.id in calls:
            return calls[node.func.id]()
        raise ValueError(f"not an integer C expression: {text!r}")
    return ev(ast.parse(text.strip(), mode="eval"))


def _source(name: str) -> str:
    return (CSRC / f"{name}.cu").read_text()


@functools.lru_cache(maxsize=None)
def source_constants(name: str) -> Dict[str, int]:
    """Every ``constexpr int k... = ...;`` at file scope of
    ``csrc/<name>.cu``, evaluated in order."""
    out: Dict[str, int] = {}
    for m in _CONSTEXPR.finditer(_source(name)):
        out[m.group(1)] = _int_expr(m.group(2), out)
    return out


@functools.lru_cache(maxsize=None)
def launch_bounds(name: str) -> Dict[str, int]:
    """Each ``__global__`` function of ``csrc/<name>.cu`` and the block
    size its ``__launch_bounds__`` names."""
    consts = source_constants(name)
    return {m.group(2): _int_expr(m.group(1), consts)
            for m in _BOUNDS.finditer(_source(name))}


@functools.lru_cache(maxsize=None)
def flash_head_dims() -> Tuple[int, ...]:
    """The head dims ``flash_attention.cu``'s ``DISPATCH`` instantiates."""
    return tuple(int(d) for d in _FA_CASE.findall(_source("flash_attention")))


@functools.lru_cache(maxsize=None)
def wkv_head_dims() -> Tuple[int, ...]:
    return tuple(int(d) for d in _FA_CASE.findall(_source("wkv6")))


@functools.lru_cache(maxsize=None)
def ssd_shapes() -> Tuple[Tuple[int, int], ...]:
    """The ``(state, head_dim)`` pairs ``ssd_scan.cu``'s ``DISPATCH``
    instantiates."""
    return tuple((int(n), int(p))
                 for n, p in _SSD_CASE.findall(_source("ssd_scan")))


# ---------------------------------------------------------------------------
# the shared-memory formulas of the sources
# ---------------------------------------------------------------------------

def _formula(name: str, params: Tuple[str, ...], body: str,
             funcs: Dict[str, Callable[..., int]], *args: int) -> int:
    if len(args) != len(params):
        raise TypeError(f"{name} takes template arguments {params}")
    env = {**source_constants(name), **dict(zip(params, args))}
    calls = {f: functools.partial(fn, *args) for f, fn in funcs.items()}
    return _int_expr(body, env, calls)


@functools.lru_cache(maxsize=None)
def source_formulas(name: str) -> Dict[str, Callable[..., int]]:
    """Each ``constexpr`` shared-memory size function of ``csrc/<name>.cu``
    (``*_floats`` in floats, ``*_smem`` in bytes) as a Python function of
    its template arguments, in their order: its ``return`` expression
    evaluated over the file's constants. A size function may call another
    at its own template arguments; any other call raises."""
    text = _source(name)
    funcs: Dict[str, Callable[..., int]] = {}
    for m in list(_FLOATS.finditer(text)) + list(_SMEM.finditer(text)):
        params = tuple(p.split()[-1] for p in m.group(1).split(","))
        body = " ".join(m.group(3).split()).replace("sizeof(float)",
                                                    str(FLOAT_BYTES))

        def call(c, fn=m.group(2), params=params):
            if tuple(a.strip() for a in c.group(2).split(",")) != params:
                raise ValueError(f"{fn} calls {c.group(0)} at other "
                                 f"template arguments than its {params}")
            return f"{c.group(1)}()"
        body = _TEMPLATE_CALL.sub(call, body)
        if "?" in body:   # C's c ? a : b
            cond, rest = body.split("?")
            then, other = rest.split(":")
            body = f"({then}) if ({cond}) else ({other})"
        funcs[m.group(2)] = functools.partial(_formula, name, params, body,
                                              funcs)
    return funcs


# ---------------------------------------------------------------------------
# the specs and the launches their wrappers make
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch: its display name, source, ``__global__``
    function, grid, threads a block and dynamic shared bytes."""

    kernel: str
    source: str
    function: str
    grid: Tuple[int, int, int]
    threads: int
    smem: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


# the quantized-ring kernels: counter name -> __global__ function
_QUANT_FUNCTIONS = {
    "quantize_pack": "quantize_pack_kernel",
    "dequant_add_quantize": "dequant_add_quantize_kernel",
    "dequant_accumulate": "dequant_accumulate_kernel",
    "dequant": "dequant_kernel",
}
_QUANT_FUNCTIONS.update({f"{k}_fp8": v for k, v in _QUANT_FUNCTIONS.items()})
_BF16_KERNELS = ("cast_pack_bf16", "bf16_add_cast", "bf16_accumulate",
                 "bf16_upcast")
_QUANT_FUNCTIONS.update({k: f"{k}_kernel" for k in _BF16_KERNELS})


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One ``(n_blocks, block)`` configuration of a quantized-ring kernel
    (``kernel`` names its launch counter in ``quant_ring.LAUNCHES``).

    ``scale_bytes`` overrides the trailer bytes a scale the spec claims to
    put on the wire (default: the kernels' ``SCALE_BYTES``). Any value
    other than the f32 itemsize the bitcast trailer emits must be rejected
    by the trailer check — the must-reject suite pins this with the same
    :data:`repro_torch.analysis.fixtures.TRAILER_MISMATCH_SCALE_BYTES`
    layout the collective verifier's broken-trailer ring uses.
    """

    n_blocks: int
    block: int
    kernel: str = "quantize_pack"
    scale_bytes: Optional[int] = None

    @property
    def bf16(self) -> bool:
        return self.kernel in _BF16_KERNELS

    @property
    def elements(self) -> int:
        return self.n_blocks * self.block

    def __str__(self) -> str:
        sb = "" if self.scale_bytes is None else \
            f", scale_bytes={self.scale_bytes}"
        return f"{self.kernel}(n_blocks={self.n_blocks}, " \
               f"block={self.block}{sb})"

    def launches(self) -> Tuple[List[Launch], List[str]]:
        from repro_torch.kernels import quant_ring

        errors: List[str] = []
        if self.kernel not in _QUANT_FUNCTIONS:
            return [], [f"unknown kernel {self.kernel!r} (known: "
                        f"{sorted(_QUANT_FUNCTIONS)})"]
        if self.n_blocks < 1 or self.block < 1:
            return [], ["n_blocks and block must be >= 1"]
        import torch

        try:  # the wrappers' own row check, on a tensor that holds no data
            quant_ring._rows(torch.empty((self.n_blocks, self.block),
                                         device="meta"), "x")
        except ValueError as exc:
            errors.append(f"quant_ring._rows rejects it: {exc}")
        k = source_constants("quant_ring")
        fn = _QUANT_FUNCTIONS[self.kernel]
        if self.kernel == "cast_pack_bf16":
            per_block = 4 * k["kCastVecs"] * k["kCastThreads"]
            grid, threads = min(_ceil(self.elements, per_block), GRID_X_MAX), \
                k["kCastThreads"]
        elif self.bf16:   # one block a kFlatThreads elements, at most 16 an SM
            grid = min(_ceil(self.elements, k["kFlatThreads"]), 132 * 16)
            threads = k["kFlatThreads"]
        else:             # one block a row
            grid, threads = self.n_blocks, k["kRowThreads"]
        errors.extend(_check_trailer_consistency(self))
        return [Launch(self.kernel, "quant_ring", fn, (grid, 1, 1), threads,
                       0)], errors


@dataclasses.dataclass(frozen=True)
class FlashSpec:
    """B4 (flash attention) on ``(batch, seq, heads, head_dim)`` q with
    ``kv_heads`` k/v heads (``heads`` by default): its four kernels'
    launches, forward and backward."""

    batch: int
    seq: int
    heads: int
    head_dim: int
    kv_heads: Optional[int] = None
    bf16: bool = False

    def __str__(self) -> str:
        return (f"B4(batch={self.batch}, seq={self.seq}, heads={self.heads}, "
                f"kv_heads={self.kv_heads or self.heads}, "
                f"head_dim={self.head_dim}, {TYPES[self.bf16]})")

    def launches(self) -> Tuple[List[Launch], List[str]]:
        k = source_constants("flash_attention")
        f = source_formulas("flash_attention")
        d, t = self.head_dim, TYPES[self.bf16]
        hkv = self.kv_heads or self.heads
        errors = []
        if d not in flash_head_dims():
            errors.append(f"head_dim {d} is not one DISPATCH instantiates "
                          f"{flash_head_dims()}")
        if self.heads % hkv:
            errors.append(f"{self.heads} q heads do not group over {hkv} "
                          "kv heads")
        tiles = _ceil(self.seq, k["kMmaRows"])
        q_blocks = tiles * self.heads * self.batch
        rows_per_block = k["kThreads"] // WARP
        # F3: a pair of kv tiles a block, one above kDkdvPairMaxDim
        kv_tiles = tiles if d > k["kDkdvPairMaxDim"] else _ceil(tiles, 2)
        return [
            Launch(f"F1 fwd_kernel<{d}, {t}>", "flash_attention",
                   "fwd_kernel", (q_blocks, 1, 1), k["kMmaThreads"],
                   f["fwd_smem"](d)),
            Launch(f"F2 bwd_preprocess_kernel<{d}, {t}>", "flash_attention",
                   "bwd_preprocess_kernel",
                   (_ceil(self.batch * self.seq * self.heads, rows_per_block),
                    1, 1), k["kThreads"], 0),
            Launch(f"F3 bwd_dkdv_kernel<{d}, {t}>", "flash_attention",
                   "bwd_dkdv_kernel",
                   (kv_tiles * hkv * self.batch, 1, 1),
                   k["kDkdvGroups"] * k["kMmaThreads"], f["dkdv_launch_smem"](d)),
            Launch(f"F4 bwd_dq_kernel<{d}, {t}>", "flash_attention",
                   "bwd_dq_kernel", (q_blocks, 1, 1), k["kMmaThreads"],
                   f["dq_smem"](d)),
        ], errors


@dataclasses.dataclass(frozen=True)
class WkvSpec:
    """B8 (RWKV6's WKV) on ``(batch, seq, heads, head_dim)``: W1's and
    W2's kernels' launches."""

    batch: int
    seq: int
    heads: int
    head_dim: int = 64
    bf16: bool = False

    def __str__(self) -> str:
        return (f"B8(batch={self.batch}, seq={self.seq}, heads={self.heads}, "
                f"head_dim={self.head_dim}, {TYPES[self.bf16]})")

    def launches(self) -> Tuple[List[Launch], List[str]]:
        from repro_torch.kernels.rwkv6_wkv import WKV_CHUNK

        k, f = source_constants("wkv6"), source_formulas("wkv6")
        p, t, th = self.head_dim, TYPES[self.bf16], k["kThreads"]
        errors = []
        if p not in wkv_head_dims():
            errors.append(f"head_dim {p} is not one DISPATCH instantiates "
                          f"{wkv_head_dims()}")
        lc = min(WKV_CHUNK, self.seq)
        if lc > k["kL"]:
            errors.append(f"chunk {lc} exceeds the kernels' {k['kL']}")
        chunks = (_ceil(self.seq, lc), self.batch, self.heads)
        passes = (self.batch * self.heads, _ceil(p * p // 4, th), 1)
        return [
            Launch(f"W1 chunk_sum_kernel<{p}, {t}, false>", "wkv6",
                   "chunk_sum_kernel", chunks, th, 0),
            Launch(f"W1 pass_kernel<{p}, false>", "wkv6", "pass_kernel",
                   passes, th, 0),
            Launch(f"W1 fwd_out_kernel<{p}, {t}>", "wkv6", "fwd_out_kernel",
                   chunks, th, FLOAT_BYTES * f["fwd_floats"](p)),
            Launch(f"W2 chunk_sum_kernel<{p}, {t}, true>", "wkv6",
                   "chunk_sum_kernel", chunks, th, 0),
            Launch(f"W2 pass_kernel<{p}, true>", "wkv6", "pass_kernel",
                   passes, th, 0),
            Launch(f"W2 bwd_chunk_kernel<{p}, {t}>", "wkv6",
                   "bwd_chunk_kernel", chunks, th,
                   FLOAT_BYTES * f["bwd_floats"](p)),
            Launch(f"W2 du_finish_kernel<{p}>", "wkv6", "du_finish_kernel",
                   (_ceil(self.heads * p, th), 1, 1), th, 0),
        ], errors


def _group_of(heads: int, most: int) -> int:
    """``ssd_scan.cu``'s ``group_of``: the largest divisor of ``heads`` up
    to ``most``."""
    return next(g for g in range(most, 0, -1) if heads % g == 0)


@dataclasses.dataclass(frozen=True)
class SsdSpec:
    """B9 (Mamba2's SSD scan) on x ``(batch, seq, heads, head_dim)`` with
    ``state`` N: S1's and S2's kernels' launches."""

    batch: int
    seq: int
    heads: int
    head_dim: int
    state: int
    bf16: bool = False

    def __str__(self) -> str:
        return (f"B9(batch={self.batch}, seq={self.seq}, heads={self.heads}, "
                f"head_dim={self.head_dim}, state={self.state}, "
                f"{TYPES[self.bf16]})")

    def launches(self) -> Tuple[List[Launch], List[str]]:
        from repro_torch.kernels.ssd_scan import SSD_CHUNK, _heads_per_block

        k, f = source_constants("ssd_scan"), source_formulas("ssd_scan")
        n, p, t, th = self.state, self.head_dim, TYPES[self.bf16], \
            k["kThreads"]
        errors = []
        if (n, p) not in ssd_shapes():
            errors.append(f"(state, head_dim) {(n, p)} is not one DISPATCH "
                          f"instantiates {ssd_shapes()}")
        lc = min(SSD_CHUNK, self.seq)
        if lc > k["kL"]:
            errors.append(f"chunk {lc} exceeds the kernels' {k['kL']}")
        nc, b, h = _ceil(self.seq, lc), self.batch, self.heads
        sums = (nc, b, h // _group_of(h, k["kSumHeads"]) + 1)
        passes = (b * h, _ceil(n * p // 4, th), 1)
        sum_bytes = FLOAT_BYTES * f["sum_floats"](n, p)
        return [
            Launch(f"S1 chunk_sum_kernel<{n}, {p}, {t}, false>", "ssd_scan",
                   "chunk_sum_kernel", sums, th, sum_bytes),
            Launch("S1 pass_kernel<false>", "ssd_scan", "pass_kernel",
                   passes, th, 0),
            Launch(f"S1 fwd_out_kernel<{n}, {p}, {t}>", "ssd_scan",
                   "fwd_out_kernel", (nc, b, h // _group_of(h, k["kFwdHeads"])),
                   th, FLOAT_BYTES * f["fwd_floats"](n, p)),
            Launch(f"S2 chunk_sum_kernel<{n}, {p}, {t}, true>", "ssd_scan",
                   "chunk_sum_kernel", sums, th, sum_bytes),
            Launch("S2 pass_kernel<true>", "ssd_scan", "pass_kernel", passes,
                   th, 0),
            Launch(f"S2 bwd_chunk_kernel<{n}, {p}, {t}>", "ssd_scan",
                   "bwd_chunk_kernel", (nc, b, h // _heads_per_block(h)), th,
                   FLOAT_BYTES * f["bwd_floats"](n, p)),
            Launch("S2 finish_kernel", "ssd_scan", "finish_kernel",
                   (_ceil(max(b * self.seq * n, h), th), 1, 1), th, 0),
        ], errors


Spec = Union[KernelSpec, FlashSpec, WkvSpec, SsdSpec]


@dataclasses.dataclass(frozen=True)
class CheckResult:
    spec: Spec
    ok: bool
    launches: Tuple[Launch, ...]
    errors: Tuple[str, ...]
    warnings: Tuple[str, ...]


def launch_errors(launch: Launch) -> List[str]:
    """The static checks of one launch against Hopper's limits and the
    kernel's ``__launch_bounds__``."""
    errors: List[str] = []
    name = launch.kernel
    if launch.threads > MAX_THREADS_PER_BLOCK or launch.threads % WARP:
        errors.append(f"{name}: {launch.threads} threads a block; a block "
                      f"takes at most {MAX_THREADS_PER_BLOCK}, whole warps "
                      f"of {WARP}")
    bound = launch_bounds(launch.source).get(launch.function)
    if bound != launch.threads:
        errors.append(f"{name}: launched with {launch.threads} threads but "
                      f"its __launch_bounds__ is {bound}")
    if launch.smem > SMEM_PER_BLOCK:
        errors.append(f"{name}: {launch.smem} B of dynamic shared memory; a "
                      f"block can opt into at most {SMEM_PER_BLOCK} B")
    x, y, z = launch.grid
    if min(launch.grid) < 1 or x > GRID_X_MAX or max(y, z) > GRID_YZ_MAX:
        errors.append(f"{name}: grid {launch.grid}; x must be in [1, "
                      f"{GRID_X_MAX}], y and z in [1, {GRID_YZ_MAX}]")
    return errors


def check_spec(spec: Spec) -> CheckResult:
    """Statically validate one configuration (no device)."""
    launches, errors = spec.launches()
    for launch in launches:
        errors.extend(launch_errors(launch))
    return CheckResult(spec, not errors, tuple(launches), tuple(errors), ())


def _check_trailer_consistency(spec: KernelSpec) -> List[str]:
    """The hop message of ``(n_blocks, block)`` against the byte formulas.

    An int8 or fp8 message is ``n_blocks * block`` payload bytes plus
    ``SCALE_BYTES`` a sub-block, as ``HopMessageLayout`` lays it out; a
    bf16 message is the bare 2-byte payload. The fused ring pays ``2(w-1)``
    such messages an all-reduce, and ``compressed_wire_bytes`` /
    ``fused_wire_bytes`` (the executable accounting) and
    ``rar_compressed_bytes_per_worker`` (the scheduler's Eq. (1) pricing)
    must reproduce that total for a gradient that shards evenly.
    """
    from repro_torch.core.rar_model import rar_compressed_bytes_per_worker
    from repro_torch.dist.compression import (
        compressed_wire_bytes,
        fused_wire_bytes,
    )
    from repro_torch.kernels.quant_ring import SCALE_BYTES, hop_message_layout

    errors: List[str] = []
    nb, block = spec.n_blocks, spec.block
    layout = hop_message_layout(nb * block, block=block)
    if spec.bf16:
        if spec.scale_bytes is not None:
            errors.append(f"scale_bytes={spec.scale_bytes} on the bf16 wire, "
                          "which carries no scale trailer")
        message = 2 * nb * block
        for w in (2, 4):
            d = w * nb * block
            expect = 2 * (w - 1) * message
            wire = float(fused_wire_bytes(d, w, wire="bf16", block=block))
            model = float(rar_compressed_bytes_per_worker(
                float(d), w, fused=True, block=block, payload_elem_bytes=2,
                trailer=False))
            if wire != float(expect) or abs(model - expect) > 1e-6 * expect:
                errors.append(
                    f"bf16 wire drift (w={w}): the ring sends {expect} B but "
                    f"fused_wire_bytes prices {wire!r} B and rar_model "
                    f"{model!r} B")
        return errors

    f32_bytes = np.dtype(np.float32).itemsize
    scale_bytes = SCALE_BYTES if spec.scale_bytes is None else \
        int(spec.scale_bytes)
    if scale_bytes != f32_bytes:
        errors.append(
            f"trailer scale_bytes={scale_bytes} != f32 itemsize "
            f"{f32_bytes} — the bitcast trailer the kernels emit does not "
            "match this wire layout")
    message = nb * block + scale_bytes * nb  # payload ++ trailer
    if layout.message_bytes != message:
        errors.append(
            f"HopMessageLayout packs {layout.message_bytes} B but this "
            f"layout claims {message} B")
    for w in (2, 4):
        d = w * nb * block  # shards into w chunks of exactly (nb, block)
        expect = 2 * (w - 1) * message
        wire = float(compressed_wire_bytes(d, w, fused=True, block=block))
        if wire != float(expect):
            errors.append(
                f"trailer drift (w={w}): kernels send "
                f"2*(w-1)*({nb}*{block} + {SCALE_BYTES}*{nb}) = {expect} B "
                f"but compressed_wire_bytes prices {wire!r} B")
        model = float(rar_compressed_bytes_per_worker(
            float(d), w, fused=True, block=block))
        if abs(model - expect) > 1e-6 * expect:
            errors.append(
                f"pricing drift (w={w}): rar_model prices {model!r} B but "
                f"the fused ring sends {expect} B")
    return errors


# ---------------------------------------------------------------------------
# execution: the wrappers at an accepted small configuration
# ---------------------------------------------------------------------------

def execute_spec(spec: KernelSpec, device: str = "cuda") -> Optional[str]:
    """Run an accepted quantized-ring configuration through its wrapper on
    ``device`` (the CUDA kernel on a card, the plain version on the CPU)
    and check the packed message's length. Returns an error string, or
    None on success."""
    import torch

    from repro_torch.dist.compression import pack_hop_message
    from repro_torch.kernels import quant_ring as qr

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (spec.n_blocks, spec.block)).astype(np.float32)).to(device)
    base = spec.kernel.removesuffix("_fp8")
    layout = qr.hop_message_layout(spec.elements, block=spec.block)
    if spec.bf16:
        payload = qr.cast_pack_bf16(x)
        if base == "bf16_add_cast":
            payload = qr.bf16_add_cast(payload, x)
        elif base in ("bf16_accumulate", "bf16_upcast"):
            out = qr.bf16_accumulate(
                payload, x if base == "bf16_accumulate" else None)
            return None if out.shape == x.shape else \
                f"upcast output shape {tuple(out.shape)} != {tuple(x.shape)}"
        got = payload.numel() * payload.element_size()
        expect = 2 * layout.payload_bytes
    else:
        wire = qr.FP8_DTYPE if spec.kernel.endswith("_fp8") else torch.int8
        q, scales = qr.quantize_pack(x, wire)
        if base == "dequant_add_quantize":
            q, scales = qr.dequant_add_quantize(q, scales, x)
        elif base in ("dequant_accumulate", "dequant"):
            out = qr.dequant_accumulate(
                q, scales, x if base == "dequant_accumulate" else None)
            return None if out.shape == x.shape else \
                f"dequant output shape {tuple(out.shape)} != {tuple(x.shape)}"
        got = pack_hop_message(q, scales).numel()
        expect = layout.message_bytes
    if got != expect:
        return (f"packed message is {got} B, expected "
                f"{'the bf16 payload' if spec.bf16 else 'payload+trailer'} "
                f"= {expect} B")
    return None


# ---------------------------------------------------------------------------
# resources on the card
# ---------------------------------------------------------------------------

def predicted_blocks_per_sm(registers: int, static_smem: int,
                            dynamic_smem: int, threads: int) -> int:
    """Blocks of a kernel that fit on one SM: the least of the limits of
    threads, blocks, registers (allocated a warp at a time in units of
    :data:`REG_UNIT`, in each of the :data:`SUB_PARTITIONS`) and shared
    memory (static + dynamic + the runtime's reserved 1 KB a block, in
    units of :data:`SMEM_UNIT`), as ``cudaOccupancyMaxActiveBlocksPer
    Multiprocessor`` computes them for compute capability 9.0."""
    warps = _ceil(threads, WARP)
    by_threads = (THREADS_PER_SM // WARP) // warps
    regs_per_warp = _ceil(registers * WARP, REG_UNIT) * REG_UNIT
    if regs_per_warp * _ceil(warps, SUB_PARTITIONS) * SUB_PARTITIONS \
            > REGS_PER_SM:
        return 0
    by_regs = BLOCKS_PER_SM if not regs_per_warp else \
        (REGS_PER_SM // SUB_PARTITIONS // regs_per_warp) * SUB_PARTITIONS \
        // warps
    smem = _ceil(static_smem + dynamic_smem + RESERVED_SMEM_PER_BLOCK,
                 SMEM_UNIT) * SMEM_UNIT
    if dynamic_smem > SMEM_PER_BLOCK or smem > SMEM_PER_SM:
        return 0
    return min(by_threads, BLOCKS_PER_SM, by_regs, SMEM_PER_SM // smem)


# which index of each source's *_launch_config query, its kernel's name
# (template arguments filled in below) and whether it depends on the
# query's dtype argument
_FA_QUERY = (("F1 fwd_kernel<{d}, {t}>", "fwd_kernel"),
             ("F2 bwd_preprocess_kernel<{d}, {t}>", "bwd_preprocess_kernel"),
             ("F3 bwd_dkdv_kernel<{d}, {t}>", "bwd_dkdv_kernel"),
             ("F4 bwd_dq_kernel<{d}, {t}>", "bwd_dq_kernel"))
_WKV_QUERY = (("W1 chunk_sum_kernel<{p}, {t}, false>", "chunk_sum_kernel"),
              ("W1 pass_kernel<{p}, false>", "pass_kernel"),
              ("W1 fwd_out_kernel<{p}, {t}>", "fwd_out_kernel"),
              ("W2 chunk_sum_kernel<{p}, {t}, true>", "chunk_sum_kernel"),
              ("W2 pass_kernel<{p}, true>", "pass_kernel"),
              ("W2 bwd_chunk_kernel<{p}, {t}>", "bwd_chunk_kernel"),
              ("W2 du_finish_kernel<{p}>", "du_finish_kernel"))
_SSD_QUERY = (("S1 chunk_sum_kernel<{n}, {p}, {t}, false>", "chunk_sum_kernel"),
              ("S1 pass_kernel<false>", "pass_kernel"),
              ("S1 fwd_out_kernel<{n}, {p}, {t}>", "fwd_out_kernel"),
              ("S2 chunk_sum_kernel<{n}, {p}, {t}, true>", "chunk_sum_kernel"),
              ("S2 pass_kernel<true>", "pass_kernel"),
              ("S2 bwd_chunk_kernel<{n}, {p}, {t}>", "bwd_chunk_kernel"),
              ("S2 finish_kernel", "finish_kernel"))


def _instantiations() -> List[Tuple[str, str, str, Tuple[int, ...], int]]:
    """``(name, source, function, query arguments, static dynamic bytes)``
    of every kernel instantiation the wrappers can launch, each once."""
    from repro_torch.kernels.quant_ring import LAUNCHES

    out = [(name, "quant_ring", _QUANT_FUNCTIONS[name], (i,), 0)
           for i, name in enumerate(LAUNCHES)]
    f = source_formulas("flash_attention")
    for d in flash_head_dims():
        smem = (f["fwd_smem"](d), 0, f["dkdv_launch_smem"](d), f["dq_smem"](d))
        for bf16 in (0, 1):
            for which, (fmt, fn) in enumerate(_FA_QUERY):
                out.append((fmt.format(d=d, t=TYPES[bool(bf16)]),
                            "flash_attention", fn, (which, d, bf16),
                            smem[which]))
    f = source_formulas("wkv6")
    for p in wkv_head_dims():
        smem = (0, 0, FLOAT_BYTES * f["fwd_floats"](p), 0, 0,
                FLOAT_BYTES * f["bwd_floats"](p), 0)
        for bf16 in (0, 1):
            for which, (fmt, fn) in enumerate(_WKV_QUERY):
                if bf16 and "{t}" not in fmt:
                    continue   # no dtype in its template: once is enough
                out.append((fmt.format(p=p, t=TYPES[bool(bf16)]), "wkv6", fn,
                            (which, p, bf16), smem[which]))
    # AdamW's leaf update, in adamw_launch_config's order
    for which, (tp, tg) in enumerate(((False, False), (False, True),
                                      (True, False), (True, True))):
        out.append((f"adamw_kernel<{TYPES[tp]}, {TYPES[tg]}>", "adamw",
                    "adamw_kernel", (which,), 0))
    f = source_formulas("ssd_scan")
    for i, (n, p) in enumerate(ssd_shapes()):
        sums = FLOAT_BYTES * f["sum_floats"](n, p)
        smem = (sums, 0, FLOAT_BYTES * f["fwd_floats"](n, p), sums, 0,
                FLOAT_BYTES * f["bwd_floats"](n, p), 0)
        for bf16 in (0, 1):
            for which, (fmt, fn) in enumerate(_SSD_QUERY):
                if (bf16 or i) and "{t}" not in fmt:
                    continue   # no template argument at all: once
                out.append((fmt.format(n=n, p=p, t=TYPES[bool(bf16)]),
                            "ssd_scan", fn, (which, n, p, bf16), smem[which]))
    return out


def _query(source: str, args: Tuple[int, ...]) -> List[int]:
    """The seven ints of ``<source>_launch_config(*args, out)``; raises on
    a cudaError."""
    from repro_torch.kernels import build

    fn = getattr(build.load(source), f"{source}_launch_config")
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    err = fn(*args, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{source}_launch_config{args} failed: "
                           f"cudaError {err}")
    return list(out)


def card_launch_configs() -> List[Dict]:
    """Every kernel instantiation's resources on the current card, its
    predicted and reported blocks per SM, and the checker's verdict
    (``ok``, ``warning: ...`` or ``reject: ...``). Needs a card: the
    kernels are built and queried; a query that fails raises."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the launch configs are read on a CUDA card; "
                           "none is available")
    rows = []
    for name, source, fn, args, want_smem in _instantiations():
        regs, static, local, max_threads, threads, smem, blocks = \
            _query(source, args)
        predicted = predicted_blocks_per_sm(regs, static, smem, threads)
        bound = launch_bounds(source).get(fn)
        problems = []
        if smem != want_smem:
            problems.append(f"its launcher passes {smem} B of dynamic shared "
                            f"memory, the checker's formula {want_smem} B")
        if max_threads != bound or threads != bound:
            problems.append(f"{threads} threads launched, {max_threads} "
                            f"allowed, __launch_bounds__ {bound}")
        if static + smem > SMEM_PER_BLOCK:
            problems.append(f"{static + smem} B of shared memory a block")
        if predicted != blocks:
            problems.append(f"predicted {predicted} blocks an SM, the "
                            f"occupancy API {blocks}")
        if problems:
            verdict = "reject: " + "; ".join(problems)
        elif local:
            verdict = f"warning: {local} B a thread spilled to local memory"
        else:
            verdict = "ok"
        rows.append({"kernel": name, "source": f"{source}.cu",
                     "registers": regs, "static_smem": static,
                     "dynamic_smem": smem, "local_bytes": local,
                     "threads": threads, "predicted_blocks_per_sm": predicted,
                     "reported_blocks_per_sm": blocks, "verdict": verdict})
    return rows


# ---------------------------------------------------------------------------
# the suite and the CLI
# ---------------------------------------------------------------------------

# the embed leaf's chunk of qwen3-0.6b at w=4, and phi3.5-moe-42b's
# we_gate leaf's, as (n_blocks, block) of the fused ring
EMBED_CHUNK_W4 = (9496, 4096)
WE_GATE_CHUNK_W4 = (25600, 4096)


def default_suite() -> List[Tuple[Spec, bool]]:
    """(spec, expected-to-pass) pairs exercised by the CLI and the tests.

    Accepted: the reference suite's three small quantized configurations,
    an fp8 and a bf16 one, the main paths' largest ring chunks, and B4, B8
    and B9 at the main paths' per-rank shapes. Rejected: a quantized
    kernel at 2^31 rows, B4 at head dim 96 (no instantiation) and at 256
    (F3 would need 399,872 B of shared memory), and the shared 2-byte
    trailer fixture the collective verifier's broken-trailer ring also
    seeds — one defect, caught by both analyses.
    """
    from repro_torch.analysis.fixtures import trailer_mismatch_kernel_spec

    return [
        (KernelSpec(64, 4096), True),
        (KernelSpec(512, 256, kernel="dequant_add_quantize"), True),
        (KernelSpec(7, 4096, kernel="dequant_accumulate"), True),
        (KernelSpec(64, 4096, kernel="dequant_add_quantize_fp8"), True),
        (KernelSpec(64, 4096, kernel="bf16_add_cast"), True),
        (KernelSpec(*EMBED_CHUNK_W4), True),
        (KernelSpec(*WE_GATE_CHUNK_W4, kernel="dequant_add_quantize"), True),
        (FlashSpec(2, 1024, 16, 128, kv_heads=8), True),
        (WkvSpec(2, 1024, 64, 64), True),
        (SsdSpec(2, 1024, 64, 64, state=64), True),
        (KernelSpec(2 ** 31, 4096), False),
        (FlashSpec(2, 1024, 16, 96, kv_heads=8), False),
        (FlashSpec(2, 1024, 16, 256, kv_heads=8), False),
        (trailer_mismatch_kernel_spec(), False),
    ]


def _parse_spec(text: str) -> KernelSpec:
    """``n_blocks,block[,kernel]`` from the --check flag."""
    parts = text.split(",")
    if len(parts) < 2:
        raise argparse.ArgumentTypeError(
            f"--check wants n_blocks,block[,kernel], got {text!r}")
    kernel = parts[2] if len(parts) > 2 and parts[2] else "quantize_pack"
    return KernelSpec(int(parts[0]), int(parts[1]), kernel)


def _print_result(result: CheckResult) -> None:
    verdict = "OK" if result.ok else "REJECT"
    smem = max((launch.smem for launch in result.launches), default=0)
    print(f"kernels: {verdict:6s} {result.spec}  {len(result.launches)} "
          f"launch(es), largest dynamic shared memory {smem} B")
    for w in result.warnings:
        print(f"kernels:   warning: {w}")
    for e in result.errors:
        print(f"kernels:   {e}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.kernels",
        description="launch-config checker for repro_torch.kernels "
                    "(module docstring has the rule list)")
    parser.add_argument("--check", action="append", type=_parse_spec,
                        metavar="NB,BLOCK[,KERNEL]", default=None,
                        help="check this quantized-ring config instead of "
                             "the default suite (repeatable); exit 1 if any "
                             "fails")
    parser.add_argument("--execute", action="store_true",
                        help="also run accepted small configs through the "
                             "wrappers and, on a card, read every kernel's "
                             "resources")
    parser.add_argument("--device", default="cuda",
                        help="where --execute runs (default: %(default)s; "
                             "cpu runs the plain versions)")
    args = parser.parse_args(argv)

    suite = [(s, True) for s in args.check] if args.check else \
        default_suite()
    failures = 0
    for spec, expect_ok in suite:
        result = check_spec(spec)
        _print_result(result)
        if result.ok != expect_ok:
            print(f"kernels:   EXPECTED {'OK' if expect_ok else 'REJECT'}")
            failures += 1
            continue
        # (no isinstance: run as __main__, this module's KernelSpec is not
        # the one the fixtures build)
        if args.execute and result.ok and hasattr(spec, "n_blocks") and \
                spec.elements <= EXECUTE_MAX_ELEMENTS:
            err = execute_spec(spec, args.device)
            if err is None:
                print(f"kernels:   executed on {args.device}: message length "
                      "OK")
            else:
                print(f"kernels:   execution on {args.device} FAILED: {err}")
                failures += 1
    if args.execute and args.device != "cpu":
        rows = card_launch_configs()
        for row in rows:
            print(f"kernels: {row['kernel']} ({row['source']}): "
                  f"{row['registers']} registers, {row['static_smem']} + "
                  f"{row['dynamic_smem']} B shared, {row['local_bytes']} B "
                  f"local, {row['threads']} threads, blocks an SM "
                  f"{row['predicted_blocks_per_sm']} predicted / "
                  f"{row['reported_blocks_per_sm']} reported: "
                  f"{row['verdict']}")
        bad = [r for r in rows if r["verdict"].startswith("reject")]
        failures += len(bad)
        print(f"kernels: {len(rows)} kernel instantiation(s) on the card, "
              f"{len(bad)} rejected")
    status = "OK" if not failures else f"{failures} unexpected outcome(s)"
    print(f"kernels: {len(suite)} config(s) -> {status}")
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
