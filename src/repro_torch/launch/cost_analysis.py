"""Roofline terms of a step run on DTensors (the counterpart of
``repro.launch.hlo_analysis``, which reads them off compiled SPMD HLO; the
port has no HLO, so it records the step's operators as they run).

:class:`OpCostModel` is a ``TorchDispatchMode``. It lets every operator on
DTensors pass to DTensor (returning ``NotImplemented``, as
``CommDebugMode`` does), so that it sees what each device runs: the local
operators on each device's shards, with their local shapes, and the
functional collectives DTensor issues to redistribute them. For each it
records

  * per-device flops: ``torch.utils.flop_counter``'s formula on the local
    shapes (which is the global count divided by the product of the mesh
    dims on which the output is ``Shard`` or ``Partial``; ``Replicate`` is
    work every device of that dim repeats). Flash attention is one operator
    a direction (``repro_torch::flash_attention_fwd``/``_bwd``) and gets its
    function's flops: the kernels' products on the (query, key) pairs the
    causal or sliding-window mask lets through, 4 d a pair forward and 14 d
    backward (F3's 8 d and F4's 6 d, each recomputing the scores) plus F2's
    2 d a row, as ``chip_smoke.fa_bound`` counts them; never the plain
    version's blockwise loop, which computes the masked half. RWKV6's WKV
    (``repro_torch::wkv6_fwd``/``_bwd``) and Mamba2's SSD
    (``repro_torch::ssd_scan_fwd``/``_bwd``) are one operator a direction
    too, priced as the products of the reference's chunked formulations
    (``repro.models.rwkv.wkv6_chunked`` at ``WKV_CHUNK``,
    ``repro.models.ssm.ssd_chunked`` at the config's ``ssm_chunk``), which
    is what the reference's HLO counts (:func:`wkv6_flops`,
    :func:`ssd_flops`), and their backward as twice that: each product's
    gradient to both of its operands (a carried state changes no product;
    flash attention at a query offset counts the pairs its mask lets
    through there);
  * per-device bytes: every operand read once and the result written once
    (PyTorch runs each operator alone, with nothing fused), the scans'
    initial state, final state and their gradients among them; views,
    aliases and uninitialised allocations move none;
  * collectives: their group size and per-device wire bytes by the
    reference's ring formulas (:func:`ring_wire`).

Operators that DTensor's sharding propagation runs on global shapes to
learn an output's shape are not recorded. Each row is named by the
innermost frame of this package that issued it (and, in backward, the
autograd node). Alongside, the mode follows every storage the step
allocates and reports the high-water mark of live bytes beyond the
arguments and the outputs.

Hardware constants (NVIDIA H100 SXM5 80GB datasheet): 989e12 dense bf16
flop/s and 3.35e12 B/s of HBM3. ``LINK_BW`` is 50e9 B/s a GPU: a 16-wide
"model" axis does not fit in one 8-GPU NVLink node, so its collectives
cross the node's ConnectX-7 NDR NICs (400 Gb/s, one a GPU); NVLink's 450
GB/s a direction would hold only inside a node.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.rwkv6_wkv import WKV_CHUNK

PEAK_FLOPS = 989e12          # bf16 dense per GPU (H100 SXM5 datasheet)
HBM_BW = 3.35e12             # bytes/s per GPU (HBM3, H100 SXM5 datasheet)
LINK_BW = 50e9               # bytes/s per GPU across nodes (ConnectX-7 NDR)

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# functional collective -> (kind, result bytes from input bytes and group)
_FUNCOLS = {
    "all_reduce": ("all-reduce", lambda n, g: n),
    "all_gather_into_tensor": ("all-gather", lambda n, g: n * g),
    "reduce_scatter_tensor": ("reduce-scatter", lambda n, g: n // g),
    "all_to_all_single": ("all-to-all", lambda n, g: n),
}
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_local_scalar_dense", "wait_tensor", "_wrap_tensor_autograd"}
FA_FWD_OP, FA_BWD_OP = "flash_attention_fwd", "flash_attention_bwd"
# the chunked recurrences' operators: name -> (rule, times the forward's)
WKV_OPS = {"wkv6_fwd": 1.0, "wkv6_bwd": 2.0}
SSD_OPS = {"ssd_scan_fwd": 1.0, "ssd_scan_bwd": 2.0}
_GLOBAL_PRODUCTS = {torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
                    torch.ops.aten.baddbmm}

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SELF = os.path.abspath(__file__)


def ring_wire(kind: str, nbytes: float, g: int) -> float:
    """Per-device bytes on the wire of one collective whose *result* is
    ``nbytes`` on each device, over a group of ``g``, by ring algorithms
    (the reference's ``parse_collectives``)."""
    if kind == "all-reduce":
        return 2.0 * nbytes * (g - 1) / max(g, 1)
    if kind == "all-gather":
        return nbytes * (g - 1) / max(g, 1)
    if kind == "reduce-scatter":
        return nbytes * (g - 1)
    if kind == "all-to-all":
        return nbytes * (g - 1) / max(g, 1)
    return float(nbytes)    # collective-permute: one hop


def visible_pairs(sq: int, skv: int, causal: bool, window: Optional[int],
                  q_offset: int = 0) -> int:
    """(query, key) pairs flash attention's mask lets through, query row
    ``i`` at position ``i + q_offset``."""
    q = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(q, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def attention_flops(name: str, q: torch.Tensor, k: torch.Tensor, causal: bool,
                    window: Optional[int], q_offset: int = 0) -> float:
    b, sq, hq, d = q.shape
    pairs = visible_pairs(sq, k.shape[1], causal, window, q_offset) * b * hq
    if name == FA_FWD_OP:
        return 4.0 * d * pairs
    return 14.0 * d * pairs + 2.0 * b * sq * hq * d


def wkv6_flops(b: int, s: int, h: int, p: int, chunk: int = WKV_CHUNK) -> float:
    """The products of the reference's chunked WKV forward over ``(B, S, H,
    P)`` (S padded to whole chunks of ``L = min(chunk, S)``): the pair
    scores and their values, ``4 B nc H L^2 P``; the chunk summaries and
    the carried state's readout, ``4 B nc H L P^2``; the bonus, ``2 B nc L
    H P``."""
    lc = min(chunk, s)
    nc = -(-s // lc)
    return float(4 * b * nc * h * lc * lc * p + 4 * b * nc * h * lc * p * p
                 + 2 * b * nc * lc * h * p)


def ssd_flops(b: int, s: int, h: int, p: int, n: int, chunk: int) -> float:
    """The products of the reference's chunked SSD forward over x ``(B, S,
    H, P)`` and a state of ``N`` (S padded to whole chunks of ``L =
    min(chunk, S)``): ``C B^T``, ``2 B nc L^2 N``; the intra-chunk values,
    ``2 B nc L^2 H P``; the chunk summaries and the state's readout,
    ``4 B nc L H N P``."""
    lc = min(chunk, s)
    nc = -(-s // lc)
    return float(2 * b * nc * lc * lc * n + 2 * b * nc * lc * lc * h * p
                 + 4 * b * nc * lc * h * n * p)


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    payload_bytes: Dict[str, float]    # per-device result-shape bytes summed
    wire_bytes: Dict[str, float]       # per-device bytes-on-wire (ring model)

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())


@dataclasses.dataclass
class OpCost:
    """Per-device totals of one run (the reference's ``HloCost``; an eager
    run visits every operator, so no loop is left unresolved)."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in _COLLECTIVES})
    coll_payload: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in _COLLECTIVES})
    coll_wire: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in _COLLECTIVES})
    unresolved_whiles: int = 0

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.coll_wire.values())


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _type_str(out) -> str:
    ts = _tensors(out)
    short = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
             torch.int64: "s64", torch.int32: "s32", torch.bool: "pred",
             torch.float64: "f64"}
    return ",".join(f"{short.get(t.dtype, str(t.dtype))}"
                    f"[{','.join(map(str, t.shape))}]" for t in ts)[:60]


def _group_size(group_name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group_name).size()


class _Storages:
    """Live bytes of the storages a run allocates: each new storage once
    (views share it), freed when its last tensor goes."""

    def __init__(self):
        self.ids: Dict[int, int] = {}        # id(storage) -> serial
        self.size: Dict[int, int] = {}       # serial -> bytes
        self.events: List[Tuple[int, int]] = []   # (serial, +1 alloc / -1 free)

    def add(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key in self.ids:
            return self.ids[key]
        serial = len(self.size)
        self.ids[key], self.size[serial] = serial, st.nbytes()
        self.events.append((serial, 1))
        weakref.finalize(st, self._free, key, serial)
        return serial

    def _free(self, key: int, serial: int) -> None:
        if self.ids.get(key) == serial:
            del self.ids[key]
        self.events.append((serial, -1))

    def high_water(self, skip: set) -> int:
        live = peak = 0
        for serial, sign in self.events:
            if serial not in skip:
                live += sign * self.size[serial]
                peak = max(peak, live)
        return peak


class OpCostModel(TorchDispatchMode):
    """Records every per-device operator of the code run inside it (module
    docstring). ``with OpCostModel() as cm: step(...)``; then
    :meth:`entry_cost`, :meth:`top_ops`, :meth:`scope_bytes` and
    :meth:`memory`. ``ssm_chunk`` is the chunk at which the SSD's operators
    are priced (the config's; by default the kernels' ``SSD_CHUNK``)."""

    def __init__(self, ssm_chunk: Optional[int] = None):
        super().__init__()
        if ssm_chunk is None:
            from repro_torch.kernels.ssd_scan import SSD_CHUNK as ssm_chunk
        self.ssm_chunk = ssm_chunk
        self.rows: List[dict] = []
        self.global_flops = 0.0      # of the DTensor-level products
        self.storages = _Storages()
        self._args: set = set()
        self._prop_code = None

    # -- arguments and outputs ----------------------------------------------
    def _locals(self, tree) -> List[torch.Tensor]:
        from torch.distributed.tensor import DTensor

        return [t.to_local() if isinstance(t, DTensor) else t
                for t in _tensors(tree)]

    def add_arguments(self, tree) -> int:
        """Mark the local tensors of ``tree`` as the run's arguments; their
        exact bytes (each storage once)."""
        for t in self._locals(tree):
            self._args.add(self.storages.add(t))
        return sum(self.storages.size[s] for s in self._args)

    def memory(self, outputs) -> Dict[str, float]:
        """The reference's ``memory_analysis`` keys: argument bytes, output
        bytes (storages of ``outputs`` not among the arguments) and the
        high-water mark of every other live storage."""
        outs = {self.storages.add(t) for t in self._locals(outputs)} - self._args
        return {
            "temp_size_in_bytes": float(self.storages.high_water(self._args | outs)),
            "argument_size_in_bytes": float(sum(self.storages.size[s]
                                                for s in self._args)),
            "output_size_in_bytes": float(sum(self.storages.size[s]
                                              for s in outs)),
        }

    # -- dispatch ------------------------------------------------------------
    def _site(self) -> Optional[str]:
        """The innermost frame of this package above the operator, or None
        inside DTensor's shape propagation."""
        if self._prop_code is None:
            from torch.distributed.tensor._sharding_prop import ShardingPropagator

            self._prop_code = ShardingPropagator._propagate_tensor_meta_non_cached.__code__
        f = sys._getframe(1)
        while f is not None:
            code = f.f_code
            if code is self._prop_code:
                return None
            fn = code.co_filename
            if fn.startswith(_ROOT) and fn != _SELF:
                rel = os.path.relpath(fn, _ROOT)
                return f"{rel}:{code.co_name}"
            f = f.f_back
        return ""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            self._global(func, args, kwargs)
            return NotImplemented
        out = func(*args, **kwargs)
        site = self._site()
        if site is not None:
            self._record(func, args, kwargs, out, site)
        return out

    def _global(self, func, args, kwargs) -> None:
        """Add a DTensor-level matrix product's flops on its global shapes
        (what ``FlopCounterMode`` entered above DTensor counts)."""
        packet = func._overloadpacket
        if packet in _GLOBAL_PRODUCTS:
            self.global_flops += float(flop_registry[packet](
                *args, **kwargs, out_val=None))

    def _record(self, func, args, kwargs, out, site: str) -> None:
        name = func._overloadpacket.__name__
        ns = func.namespace
        row = {"opcode": f"{ns}.{name}", "type": _type_str(out), "site": site,
               "flops": 0.0, "bytes": 0.0, "wire": 0.0, "kind": None,
               "payload": 0.0}
        node = torch._C._current_autograd_node()
        row["op_name"] = f"{node.name()} < {site}" if node is not None else site
        outs = _tensors(out)
        for t in outs:
            self.storages.add(t)
        if ns == "_c10d_functional" and name in _FUNCOLS:
            kind, result = _FUNCOLS[name]
            g = _group_size(args[-1])
            payload = result(_nbytes(_tensors(args[0])), g)
            row.update(kind=kind, payload=float(payload),
                       wire=ring_wire(kind, payload, g), group=g)
        elif ns == "_c10d_functional" and name not in _NO_TRAFFIC:
            raise NotImplementedError(f"no wire formula for {func}")
        if ns == "repro_torch" and name in (FA_FWD_OP, FA_BWD_OP):
            q, k = args[0], args[1]
            causal, window, q_offset = args[-3:]
            row["flops"] = attention_flops(name, q, k, causal, window, q_offset)
        elif ns == "repro_torch" and name in WKV_OPS:
            row["flops"] = WKV_OPS[name] * wkv6_flops(*args[0].shape)
        elif ns == "repro_torch" and name in SSD_OPS:
            row["flops"] = SSD_OPS[name] * ssd_flops(
                *args[0].shape, args[3].shape[-1], self.ssm_chunk)
        elif func._overloadpacket in flop_registry:
            row["flops"] = float(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
        operands = _nbytes(_tensors(args)) + _nbytes(_tensors(kwargs))
        if func.is_view or name in _NO_TRAFFIC or row["kind"]:
            pass
        elif func._schema.is_mutable:    # in place: the written operand once
            row["bytes"] = float(operands)
        else:
            row["bytes"] = float(operands + _nbytes(outs))
        self.rows.append(row)

    # -- the reference's interface -------------------------------------------
    def entry_cost(self) -> OpCost:
        cost = OpCost()
        for r in self.rows:
            cost.flops += r["flops"]
            cost.bytes += r["bytes"]
            if r["kind"]:
                cost.coll_counts[r["kind"]] += 1
                cost.coll_payload[r["kind"]] += r["payload"]
                cost.coll_wire[r["kind"]] += r["wire"]
        return cost

    def collectives(self) -> CollectiveStats:
        c = self.entry_cost()
        return CollectiveStats(counts={k: int(v) for k, v in c.coll_counts.items()},
                               payload_bytes=c.coll_payload,
                               wire_bytes=c.coll_wire)

    def top_ops(self, k: int = 15, metric: str = "bytes") -> List[dict]:
        """Largest byte / flop / collective-wire contributors: rows of one
        operator, result type, call site and per-call value, with ``mult``
        the number of such calls."""
        key = {"bytes": "bytes", "flops": "flops", "wire": "wire"}[metric]
        groups: Dict[tuple, dict] = {}
        for r in self.rows:
            val = r[key]
            if val <= 0:
                continue
            g = (r["opcode"], r["type"], r["op_name"], val)
            if g not in groups:
                groups[g] = {"total": 0.0, "per_exec": val, "mult": 0.0,
                             "opcode": r["opcode"], "type": r["type"],
                             "op_name": r["op_name"][-90:]}
            groups[g]["total"] += val
            groups[g]["mult"] += 1
        rows = sorted(groups.values(), key=lambda r: -r["total"])
        return rows[:k]

    def scope_bytes(self, scope: str) -> float:
        """Bytes of the operators whose name contains ``scope``."""
        return sum(r["bytes"] for r in self.rows if scope in r["op_name"])


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float
    collective_wire_bytes: float
    peak_memory_bytes: Optional[float]
    model_flops: float                 # 6*N*D analytical (or fwd-only variants)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_wire_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_fraction(self) -> float:
        total_hlo = self.flops_per_device * self.n_devices
        return self.model_flops / total_hlo if total_hlo else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak the dominant-term-bound step achieves on useful
        FLOPs: (model_flops / chips / peak) / max(term)."""
        ideal_s = self.model_flops / self.n_devices / PEAK_FLOPS
        worst = max(self.compute_s, self.memory_s, self.collective_s)
        return ideal_s / worst if worst else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_devices": self.n_devices,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_wire_bytes": self.collective_wire_bytes,
            "peak_memory_bytes": self.peak_memory_bytes,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for(arch_cfg, shape_cfg, n_params_active: float,
                    n_params_total: float) -> float:
    """Analytical MODEL_FLOPS: 6*N*D train, 2*N*D forward-only per token."""
    tokens = shape_cfg.global_batch * (
        shape_cfg.seq_len if shape_cfg.kind in ("train", "prefill") else 1)
    n = n_params_active
    if shape_cfg.kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens
