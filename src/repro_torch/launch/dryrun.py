"""Multi-pod dry run: every (arch x shape x mesh) cell's step on DTensors
over a fake mesh (the counterpart of ``repro.launch.dryrun``).

It runs as its own process (``python -m repro_torch.launch.dryrun``): it
starts a ``fake`` world of 256 or 512 ranks (``launch.mesh.
start_fake_world``), the counterpart of the reference's 512 placeholder
devices, and that is process-global. No device is used: parameters,
optimizer state and inputs are fake tensors (``FakeTensorMode``: shapes,
no storage) laid out on the mesh as DTensors, and the step runs on them
under ``activate(rules)`` and :class:`~repro_torch.launch.cost_analysis.
OpCostModel`, which records what one device runs.

For each cell it records the reference's keys:
  * ``memory``: the exact local bytes of the arguments (parameters,
    optimizer state, inputs), the high-water mark of live local bytes
    beyond them and the outputs, and the outputs' bytes;
  * per-device flops and bytes, and collective wire bytes by the ring
    formulas: the three roofline terms (H100 datasheet constants);
  * ``xla_cost_analysis`` keeps the reference's name for the framework's
    own count beside the per-device walk: here the matrix products' flops
    on global shapes, as ``FlopCounterMode`` entered above DTensor counts
    them (``bytes`` is None: there is no such count), and ``counted``, a
    statement of what the per-device counts are;
  * ``lower_s`` is the time to lay the cell out, ``compile_s`` that of the
    recorded run.

Every family runs on DTensors: the dense and VLM ``DenseLM``, the MoE, the
encoder-decoder, RWKV6 and Mamba2/Zamba2, all 33 cells on each mesh.
Results land in ``results/dryrun_torch/<mesh>/<arch>__<shape>.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.configs import SHAPES, get_arch, list_archs
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.dist.sharding import (
    ShardingRules,
    activate,
    make_rules,
    param_shardings,
    shard_of,
)
from repro_torch.launch.cost_analysis import (
    HBM_BW,
    OpCostModel,
    Roofline,
    model_flops_for,
)
from repro_torch.launch.mesh import make_production_mesh, start_fake_world
from repro_torch.models.model import build_model
from repro_torch.models.module import ParamSpec, _flatten, _unflatten
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_step import make_train_step

# what the per-device counts are, stated in every record
COUNTED = ("per device: each local operator's flops (torch.utils.flop_counter) "
           "and operand and result bytes; flash attention as its kernels' "
           "products on the (query, key) pairs its mask lets through, 4 d a "
           "pair forward, 14 d backward plus 2 d a row; RWKV6's WKV and "
           "Mamba2's SSD as the products of the reference's chunked forms "
           "(wkv6_chunked at WKV_CHUNK 32, ssd_chunked at the config's "
           "ssm_chunk) forward, twice that backward; collectives' wire bytes "
           "by ring formulas; the global flops here are the DTensor-level "
           "matrix products' on global shapes")
OUT_DIR = "results/dryrun_torch"


def active_params(cfg: ArchConfig) -> float:
    """Active (per-token) parameter count: MoE experts scaled by top_k/E."""
    model = build_model(cfg)
    total_active = 0.0
    for path, s in _flatten(model.param_specs()):
        n = float(np.prod(s.shape))
        if cfg.n_experts and "/we_" in f"/{path}":
            n *= cfg.top_k / cfg.n_experts
        total_active += n
    return total_active


def total_params(cfg: ArchConfig) -> float:
    model = build_model(cfg)
    return float(sum(np.prod(s.shape) for _, s in _flatten(model.param_specs())))


def adafactor_spec_tree(param_specs):
    """ParamSpec tree for adafactor stats (factored axes follow the param)."""
    def leaf(spec: ParamSpec):
        if len(spec.shape) >= 2:
            return {
                "vr": ParamSpec(spec.shape[:-1], spec.axes[:-1],
                                dtype=torch.float32, init="zeros"),
                "vc": ParamSpec(spec.shape[:-2] + spec.shape[-1:],
                                spec.axes[:-2] + spec.axes[-1:],
                                dtype=torch.float32, init="zeros"),
            }
        return {"v": ParamSpec(spec.shape, spec.axes, dtype=torch.float32,
                               init="zeros")}

    return _unflatten({p: leaf(s) for p, s in _flatten(param_specs)})


def opt_state_shardings(opt_name: str, rules: ShardingRules, param_specs) -> Dict:
    """Placements of the optimizer state: moments follow their parameter,
    the step counter is replicated."""
    psh = param_shardings(rules, param_specs)
    repl = rules.placements(())
    if opt_name == "adamw":
        return {"m": psh, "v": psh, "step": repl}
    if opt_name == "adafactor":
        return {"stats": param_shardings(rules, adafactor_spec_tree(param_specs)),
                "step": repl}
    if opt_name == "sgdm":
        return {"mom": psh, "step": repl}
    raise ValueError(opt_name)


def _on_mesh(rules: ShardingRules, t: torch.Tensor, placements) -> torch.Tensor:
    """A DTensor of ``t``'s shape and dtype with ``placements``, whose local
    shard is a new (fake, under ``FakeTensorMode``) tensor of its shape."""
    from torch.distributed.tensor import DTensor

    local, _ = shard_of(rules.mesh, placements, t.shape)
    stride, n = [], 1
    for d in reversed(t.shape):
        stride.insert(0, n)
        n *= d
    return DTensor.from_local(torch.zeros(local, dtype=t.dtype), rules.mesh,
                              placements, run_check=False, shape=t.shape,
                              stride=tuple(stride))


def _tree_on_mesh(rules, tree, placements):
    if isinstance(tree, dict):
        return {k: _tree_on_mesh(rules, v, placements[k]) for k, v in tree.items()}
    return _on_mesh(rules, tree, placements)


def _redistribute(tree, placements):
    if isinstance(tree, dict):
        return {k: _redistribute(v, placements[k]) for k, v in tree.items()}
    return tree.redistribute(tree.device_mesh, list(placements))


@dataclasses.dataclass
class Cell:
    """A laid-out cell: ``fn(*args)`` runs its step on the mesh."""
    fn: object
    args: tuple
    mesh: object
    cfg: ArchConfig
    shape: ShapeConfig


def build_cell(arch: Union[str, ArchConfig], shape_name: Union[str, ShapeConfig],
               *, multi_pod: bool,
               fsdp: Optional[bool] = None,
               sequence_parallel: Optional[bool] = None,
               remat: Optional[bool] = None,
               pure_dp: Optional[bool] = None,
               cache_seq_shard: Optional[bool] = None,
               moe_tp: Optional[bool] = None,
               mesh=None, param_dtype: torch.dtype = torch.bfloat16) -> Cell:
    """The cell's step and its arguments on the mesh, as the reference's
    ``build_cell``; call under ``FakeTensorMode`` with the fake world
    started (the arguments are then fake). ``mesh`` replaces the production mesh; ``arch`` and
    ``shape_name`` may be configs themselves; ``param_dtype`` is the
    parameters' dtype (bf16, as the reference's)."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    if fsdp is not None:
        cfg = dataclasses.replace(cfg, fsdp=fsdp)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    names = tuple(mesh.mesh_dim_names)
    data_size = int(np.prod([mesh.size(i) for i, a in enumerate(names)
                             if a in ("pod", "data")]))
    sp = (cfg.sequence_parallel or shape.kind == "prefill"
          if sequence_parallel is None else sequence_parallel)
    rules = make_rules(mesh, fsdp=cfg.fsdp, sequence_parallel=sp,
                       pure_dp=bool(pure_dp), moe_tp=bool(moe_tp))
    model = build_model(cfg)
    specs = model.param_specs()
    psh = param_shardings(rules, specs)
    params = _tree_on_mesh(rules, model.abstract_params(param_dtype), psh)
    divisible = shape.global_batch % data_size == 0

    def batch_on_mesh(inputs):
        return {k: _on_mesh(rules, v, rules.placements_for(
                    ("batch",) + (None,) * (v.dim() - 1)) if divisible
                    else rules.placements(())) for k, v in inputs.items()}

    if shape.kind == "train":
        optimizer = make_optimizer(cfg.optimizer)
        osh = opt_state_shardings(cfg.optimizer, rules, specs)
        opt = _tree_on_mesh(rules, optimizer.init(model.abstract_params(param_dtype)),
                            osh)
        step_fn = make_train_step(model, optimizer, lr=1e-4)
        batch = batch_on_mesh(model.input_specs(shape))

        def fn(params, opt_state, batch):
            with activate(rules):
                p, o, metrics = step_fn(params, opt_state, batch)
                return _redistribute(p, psh), _redistribute(o, osh), metrics

        args = (params, opt, batch)
    elif shape.kind == "prefill":
        batch = batch_on_mesh(model.input_specs(shape))

        def fn(params, batch):
            with activate(rules), torch.no_grad():
                logits, _ = model.forward(params, batch)
                return logits

        args = (params, batch)
    else:  # decode
        b = shape.global_batch
        cache_specs = model.cache_specs(b, shape.seq_len)
        # long-context single-sample decode: shard the cache seq dim over
        # the idle data axis instead of the (unshardable) batch dim
        if not divisible:
            rules.rules["batch"] = None
            rules.rules["seq"] = tuple(a for a in ("data",) if a in names)
        # kv_heads that do not divide the model axis leave the cache
        # replicated over it; shard its seq dim over "model" instead
        if cache_seq_shard is None:
            model_ways = mesh.size(names.index("model")) if "model" in names else 1
            cache_seq_shard = (cfg.n_kv_heads % model_ways != 0
                               and cfg.family not in ("ssm", "rwkv"))
        if cache_seq_shard:
            rules.rules["seq"] = "model"
        cache = _tree_on_mesh(rules, model.abstract_cache(b, shape.seq_len),
                              param_shardings(rules, cache_specs))
        tokens = batch_on_mesh({"tokens": torch.empty((b, 1), dtype=torch.int32,
                                                      device="meta")})["tokens"]

        def fn(params, cache, tokens):
            with activate(rules), torch.no_grad():
                return model.decode_step(params, cache, tokens, shape.seq_len - 1)

        args = (params, cache, tokens)
    return Cell(fn, args, mesh, cfg, shape)


def mesh_name_of(mesh) -> str:
    return "x".join(str(mesh.size(i)) for i in range(mesh.ndim))


def record_cell(arch, shape_name, *, multi_pod: bool, mesh=None,
                param_dtype: torch.dtype = torch.bfloat16, **overrides):
    """Lay the cell out and run it once under the cost model: ``(cost
    model, cell, memory, lay-out seconds, run seconds)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    # the arguments' shards are fake tensors; the step runs outside the
    # mode, where an operator on them is fake and one on small plain tensors
    # (DTensor's own index arithmetic, positions, masks) runs as it is
    with FakeTensorMode(allow_non_fake_inputs=True):
        cell = build_cell(arch, shape_name, multi_pod=multi_pod, mesh=mesh,
                          param_dtype=param_dtype, **overrides)
    t_lower = time.time() - t0
    cm = OpCostModel(ssm_chunk=cell.cfg.ssm_chunk)
    cm.add_arguments(cell.args)
    t0 = time.time()
    with cm:
        out = cell.fn(*cell.args)
    t_run = time.time() - t0
    return cm, cell, cm.memory(out), t_lower, t_run


def run_cell(arch, shape_name, *, multi_pod: bool, out_dir: Optional[str] = OUT_DIR,
             verbose: bool = True, mesh=None,
             param_dtype: torch.dtype = torch.bfloat16, **overrides) -> Dict:
    """Record the cell (:func:`record_cell`), write and return its record
    (``out_dir=None`` writes nothing)."""
    cm, cell, mem, t_lower, t_compile = record_cell(
        arch, shape_name, multi_pod=multi_pod, mesh=mesh,
        param_dtype=param_dtype, **overrides)
    cfg, shape, mesh = cell.cfg, cell.shape, cell.mesh
    mesh_name = mesh_name_of(mesh)
    arch_name = arch if isinstance(arch, str) else cfg.name
    shape_label = shape_name if isinstance(shape_name, str) else shape.name
    hc = cm.entry_cost()
    flash_bytes = cm.scope_bytes("flash_attention")
    n_active = active_params(cfg)
    n_total = total_params(cfg)
    rf = Roofline(
        arch=arch_name, shape=shape_label, mesh=mesh_name,
        n_devices=mesh.size(),
        flops_per_device=hc.flops,
        bytes_per_device=hc.bytes,
        collective_wire_bytes=hc.total_wire_bytes,
        peak_memory_bytes=mem["temp_size_in_bytes"],
        model_flops=model_flops_for(cfg, shape, n_active, n_total),
    )
    record = rf.to_dict()
    record.update({
        "xla_cost_analysis": {"flops": cm.global_flops, "bytes": None,
                              "counted": COUNTED},
        # the attention kernels' own I/O and their set-up: HBM traffic, since
        # no intermediate of the kernels reaches the record
        "flash_scope_bytes": flash_bytes,
        "memory_s_kernel_adjusted": hc.bytes / HBM_BW,
        "unresolved_whiles": hc.unresolved_whiles,
        "collective_counts": hc.coll_counts,
        "collective_payload_bytes": hc.coll_payload,
        "collective_wire_by_op": hc.coll_wire,
        "memory": mem,
        "lower_s": t_lower,
        "compile_s": t_compile,
        "n_params_total": n_total,
        "n_params_active": n_active,
        "overrides": {k: v for k, v in overrides.items() if v is not None},
    })
    suffix = ""
    if any(v is not None for v in overrides.values()):
        suffix = "__" + "_".join(f"{k}={v}" for k, v in sorted(overrides.items())
                                 if v is not None)
    if out_dir is not None:
        os.makedirs(os.path.join(out_dir, mesh_name), exist_ok=True)
        path = os.path.join(out_dir, mesh_name,
                            f"{arch_name}__{shape_label}{suffix}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
    if verbose:
        print(f"[dryrun] {mesh_name} {arch_name} {shape_label}{suffix}: "
              f"run={t_compile:.1f}s flops/dev={hc.flops:.3e} "
              f"bytes/dev={hc.bytes:.3e} wire={hc.total_wire_bytes:.3e} "
              f"bottleneck={record['bottleneck']} "
              f"roofline={record['roofline_fraction']:.3f} "
              f"useful={record['useful_flops_fraction']:.3f}", flush=True)
        print(f"  memory: {record['memory']}", flush=True)
    return record


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--arch", default=None, choices=list_archs() + [None])
    parser.add_argument("--shape", default=None,
                        choices=list(SHAPES) + [None])
    parser.add_argument("--multi-pod", action="store_true")
    parser.add_argument("--all", action="store_true",
                        help="run every supported (arch x shape) cell")
    parser.add_argument("--resume", action="store_true",
                        help="skip cells whose JSON already exists")
    parser.add_argument("--out", default=OUT_DIR)
    parser.add_argument("--fsdp", default=None, type=lambda s: s == "1")
    parser.add_argument("--pure-dp", dest="pure_dp", default=None,
                        type=lambda s: s == "1")
    parser.add_argument("--cache-seq-shard", dest="cache_seq_shard",
                        default=None, type=lambda s: s == "1")
    parser.add_argument("--moe-tp", dest="moe_tp", default=None,
                        type=lambda s: s == "1")
    parser.add_argument("--sp", dest="sequence_parallel", default=None,
                        type=lambda s: s == "1")
    parser.add_argument("--remat", default=None, type=lambda s: s == "1")
    args = parser.parse_args()

    cells = []
    if args.all:
        for arch in list_archs():
            for shape in get_arch(arch).supported_shapes():
                cells.append((arch, shape))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]

    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    print(f"[dryrun] fake mesh {mesh_name}: no device is used; every rank is "
          "a placeholder of one process (fake process group, fake tensors)",
          flush=True)
    start_fake_world(512 if args.multi_pod else 256)
    failures = []
    for arch, shape in cells:
        path = os.path.join(args.out, mesh_name, f"{arch}__{shape}.json")
        if args.resume and os.path.exists(path):
            print(f"[dryrun] skip {arch} {shape} (exists)", flush=True)
            continue
        try:
            run_cell(arch, shape, multi_pod=args.multi_pod, out_dir=args.out,
                     fsdp=args.fsdp,
                     sequence_parallel=args.sequence_parallel,
                     remat=args.remat, pure_dp=args.pure_dp,
                     cache_seq_shard=args.cache_seq_shard,
                     moe_tp=args.moe_tp)
        except Exception as e:  # noqa: BLE001 — record and continue the sweep
            failures.append((arch, shape, repr(e)))
            print(f"[dryrun] FAIL {arch} {shape}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES: {failures}", flush=True)
        raise SystemExit(1)
    print("[dryrun] all cells OK", flush=True)


if __name__ == "__main__":
    main()
