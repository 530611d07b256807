"""Minimal functional module system: params as nested dicts of tensors, with
a parallel tree of :class:`ParamSpec` carrying shapes, dtypes and logical
sharding axes (the counterpart of ``repro.models.module``).

Params stay plain dicts rather than ``nn.Module`` attributes so that a
tree path names the same leaf in both packages: checkpoints, the ring's
per-leaf reduction and the tests all key on it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Axes                      # logical axis name per dim (None = replicated)
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"            # "normal" | "zeros" | "ones" | "embed"
    scale: Optional[float] = None   # stddev override; default fan-in scaled

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


SpecTree = Dict[str, Any]  # nested dict of ParamSpec


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flatten(v, path)
        else:
            yield path, v


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def spec_tree_axes(tree: SpecTree) -> Dict[str, Axes]:
    """Each leaf's logical axes, by path."""
    return {path: s.axes for path, s in _flatten(tree)}


def tree_map_with_specs(fn: Callable, params: Dict, specs: SpecTree):
    """Map ``fn(param_leaf, spec_leaf)`` over parallel trees."""
    spec_flat = dict(_flatten(specs))
    param_flat = dict(_flatten(params))
    return _unflatten({p: fn(param_flat[p], spec_flat[p]) for p in spec_flat})


def tree_map(fn, tree: Dict[str, Any]) -> Dict[str, Any]:
    """Apply ``fn`` to every leaf of a nested dict, keeping its structure."""
    return _unflatten({p: fn(v) for p, v in _flatten(tree)})


def n_params(tree: SpecTree) -> int:
    return sum(int(np.prod(s.shape)) for _, s in _flatten(tree))


def init_from_specs(tree: SpecTree, generator: torch.Generator,
                    device, dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, Any]:
    """Materialize parameters from specs: N(0, std) draws from ``generator``
    (which must live on ``device``), ones and zeros as the spec says."""
    def init_leaf(spec: ParamSpec):
        dt = dtype or spec.dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * std).to(dt)

    return _unflatten({path: init_leaf(s) for path, s in _flatten(tree)})


def abstract_from_specs(tree: SpecTree, dtype: Optional[torch.dtype] = None
                        ) -> Dict[str, Any]:
    """Tensors on the ``meta`` device with each spec's shape and dtype: the
    shapes and dtypes of a tree without its storage."""
    return _unflatten({
        path: torch.empty(s.shape, dtype=dtype or s.dtype, device="meta")
        for path, s in _flatten(tree)})


def params_from_reference(np_tree: Dict[str, Any], device) -> Dict[str, Any]:
    """Carry a tree of numpy arrays (the JAX package's parameters, read with
    ``np.asarray``) onto ``device``. A ``uint16`` array is a bf16 leaf seen
    through a bit view, since numpy has no bf16 of its own."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype == np.uint16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(a.copy()).to(device)
    return tree_map(leaf, np_tree)


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`params_from_reference`: bf16 leaves leave as a
    ``uint16`` bit view, every other leaf as its own dtype."""
    def leaf(t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return tree_map(leaf, tree)
