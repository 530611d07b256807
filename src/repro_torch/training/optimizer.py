"""AdamW, Adafactor and SGD-momentum on trees of tensors (the counterpart
of ``repro.training.optimizer``).

Functional like the reference: ``update`` returns new parameter and state
trees and changes none of its inputs. AdamW updates each leaf in one
operator (``kernels/adamw.py``: one CUDA kernel a leaf on the card). State
trees mirror the parameter tree, with a scalar int32 ``step``; Adafactor's
``stats`` hold, at each parameter's path, ``{"vr", "vc"}`` (the row and
column statistics of its last two axes) or ``{"v"}`` for a leaf of one
axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.dist.sharding import is_dtensor, like, on_shards
from repro_torch.kernels.adamw import adamw_leaf
from repro_torch.models.module import _flatten, _unflatten, tree_map


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _step_zero(params) -> torch.Tensor:
    device = next(_flatten(params))[1].device
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw_init(params) -> Dict[str, Any]:
    def zeros(p):
        return _zeros(p.shape, p.device)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": _step_zero(params),
    }


@torch.no_grad()
def adamw_update(grads, state, params, *, lr: float, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    step = state["step"] + 1
    t = step.float()
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    g_flat, m_flat, v_flat = dict(_flatten(grads)), dict(_flatten(state["m"])), \
        dict(_flatten(state["v"]))
    new_p, new_m, new_v = {}, {}, {}
    for path, p in _flatten(params):
        new_p[path], new_m[path], new_v[path] = adamw_leaf(
            *(x.contiguous() for x in (p, g_flat[path], m_flat[path], v_flat[path])),
            bc1, bc2, lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    return _unflatten(new_p), {"m": _unflatten(new_m), "v": _unflatten(new_v),
                               "step": step}


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; no momentum)
# ---------------------------------------------------------------------------

def adafactor_init(params) -> Dict[str, Any]:
    def leaf_state(p):
        if p.dim() >= 2:
            return {"vr": _zeros(p.shape[:-1], p.device),          # row stats
                    "vc": _zeros(p.shape[:-2] + p.shape[-1:], p.device)}
        return {"v": _zeros(p.shape, p.device)}
    return {"stats": tree_map(leaf_state, params), "step": _step_zero(params)}


@torch.no_grad()
def adafactor_update(grads, state, params, *, lr: float, decay: float = 0.8,
                     eps: float = 1e-30, clip_threshold: float = 1.0,
                     weight_decay: float = 0.0):
    step = state["step"] + 1
    beta2 = 1.0 - step.float() ** (-decay)      # f32, as the reference's
    g_flat, st_flat = dict(_flatten(grads)), dict(_flatten(state["stats"]))
    new_p, new_st = {}, {}
    opts = dict(lr=lr, eps=eps, clip_threshold=clip_threshold,
                weight_decay=weight_decay)
    for path, p in _flatten(params):
        keys = ("vr", "vc") if p.dim() >= 2 else ("v",)
        stats = [st_flat[f"{path}/{k}"] for k in keys]
        if is_dtensor(p):
            new_p[path], *out = _adafactor_leaf_sharded(g_flat[path], p, stats,
                                                        beta2, **opts)
        else:
            new_p[path], *out = _adafactor_leaf(g_flat[path], p, stats, beta2,
                                                **opts)
        new_st.update({f"{path}/{k}": v for k, v in zip(keys, out)})
    return _unflatten(new_p), {"stats": _unflatten(new_st), "step": step}


def _mean(t, dim=None, keepdim=False, pdim=None):
    return torch.mean(t) if dim is None else t.mean(dim=dim, keepdim=keepdim)


def _adafactor_leaf(g, p, stats, beta2, *, lr, eps, clip_threshold,
                    weight_decay, mean=_mean):
    """One leaf's update: the new parameter and statistics. ``mean(t, dim,
    keepdim, pdim)`` is the mean of ``t`` over ``dim``, which is the
    parameter's ``pdim`` (both None: every element)."""
    g = g.float()
    g2 = g * g + eps
    if p.dim() >= 2:
        vr = beta2 * stats[0] + (1 - beta2) * mean(g2, -1, pdim=-1)
        vc = beta2 * stats[1] + (1 - beta2) * mean(g2, -2, pdim=-2)
        denom = torch.clamp(mean(vr, -1, True, pdim=-2), min=eps)
        precond = (vr[..., None] / denom[..., None]) * vc[..., None, :]
        update = g * torch.rsqrt(torch.clamp(precond, min=eps))
        new = (vr, vc)
    else:
        v = beta2 * stats[0] + (1 - beta2) * g2
        update = g * torch.rsqrt(torch.clamp(v, min=eps))
        new = (v,)
    # update clipping (RMS <= clip_threshold)
    rms = torch.sqrt(mean(update * update) + 1e-12)
    update = update / torch.clamp(rms / clip_threshold, min=1.0)
    if weight_decay:
        update = update + weight_decay * p.float()
    return ((p.float() - lr * update).to(p.dtype),) + new


def _adafactor_leaf_sharded(g, p, stats, beta2, **opts):
    """:func:`_adafactor_leaf` of a DTensor leaf, shard by shard: the
    gradient and the statistics taken as the parameter is split (the row
    statistics without its last dim, the column ones without the one before
    it), each mean over a split dim a sum reduced over the mesh dims that
    split it, over the dim's whole length. DTensor's own reductions and
    outer product gather whole leaves (arctic-480b's experts: 1.7 TB a
    device on 16x16)."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard

    mesh, pp, nd = p.device_mesh, list(p.placements), p.dim()

    def without(d):
        return [Replicate() if q.is_shard(d) else
                Shard(q.dim - 1) if q.is_shard() and q.dim > d else q for q in pp]

    def groups(pdim):
        return [mesh.get_group(i) for i, q in enumerate(pp)
                if q.is_shard() and (pdim is None or q.dim == pdim % nd)
                and mesh.size(i) > 1]

    def mean(t, dim=None, keepdim=False, pdim=None):
        gs = groups(pdim)
        if not gs:
            return _mean(t, dim, keepdim)
        total = torch.sum(t) if dim is None else t.sum(dim=dim, keepdim=keepdim)
        for grp in gs:
            total = funcol.all_reduce(total, "sum", grp)
        return total / (p.numel() if pdim is None else p.shape[pdim])

    sp = [without(nd - 1), without(nd - 2)] if nd >= 2 else [pp]
    return on_shards(
        lambda g, p, b2, *st: _adafactor_leaf(g, p, st, b2, mean=mean, **opts),
        mesh, (pp, *sp), (pp, pp, [Replicate()] * mesh.ndim, *sp))(
        g, p, beta2 if is_dtensor(beta2) else like(p, beta2), *stats)
# ---------------------------------------------------------------------------
# SGD-momentum
# ---------------------------------------------------------------------------

def sgdm_init(params) -> Dict[str, Any]:
    return {"mom": tree_map(lambda p: _zeros(p.shape, p.device), params),
            "step": _step_zero(params)}


@torch.no_grad()
def sgdm_update(grads, state, params, *, lr: float, momentum: float = 0.9,
                weight_decay: float = 0.0):
    g_flat, m_flat = dict(_flatten(grads)), dict(_flatten(state["mom"]))
    new_p, new_m = {}, {}
    for path, p in _flatten(params):
        g = g_flat[path].float() + weight_decay * p.float()
        m = momentum * m_flat[path] + g
        new_p[path], new_m[path] = (p.float() - lr * m).to(p.dtype), m
    return _unflatten(new_p), {"mom": _unflatten(new_m),
                               "step": state["step"] + 1}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable  # (grads, state, params, lr=...) -> (params, state)


def make_optimizer(name: str) -> Optimizer:
    if name == "adamw":
        return Optimizer("adamw", adamw_init, adamw_update)
    if name == "adafactor":
        return Optimizer("adafactor", adafactor_init, adafactor_update)
    if name == "sgdm":
        return Optimizer("sgdm", sgdm_init, sgdm_update)
    raise ValueError(name)
