"""AdamW, Adafactor and SGD-momentum on trees of tensors (the counterpart
of ``repro.training.optimizer``).

Functional like the reference: ``update`` returns new parameter and state
trees and changes none of its inputs. State trees mirror the parameter
tree, with a scalar int32 ``step``; Adafactor's ``stats`` hold, at each
parameter's path, ``{"vr", "vc"}`` (the row and column statistics of its
last two axes) or ``{"v"}`` for a leaf of one axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

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
        g = g_flat[path].float()
        m = b1 * m_flat[path] + (1 - b1) * g
        v = b2 * v_flat[path] + (1 - b2) * g * g
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        new_p[path] = (p.float() - lr * delta).to(p.dtype)
        new_m[path], new_v[path] = m, v
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
    for path, p in _flatten(params):
        g = g_flat[path].float()
        g2 = g * g + eps
        if p.dim() >= 2:
            vr = beta2 * st_flat[f"{path}/vr"] + (1 - beta2) * g2.mean(dim=-1)
            vc = beta2 * st_flat[f"{path}/vc"] + (1 - beta2) * g2.mean(dim=-2)
            denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
            precond = (vr[..., None] / denom[..., None]) * vc[..., None, :]
            update = g * torch.rsqrt(torch.clamp(precond, min=eps))
            new_st[f"{path}/vr"], new_st[f"{path}/vc"] = vr, vc
        else:
            v = beta2 * st_flat[f"{path}/v"] + (1 - beta2) * g2
            update = g * torch.rsqrt(torch.clamp(v, min=eps))
            new_st[f"{path}/v"] = v
        # update clipping (RMS <= clip_threshold)
        rms = torch.sqrt(torch.mean(update * update) + 1e-12)
        update = update / torch.clamp(rms / clip_threshold, min=1.0)
        if weight_decay:
            update = update + weight_decay * p.float()
        new_p[path] = (p.float() - lr * update).to(p.dtype)
    return _unflatten(new_p), {"stats": _unflatten(new_st), "step": step}


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
