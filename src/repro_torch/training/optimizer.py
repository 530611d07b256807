"""AdamW on trees of tensors (the counterpart of
``repro.training.optimizer``).

Functional like the reference: ``update`` returns new parameter and state
trees and changes none of its inputs. State trees mirror the parameter
tree, with a scalar int32 ``step``. Adafactor and SGD-momentum are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.models.module import _flatten, _unflatten, tree_map


def adamw_init(params) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = next(_flatten(params))[1].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
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


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable  # (grads, state, params, lr=...) -> (params, state)


def make_optimizer(name: str) -> Optimizer:
    if name == "adamw":
        return Optimizer("adamw", adamw_init, adamw_update)
    if name in ("adafactor", "sgdm"):
        raise NotImplementedError(f"optimizer {name!r} is not ported yet")
    raise ValueError(name)
