"""AdamW with bias correction and decoupled weight decay on every leaf, at
the hyperparameters of the mix's ``"optimizer": "adamw"``."""

from typing import Dict, Tuple

import torch

from perfbench.reference import common

HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def init(params: Dict[str, torch.Tensor]) -> Dict:
    """``{"m", "v", "step"}``, ``step`` an int32 tensor."""
    return {"m": {p: torch.zeros_like(t) for p, t in params.items()},
            "v": {p: torch.zeros_like(t) for p, t in params.items()},
            "step": torch.zeros((), dtype=torch.int32,
                                device=next(iter(params.values())).device)}


def update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
           state: Dict, lr: float) -> Tuple[Dict[str, torch.Tensor], Dict]:
    b1, b2, eps, wd = (HYPER[k] for k in ("b1", "b2", "eps", "weight_decay"))
    step = state["step"] + 1
    t = step.float()
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    new_p, new_m, new_v = {}, {}, {}
    for path, p in params.items():
        g = grads[path]
        m = b1 * state["m"][path] + (1 - b1) * g
        v = b2 * state["v"][path] + (1 - b2) * g * g
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p
        new_p[path] = p - lr * delta
        new_m[path], new_v[path] = m, v
    return new_p, {"m": new_m, "v": new_v, "step": step}


def first_grad_norms(state: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """Each leaf's norm of the gradient of the first step, from the state
    after it (the program's or the reference's, each tree flattened to
    ``{path: leaf}``): the first moment over ``1 - b1``."""
    return {p: common.norm(t) / (1.0 - HYPER["b1"]) for p, t in state["m"].items()}
