"""The plain training step that the program's first steps are held to:
``w`` ranks each take the loss and gradients of their contiguous block of
the batch's rows, the ring sums every leaf in the mix's wire, the sum is
divided by ``w``, the loss is the ranks' mean, and the mix's optimizer
updates the weights. Each piece is found by its name: the configuration's
``family`` in ``perfbench/reference/<family>.py``, the mix's ring ``mode``
in ``perfbench/reference/wires/<mode>.py`` (a ``-`` in the name read as
``_``) and its ``optimizer`` in ``perfbench/reference/optimizers/<name>.py``.

:func:`follow` runs the first steps of a cell from the seed and returns the
numbers that :func:`perfbench.kinds.train.gaps` compares. A ``fault`` runs the same
steps broken in one way, to read what the comparison makes of it:
``"half"`` (the second half of the ranks given the first half's rows, so
the mean is taken over half the batch), ``"exchange"`` (no ring: each rank
keeps its own gradient) or ``"token"`` (one token of the first step's
batch altered).
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional

import torch

from perfbench.reference import common
from perfbench.traffic import TokenWalk

FAULTS = ("half", "exchange", "token")


def _find(where: str, name: str):
    module = f"perfbench.reference.{where}{name.replace('-', '_')}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        path = module.replace(".", "/")
        raise ValueError(f"the reference has no {path}.py for {name!r}") from None


def family(conf: Dict):
    return _find("", conf["family"])


def wire(mix: Dict):
    """The reference's ring reduction in the mix's ``mode``."""
    return _find("wires.", mix["mode"])


def optimizer(mix: Dict):
    """The reference's optimizer that the mix names."""
    return _find("optimizers.", mix["optimizer"])


def follow(conf: Dict, mix: Dict, seed: int, device, *, tf32: bool = False,
           fault: Optional[str] = None) -> Dict:
    """``{"losses", "grad", "update"}`` of the first ``mix["check_steps"]``
    steps: each step's loss, each leaf's norm of the first reduced gradient
    (read from the optimizer's state, as the program's), and each leaf's
    norm of its change over the steps."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; faults are {FAULTS}")
    common.precision(tf32)
    fam, ring, opt, s = family(conf), wire(mix), optimizer(mix), conf["sizes"]
    w = mix["workers"]
    start = common.draw(fam.layout(s), seed, device)
    params = {p: t.clone() for p, t in start.items()}
    state = opt.init(params)
    data = TokenWalk(mix, s["vocab_size"], seed)
    losses, grad = [], {}
    for step in range(mix["check_steps"]):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in data.batch(step).items()}
        if fault == "token" and step == 0:
            row, col = 0, mix["seq_len"] // 2
            batch["tokens"][row, col] = (batch["tokens"][row, col] + 1) % s["vocab_size"]
        per = mix["global_batch"] // w
        blocks = [{k: v[r * per:(r + 1) * per] for k, v in batch.items()}
                  for r in range(w)]
        if fault == "half":
            blocks = blocks[:w // 2] * 2
        rank_loss, rank_grads = [], []
        for block in blocks:
            leaves = {p: t.detach().requires_grad_(True) for p, t in params.items()}
            loss = fam.loss(s, leaves, block["tokens"], block["labels"])
            grads = torch.autograd.grad(loss, list(leaves.values()))
            rank_loss.append(loss.detach())
            rank_grads.append(dict(zip(leaves, grads)))
            del leaves, loss, grads
        reduced = {}
        for p in params:
            ranks = [g.pop(p) for g in rank_grads]
            total = ranks[0] if fault == "exchange" else ring.all_reduce(ranks)
            reduced[p] = total / w
            del ranks, total
        total_loss = rank_loss[0].clone()
        for x in rank_loss[1:]:
            total_loss += x
        losses.append(float(total_loss / w))
        params, state = opt.update(params, reduced, state, mix["lr"])
        del reduced
        if step == 0:
            grad = opt.first_grad_norms(state)
    update = {p: common.norm(params[p] - start[p]) for p in params}
    common.precision(False)
    return {"losses": losses, "grad": grad, "update": update}
