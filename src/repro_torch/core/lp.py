"""LP/ILP solvers for GADGET's per-slot problems (the counterpart of
``repro.core.lp``: the HiGHS half copied, PDHG rewritten in torch).

Two engines, cross-validated in tests:

  * ``solve_lp`` / ``solve_ilp`` — exact sparse solvers (scipy HiGHS).
    HiGHS ``milp`` (branch-and-bound) plays the role Gurobi plays in the
    paper's Fig. 7 (exact per-slot optimum).
  * ``pdhg_solve`` — a primal-dual hybrid gradient (PDLP-style)
    first-order LP solver in torch, on the card by default, for large
    per-slot instances where a cluster controller would batch many LPs on
    an accelerator. Beyond-paper engineering; accuracy is validated against
    HiGHS.

Canonical form used throughout (MAXIMIZATION):

    max  c^T x   s.t.  A_ub x <= b_ub,  A_eq x == b_eq,  0 <= x <= u.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.optimize as sopt
import scipy.sparse as sp
import torch


@dataclasses.dataclass
class LPResult:
    x: np.ndarray
    value: float
    status: int  # 0 = optimal
    message: str = ""


def solve_lp(
    c: np.ndarray,
    A_ub: Optional[np.ndarray] = None,
    b_ub: Optional[np.ndarray] = None,
    A_eq: Optional[np.ndarray] = None,
    b_eq: Optional[np.ndarray] = None,
    upper: Optional[np.ndarray] = None,
) -> LPResult:
    """Exact LP (HiGHS). Maximizes c^T x over the canonical polytope."""
    n = len(c)
    ub = np.full(n, np.inf) if upper is None else np.asarray(upper, dtype=float)
    res = sopt.linprog(
        -np.asarray(c, dtype=float),
        A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
        bounds=list(zip(np.zeros(n), ub)),
        method="highs",
    )
    x = res.x if res.x is not None else np.zeros(n)
    return LPResult(x=np.asarray(x), value=float(-res.fun) if res.fun is not None else 0.0,
                    status=int(res.status), message=str(res.message))


def solve_ilp(
    c: np.ndarray,
    A_ub: Optional[sp.spmatrix] = None,
    b_ub: Optional[np.ndarray] = None,
    A_eq: Optional[sp.spmatrix] = None,
    b_eq: Optional[np.ndarray] = None,
    upper: Optional[np.ndarray] = None,
    integrality: Optional[np.ndarray] = None,
    time_limit: float = 60.0,
) -> LPResult:
    """Exact MILP via HiGHS branch-and-bound (the paper's Gurobi role)."""
    n = len(c)
    ub = np.full(n, np.inf) if upper is None else np.asarray(upper, dtype=float)
    constraints = []
    if A_ub is not None and A_ub.shape[0] > 0:
        constraints.append(sopt.LinearConstraint(A_ub, -np.inf, b_ub))
    if A_eq is not None and A_eq.shape[0] > 0:
        constraints.append(sopt.LinearConstraint(A_eq, b_eq, b_eq))
    integ = np.ones(n) if integrality is None else integrality
    res = sopt.milp(
        c=-np.asarray(c, dtype=float),
        constraints=constraints,
        bounds=sopt.Bounds(np.zeros(n), ub),
        integrality=integ,
        options={"time_limit": time_limit},
    )
    x = res.x if res.x is not None else np.zeros(n)
    val = float(-res.fun) if res.fun is not None else 0.0
    return LPResult(x=np.asarray(x), value=val, status=int(res.status),
                    message=str(res.message))


# ---------------------------------------------------------------------------
# PDHG in torch (Chambolle–Pock with primal weight, PDLP-flavoured)
# ---------------------------------------------------------------------------

@torch.no_grad()
def _pdhg_loop(c, A, b, u, tau, sigma, iters: int):
    m, n = A.shape
    x = torch.zeros((n,), dtype=A.dtype, device=A.device)
    y = torch.zeros((m,), dtype=A.dtype, device=A.device)
    for _ in range(iters):
        x_new = torch.minimum(torch.clamp(x + tau * (c - A.T @ y), min=0.0), u)
        x_bar = 2.0 * x_new - x
        y = torch.clamp(y + sigma * (A @ x_bar - b), min=0.0)
        x = x_new
    primal = c @ x
    infeas = torch.clamp(A @ x - b, min=0.0)
    return x, y, primal, (infeas.max() if m else torch.zeros((), dtype=A.dtype))


@torch.no_grad()
def pdhg_solve(
    c: np.ndarray,
    A_ub: np.ndarray,
    b_ub: np.ndarray,
    upper: np.ndarray,
    iters: int = 4000,
    device="cuda",
) -> LPResult:
    """First-order LP solve of  max c^T x, A x <= b, 0 <= x <= u  (dense A),
    in f32 on ``device``.

    Equality rows should be pre-split into two inequalities by the caller.
    Step sizes: tau * sigma * ||A||^2 < 1 with ||A|| from power iteration.
    """
    if sp.issparse(A_ub):  # dense matrix-vector products — densify
        A_ub = A_ub.toarray()

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

    A, c_t, b_t, u_t = f32(A_ub), f32(c), f32(b_ub), f32(upper)
    # power iteration for ||A||_2
    v = torch.ones((A.shape[1],), dtype=torch.float32, device=device) \
        / np.sqrt(max(A.shape[1], 1))
    for _ in range(30):
        w = A @ v
        v = A.T @ w
        nrm = torch.linalg.norm(v)
        v = v / torch.clamp(nrm, min=1e-12)
    op_norm = torch.sqrt(torch.clamp(nrm, min=1e-12))
    step = 0.9 / torch.clamp(op_norm, min=1e-9)
    x, y, primal, infeas = _pdhg_loop(c_t, A, b_t, u_t, step, step, iters)
    bound = 1e-3 * (1.0 + float(torch.max(torch.abs(b_t))))
    return LPResult(
        x=x.double().cpu().numpy(),
        value=float(primal),
        status=0 if float(infeas) < bound else 4,
        message=f"pdhg max_infeas={float(infeas):.2e} ||A||={float(op_norm):.3g}",
    )
