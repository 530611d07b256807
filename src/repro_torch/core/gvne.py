"""G-VNE: generalized virtual network embedding for one time slot — paper §V-C.

Implements Algorithm 2 (LP-RS-MDE) in a Dantzig–Wolfe mapping-space form
(DESIGN.md §4): instead of the edge-flow ILP (12)–(19) we work directly over
*candidate integral mappings* omega_i^k (each a resource-feasible ring
embedding). The LP over selection weights phi_i^k is the DW reformulation of
(12)–(19); its optimum upper-bounds the ILP optimum, the fractional solution
IS the mapping-selection tuple set M_i = {(phi_i^k, omega_i^k)}, and the
randomized-rounding analysis (Theorem 8) applies verbatim.

Pipeline (Algorithm 2 line numbers in brackets):
  1. worker upper bounds q_i[t] via relaxation of (2),(4),(11)      [pre]
  2. candidate generation for every ring size kappa in {1..q_i}     [pre]
  3. LP relaxation over phi; ring selection kappa_i = argmax
     pi_{i,kappa} chi_{i,kappa}  (Lemma 7)                          [3]
  4. augmented LP restricted to the selected ring sizes             [4]
  5. mapping-selection tuples M_i from the LP solution              [5-6]
  6. randomized rounding until (alpha, beta^r, gamma)-approx or u_b [7-9]
  7. repair to strict feasibility (hard caps for the simulator; the
     paper allows w.h.p. capacity violations, a real cluster cannot)

``solve_slot_exact`` solves the same slot exactly with HiGHS branch-and-bound
over exhaustively enumerated candidates (the paper's Gurobi baseline, Fig. 7).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from repro_torch.cluster.topology import Edge, Embedding, ResourceState, SubstrateGraph
from repro_torch.core.lp import LPResult, pdhg_solve, solve_ilp, solve_lp
from repro_torch.core.problem import Job, ScheduleState


@dataclasses.dataclass
class Candidate:
    """One integral mapping omega_i^k: a feasible-in-isolation ring embedding."""

    job_id: int
    kappa: int
    utility: float  # pi_{i,kappa} (marginal utility of adding kappa workers)
    embedding: Embedding
    node_demand: Dict[Tuple[int, str], float]
    edge_demand: Dict[Edge, float]


@dataclasses.dataclass
class GvneConfig:
    n_candidates: int = 8       # candidates per (job, kappa)
    u_b: int = 32               # max rounding rounds (Algorithm 2 line 1)
    alpha: float = 1.0 / 3.0    # utility acceptance fraction (Theorem 8)
    epsilon: float = 0.5        # violation-slack scale in beta^r, gamma
    lp_engine: str = "highs"    # "highs" | "pdhg"
    seed: int = 0
    max_servers_per_ring: int = 8
    # hot-path controls. ``vectorized`` switches steps 1-2 to one
    # shared numpy caps matrix per slot instead of a per-(job, kappa) dict
    # rebuild — decisions are bit-identical either way (pinned by tests);
    # keep the False path as the reference implementation.
    vectorized: bool = True
    # ``admission_window`` caps how many active jobs enter candidate
    # generation per slot, keeping the top-K by single-worker marginal
    # utility (the greedy density Lemma 7 scores by). None = paper
    # semantics (every active job). A cluster of C GPUs can place at most C
    # workers per slot, so a window of a few multiples of C preserves the
    # plausible LP support while making the slot decision O(window) instead
    # of O(active jobs) — the knob behind the 10k-job scale benchmark.
    admission_window: Optional[int] = None


@dataclasses.dataclass
class GvneResult:
    embeddings: List[Embedding]
    lp_value: float
    rounded_value: float
    value: float                 # final (repaired, strictly feasible) utility
    n_rounds: int
    accepted: bool               # rounding met the (alpha, beta, gamma) test
    diagnostics: Dict[str, float]


# ---------------------------------------------------------------------------
# Step 1: worker-count upper bounds q_i[t]
# ---------------------------------------------------------------------------

def worker_upper_bound(res: ResourceState, job: Job, remaining: float) -> int:
    """q_i[t]: relaxation of constraints (2), (4), (11).

    min( N_i,                               # per-slot cap (2)
         remaining worker-time budget,      # (11)
         total fractionally-packable workers across free capacity (4) ).

    Per-server packability goes through ``max_workers_on_server`` with the
    job's N_i as cap, so a demand vector with no positive entry is bounded by
    N_i (or rejected on an empty vector) instead of being unbounded.
    """
    packable = 0.0
    for s in res.graph.servers:
        packable += res.max_workers_on_server(s.id, job.demands,
                                              cap=job.max_workers)
    return int(max(0, math.floor(min(job.max_workers, remaining, packable) + 1e-9)))


def slot_caps_matrix(
    res: ResourceState, jobs: Sequence[Job]
) -> Tuple[List[int], np.ndarray]:
    """One vectorized packability matrix per slot: ``caps[j, s]``.

    Row j holds, for every server (in ``graph.servers`` order), the same
    value ``max_workers_on_server(s, jobs[j].demands, cap=jobs[j].
    max_workers)`` computes — min over positive demands of
    ``floor(free/l + 1e-9)``, bounded by N_i (N_i alone when no demand entry
    is positive). Computed once and shared by every ``worker_upper_bound``
    and ``generate_candidates`` call of the slot, replacing the O(S) dict
    rebuild those did per (job, kappa).

    Returns ``(server_ids, caps)`` with ``server_ids`` in ``graph.servers``
    order (the candidate generators' eligible-server iteration order, so RNG
    draws are unchanged).
    """
    servers = res.graph.servers
    server_ids = [s.id for s in servers]
    rtypes = sorted({r for j in jobs for r in j.demands})
    for j in jobs:
        if not j.demands:
            raise ValueError("max_workers_on_server: empty demand vector")
    free = np.array(
        [[res.free_node[sid].get(r, 0.0) for r in rtypes]
         for sid in server_ids],
        dtype=np.float64,
    )                                                   # S x R
    dem = np.array([[j.demands.get(r, 0.0) for r in rtypes] for j in jobs],
                   dtype=np.float64)                    # J x R
    n_i = np.array([max(0, int(j.max_workers)) for j in jobs], dtype=np.int64)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = free[None, :, :] / dem[:, None, :]      # J x S x R
    ratio = np.where(dem[:, None, :] > 0.0, ratio, np.inf)
    lim = ratio.min(axis=2)                             # J x S
    caps = np.minimum(np.floor(lim + 1e-9), n_i[:, None].astype(np.float64))
    caps = np.where(np.isinf(lim), n_i[:, None].astype(np.float64), caps)
    return server_ids, np.maximum(caps, 0.0).astype(np.int64)


# ---------------------------------------------------------------------------
# Step 2: candidate generation
# ---------------------------------------------------------------------------

def _distribute(capacities: Sequence[int], kappa: int) -> Optional[List[int]]:
    """Greedy largest-first worker distribution over an ordered server set."""
    counts = [0] * len(capacities)
    caps = list(capacities)
    remaining = kappa
    order = sorted(range(len(caps)), key=lambda j: -caps[j])
    for j in order:
        take = min(caps[j], remaining)
        counts[j] = take
        remaining -= take
        if remaining == 0:
            break
    if remaining > 0 or any(c == 0 for c in counts):
        return None
    return counts


def _ring_order(servers: List[int], graph: SubstrateGraph) -> List[int]:
    """Rack-locality ordering: group servers by rack so the ring crosses
    racks as few times as possible (the fat-tree-aware placement the paper's
    path constraints reward)."""
    return sorted(servers, key=lambda s: (graph.server_by_id[s].rack, s))


def build_embedding(
    res: ResourceState, job: Job, servers: List[int], counts: List[int]
) -> Optional[Embedding]:
    """Assemble + path-select a ring embedding; None if no feasible paths."""
    groups = [(s, c) for s, c in zip(servers, counts) if c > 0]
    if not groups:
        return None
    if len(groups) == 1:
        emb = Embedding(job.id, groups, [], job.bandwidth)
    else:
        paths = []
        order = [s for s, _ in groups]
        for k, s in enumerate(order):
            s2 = order[(k + 1) % len(order)]
            p = res.best_path(s, s2, job.bandwidth)
            if p is None:
                return None
            paths.append(p)
        emb = Embedding(job.id, groups, paths, job.bandwidth)
    return emb if res.feasible(emb, job.demands) else None


def generate_candidates(
    res: ResourceState,
    job: Job,
    kappa: int,
    pi: float,
    cfg: GvneConfig,
    rng: np.random.Generator,
    caps: Optional[Dict[int, int]] = None,
) -> List[Candidate]:
    """Randomized-greedy candidate rings of size kappa for one job.

    ``caps`` is the job's per-server packability (one dict in
    ``graph.servers`` order, e.g. a row of :func:`slot_caps_matrix`); when
    omitted it is rebuilt here — the pre-vectorization O(S) per-call path.
    """
    out: List[Candidate] = []
    seen = set()
    if caps is None:
        caps = {
            s.id: res.max_workers_on_server(s.id, job.demands,
                                            cap=job.max_workers)
            for s in res.graph.servers
        }
    eligible = [s for s, c in caps.items() if c >= 1]
    if not eligible:
        return out

    def _push(emb: Optional[Embedding]) -> None:
        if emb is None:
            return
        key = tuple(sorted(emb.groups))
        if key in seen:
            return
        seen.add(key)
        # candidate utilities stay undiscounted: contention is priced at
        # decision time, where the slot's commit set is visible — _backfill
        # scores each job's options by fair-share-discounted utility and
        # _reroute_contended re-places rings that landed on oversubscribed
        # edges (a static discount here would double-count the self-term)
        out.append(
            Candidate(
                job_id=job.id,
                kappa=kappa,
                utility=pi,
                embedding=emb,
                node_demand={
                    (s, r): v
                    for s, dd in emb.node_demand(job.demands).items()
                    for r, v in dd.items()
                },
                edge_demand=emb.edge_demand(),
            )
        )

    # (a) colocated candidates: largest-capacity servers first (paper Fig. 2a)
    colocatable = sorted((s for s in eligible if caps[s] >= kappa),
                         key=lambda s: -caps[s])
    for s in colocatable[: max(2, cfg.n_candidates // 2)]:
        _push(build_embedding(res, job, [s], [kappa]))

    # (b) multi-server rings: random server subsets, rack-local ordering
    max_srv = min(kappa, cfg.max_servers_per_ring, len(eligible))
    attempts = 4 * cfg.n_candidates
    for _ in range(attempts):
        if len(out) >= cfg.n_candidates:
            break
        if max_srv < 2:
            break
        n_srv = int(rng.integers(2, max_srv + 1))
        subset = list(rng.choice(eligible, size=min(n_srv, len(eligible)),
                                 replace=False))
        subset = _ring_order(subset, res.graph)
        counts = _distribute([caps[s] for s in subset], kappa)
        if counts is None:
            continue
        _push(build_embedding(res, job, subset, counts))
    return out


def enumerate_all_candidates(
    res: ResourceState, job: Job, kappa: int, pi: float,
    max_servers: int = 4,
) -> List[Candidate]:
    """Exhaustive candidate enumeration for exact baselines (small instances).

    All server subsets up to ``max_servers``, all compositions of kappa, all
    cyclic orders up to rotation — exponential, use only for Fig.-7-scale
    instances.
    """
    out: List[Candidate] = []
    seen = set()
    caps = {s.id: res.max_workers_on_server(s.id, job.demands, cap=job.max_workers)
            for s in res.graph.servers}
    eligible = [s for s, c in caps.items() if c >= 1]

    def _push(emb: Optional[Embedding]) -> None:
        if emb is None:
            return
        key = (tuple(emb.groups), tuple(emb.paths))
        if key in seen:
            return
        seen.add(key)
        out.append(Candidate(
            job_id=job.id, kappa=kappa, utility=pi, embedding=emb,
            node_demand={(s, r): v for s, dd in emb.node_demand(job.demands).items()
                         for r, v in dd.items()},
            edge_demand=emb.edge_demand(),
        ))

    for s in eligible:
        if caps[s] >= kappa:
            _push(build_embedding(res, job, [s], [kappa]))
    for n_srv in range(2, min(kappa, max_servers, len(eligible)) + 1):
        for subset in itertools.combinations(eligible, n_srv):
            # compositions of kappa into n_srv positive parts bounded by caps
            for comp in _compositions(kappa, n_srv):
                if any(c > caps[s] for s, c in zip(subset, comp)):
                    continue
                # cyclic orders up to rotation: fix first element
                rest = list(subset[1:])
                for perm in itertools.permutations(range(len(rest))):
                    order = [subset[0]] + [rest[j] for j in perm]
                    cnts = dict(zip(subset, comp))
                    _push(build_embedding(res, job, order, [cnts[s] for s in order]))
    return out


def _compositions(total: int, parts: int):
    if parts == 1:
        yield (total,)
        return
    for first in range(1, total - parts + 2):
        for rest in _compositions(total - first, parts - 1):
            yield (first,) + rest


# ---------------------------------------------------------------------------
# Steps 3-5: selection LP, ring selection, augmented LP
# ---------------------------------------------------------------------------

def _build_lp(
    cands: List[Candidate], res: ResourceState
) -> Tuple[sp.csr_matrix, np.ndarray, np.ndarray, List[str]]:
    """Rows: per-job sum(phi) <= 1; node capacity (s, r); edge capacity.

    The constraint matrix is returned as ``scipy.sparse.csr_matrix``: each
    candidate column touches one job row plus its own ring's servers/edges,
    so density is ~(ring size)/m — the dense ``np.zeros((m, n))`` this
    replaces dominated the slot decision at thousands of candidates. HiGHS
    (``linprog``/``milp``) consumes the sparse matrix natively.
    """
    jobs = sorted({c.job_id for c in cands})
    job_row = {j: k for k, j in enumerate(jobs)}
    node_keys = sorted({k for c in cands for k in c.node_demand})
    edge_keys = sorted({e for c in cands for e in c.edge_demand})
    node_row = {k: len(jobs) + i for i, k in enumerate(node_keys)}
    edge_row = {e: len(jobs) + len(node_keys) + i for i, e in enumerate(edge_keys)}
    m = len(jobs) + len(node_keys) + len(edge_keys)
    n = len(cands)
    b = np.zeros(m)
    for j, r in job_row.items():
        b[r] = 1.0
    for (s, r), row in node_row.items():
        b[row] = res.free_node[s].get(r, 0.0)
    for e, row in edge_row.items():
        b[row] = res.admissible_edge_capacity(e)
    rows: List[int] = []
    cols: List[int] = []
    vals: List[float] = []
    for col, c in enumerate(cands):
        rows.append(job_row[c.job_id])
        cols.append(col)
        vals.append(1.0)
        for k, v in c.node_demand.items():
            rows.append(node_row[k])
            cols.append(col)
            vals.append(v)
        for e, v in c.edge_demand.items():
            rows.append(edge_row[e])
            cols.append(col)
            vals.append(v)
    A = sp.coo_matrix(
        (vals, (rows, cols)), shape=(m, n), dtype=np.float64
    ).tocsr()
    names = [f"job{j}" for j in jobs] + [f"node{k}" for k in node_keys] + [
        f"edge{e}" for e in edge_keys
    ]
    return A, b, np.array([c.utility for c in cands]), names


def _solve_selection_lp(
    cands: List[Candidate], res: ResourceState, engine: str
) -> Tuple[np.ndarray, float]:
    if not cands:
        return np.zeros(0), 0.0
    A, b, c, _ = _build_lp(cands, res)
    if engine == "pdhg":
        r = pdhg_solve(c, A, b, upper=np.ones(len(c)))
        if r.status == 0:
            return np.clip(r.x, 0.0, 1.0), float(r.value)
        # fall through to exact on poor convergence
    r = solve_lp(c, A_ub=A, b_ub=b, upper=np.ones(len(c)))
    return np.clip(r.x, 0.0, 1.0), float(r.value)


def lp_ring_selection(
    cands: List[Candidate], phi: np.ndarray
) -> Dict[int, int]:
    """Lemma 7: kappa_i = argmax_{kappa: chi>0} pi_{i,kappa} chi_{i,kappa}."""
    chi: Dict[Tuple[int, int], float] = {}
    pi: Dict[Tuple[int, int], float] = {}
    for c, f in zip(cands, phi):
        if f <= 1e-9:
            continue
        chi[(c.job_id, c.kappa)] = chi.get((c.job_id, c.kappa), 0.0) + float(f)
        pi[(c.job_id, c.kappa)] = c.utility
    best: Dict[int, Tuple[float, int]] = {}
    for (j, kappa), x in chi.items():
        score = pi[(j, kappa)] * x
        if j not in best or score > best[j][0]:
            best[j] = (score, kappa)
    return {j: kappa for j, (_, kappa) in best.items()}


# ---------------------------------------------------------------------------
# Step 6: randomized rounding with (alpha, beta^r, gamma) acceptance
# ---------------------------------------------------------------------------

def _violation_slacks(
    cands: List[Candidate], res: ResourceState, epsilon: float
) -> Tuple[Dict[str, float], float]:
    """beta^r = 1 + eps*sqrt(2 Delta^r(V_s) log|V_s|), gamma likewise (Thm 8)."""
    n_nodes = max(len(res.graph.servers), 2)
    n_edges = max(len(res.graph.links), 2)
    # Delta terms: max over nodes/edges of sum_i (C_max/d_max)^2
    per_node: Dict[Tuple[int, str], Dict[int, float]] = {}
    per_edge: Dict[Edge, Dict[int, float]] = {}
    for c in cands:
        for k, v in c.node_demand.items():
            d = per_node.setdefault(k, {})
            d[c.job_id] = max(d.get(c.job_id, 0.0), v)
        for e, v in c.edge_demand.items():
            d = per_edge.setdefault(e, {})
            d[c.job_id] = max(d.get(c.job_id, 0.0), v)
    # ratios C_max/d_max are 1 per (job, node) in mapping space (a candidate
    # either imposes its max demand or none) => Delta = max count of jobs
    delta_node: Dict[str, float] = {}
    for (s, r), jobs in per_node.items():
        delta_node[r] = max(delta_node.get(r, 1.0), float(len(jobs)))
    delta_edge = max([float(len(j)) for j in per_edge.values()] or [1.0])
    betas = {
        r: 1.0 + epsilon * math.sqrt(2.0 * dv * math.log(n_nodes))
        for r, dv in delta_node.items()
    }
    gamma = 1.0 + epsilon * math.sqrt(2.0 * delta_edge * math.log(n_edges))
    return betas, gamma


def _round_once(
    by_job: Dict[int, List[Tuple[float, Candidate]]],
    rng: np.random.Generator,
) -> List[Candidate]:
    chosen: List[Candidate] = []
    for j, options in by_job.items():
        probs = np.array([p for p, _ in options])
        total = probs.sum()
        if total <= 1e-12:
            continue
        reject = max(0.0, 1.0 - total)
        idx = rng.choice(len(options) + 1, p=np.append(probs, reject) / (total + reject))
        if idx < len(options):
            chosen.append(options[idx][1])
    return chosen


def _eval_choice(
    chosen: List[Candidate], res: ResourceState
) -> Tuple[float, Dict[Tuple[int, str], float], Dict[Edge, float]]:
    value = sum(c.utility for c in chosen)
    node_use: Dict[Tuple[int, str], float] = {}
    edge_use: Dict[Edge, float] = {}
    for c in chosen:
        for k, v in c.node_demand.items():
            node_use[k] = node_use.get(k, 0.0) + v
        for e, v in c.edge_demand.items():
            edge_use[e] = edge_use.get(e, 0.0) + v
    return value, node_use, edge_use


def _predicted_slowdown(res: ResourceState, emb: Embedding,
                        include_self: bool = True) -> float:
    """Fair-share discount of an embedding against the current state: the
    ratio b_eff/b_i in (0, 1], 1.0 when no edge it uses is oversubscribed."""
    if not emb.paths or emb.bandwidth <= 0:
        return 1.0
    return min(1.0, res.effective_bandwidth(emb, include_self=include_self)
               / emb.bandwidth)


def _repair(
    chosen: List[Candidate], scratch: ResourceState, job_map: Dict[int, Job]
) -> List[Candidate]:
    """Drop lowest-utility candidates until strictly feasible: commit-test
    sequentially (utility-descending) against the scratch resource copy."""
    out: List[Candidate] = []
    for c in sorted(chosen, key=lambda c: -c.utility):
        demands = job_map[c.job_id].demands
        if scratch.feasible(c.embedding, demands):
            scratch.commit(c.embedding, demands)
            out.append(c)
    return out


def _reroute_contended(
    kept: List[Candidate],
    scratch: ResourceState,
    job_map: Dict[int, Job],
) -> List[Candidate]:
    """Contention-aware re-route: sequential repricing against this slot.

    The selection LP's capacity rows cannot express fair-sharing, so two rings
    rounded onto the same oversubscribed edge are only visible *after* commit.
    For each kept ring whose committed fair share is below its reservation,
    release it and try a fresh placement against the current scratch state
    (``best_path`` prefers the least-contended admissible path; colocation has
    no paths at all); keep whichever placement predicts the higher share.
    """
    out: List[Candidate] = []
    for c in kept:
        job = job_map[c.job_id]
        slow = _predicted_slowdown(scratch, c.embedding, include_self=False)
        if slow >= 1.0 - 1e-9:
            out.append(c)
            continue
        scratch.release(c.job_id, job.demands)
        alt = _first_fit_ring(scratch, job, c.kappa)
        if alt is not None and \
                _predicted_slowdown(scratch, alt) > slow + 1e-9:
            scratch.commit(alt, job.demands)
            out.append(dataclasses.replace(
                c,
                embedding=alt,
                node_demand={(s, r): v for s, dd in
                             alt.node_demand(job.demands).items()
                             for r, v in dd.items()},
                edge_demand=alt.edge_demand(),
            ))
        else:
            scratch.commit(c.embedding, job.demands)
            out.append(c)
    return out


def _backfill(
    kept: List[Candidate],
    all_cands: List[Candidate],
    scratch: ResourceState,
    job_map: Dict[int, Job],
    state: "ScheduleState",
) -> List[Candidate]:
    """Greedy re-add: jobs rejected by randomized rounding (probability mass
    1 - sum phi) or dropped in repair get first-fit embeddings, best marginal
    utility first. Pre-generated candidates are tried first; if all collide
    with already-committed placements, a fresh column is generated on demand
    against the *current* scratch state (column generation). Strictly
    additive — never reduces the rounded utility, so Theorem 8 still holds."""
    placed = {c.job_id for c in kept}
    pool = [c for c in all_cands if c.job_id not in placed]
    pool.sort(key=lambda c: -c.utility)
    out = list(kept)
    by_jid: Dict[int, List[Candidate]] = {}
    for c in pool:
        by_jid.setdefault(c.job_id, []).append(c)
    # per job, among feasible candidates take the one with the best utility
    # *after* the fair-share discount against what this slot already committed
    for jid in sorted(by_jid, key=lambda j: -by_jid[j][0].utility):
        demands = job_map[jid].demands
        best_c, best_score = None, 0.0
        for c in by_jid[jid]:
            if not scratch.feasible(c.embedding, demands):
                continue
            score = c.utility * _predicted_slowdown(scratch, c.embedding)
            if score > best_score:
                best_c, best_score = c, score
        if best_c is not None:
            scratch.commit(best_c.embedding, demands)
            out.append(best_c)
            placed.add(jid)
    # column generation for jobs whose pre-generated candidates all collide
    best_kappa: Dict[int, int] = {}
    for c in pool:
        if c.job_id not in placed:
            best_kappa[c.job_id] = max(best_kappa.get(c.job_id, 0), c.kappa)
    order = sorted(best_kappa, key=lambda j: -state.marginal_utility(
        job_map[j], best_kappa[j]))
    for jid in order:
        job = job_map[jid]
        for kappa in range(best_kappa[jid], 0, -1):
            if state.marginal_utility(job, kappa) <= 0:
                break
            emb = _first_fit_ring(scratch, job, kappa)
            if emb is not None:
                scratch.commit(emb, job.demands)
                out.append(Candidate(
                    job_id=jid, kappa=kappa,
                    utility=state.marginal_utility(job, kappa),
                    embedding=emb,
                    node_demand={(s, r): v for s, dd in
                                 emb.node_demand(job.demands).items()
                                 for r, v in dd.items()},
                    edge_demand=emb.edge_demand(),
                ))
                placed.add(jid)
                break
    return out


def _first_fit_ring(res: ResourceState, job: Job, kappa: int) -> Optional[Embedding]:
    """Greedy ring placement against current residual capacity."""
    caps = {s.id: res.max_workers_on_server(s.id, job.demands, cap=job.max_workers)
            for s in res.graph.servers}
    # colocate on the freest server that fits
    fits = [s for s, c in caps.items() if c >= kappa]
    if fits:
        best = max(fits, key=lambda s: caps[s])
        return build_embedding(res, job, [best], [kappa])
    # otherwise spread over the freest servers
    order = sorted((s for s, c in caps.items() if c > 0), key=lambda s: -caps[s])
    chosen, counts, remaining = [], [], kappa
    for s in order:
        take = min(caps[s], remaining)
        chosen.append(s)
        counts.append(take)
        remaining -= take
        if remaining == 0:
            break
    if remaining > 0:
        return None
    ring = _ring_order(chosen, res.graph)
    cmap = dict(zip(chosen, counts))
    return build_embedding(res, job, ring, [cmap[s] for s in ring])


# ---------------------------------------------------------------------------
# Main entry points
# ---------------------------------------------------------------------------

def solve_slot(
    res: ResourceState,
    jobs: Sequence[Job],
    state: ScheduleState,
    cfg: Optional[GvneConfig] = None,
) -> GvneResult:
    """Algorithm 2 (LP-RS-MDE) for one time slot."""
    cfg = cfg or GvneConfig()
    rng = np.random.default_rng(cfg.seed)
    jobs = list(jobs)
    n_active = len(jobs)

    # admission window: keep the top-K active jobs by single-worker marginal
    # utility (the density Lemma 7 scores by), preserving relative order so
    # the RNG consumption sequence only depends on the admitted set
    if cfg.admission_window is not None and n_active > cfg.admission_window:
        ranked = sorted(
            range(n_active),
            key=lambda k: (-state.marginal_utility(jobs[k], 1), k),
        )
        jobs = [jobs[k] for k in sorted(ranked[: cfg.admission_window])]
    job_map = {j.id: j for j in jobs}

    # steps 1-2: bounds + candidates for every kappa in {1..q_i}. The
    # vectorized path computes one packability matrix for the whole slot and
    # shares each job's row across its kappas — bit-identical values to the
    # per-call worker_upper_bound/generate_candidates rebuild (the caps are
    # integers and res is not mutated until step 7's scratch clone).
    caps_rows: List[Optional[Dict[int, int]]]
    if cfg.vectorized and jobs:
        server_ids, caps_mat = slot_caps_matrix(res, jobs)
        caps_rows = [
            {sid: int(caps_mat[k, i]) for i, sid in enumerate(server_ids)}
            for k in range(len(jobs))
        ]
    else:
        caps_rows = [None] * len(jobs)
    cands: List[Candidate] = []
    for job, caps in zip(jobs, caps_rows):
        if caps is None:
            q = worker_upper_bound(res, job, state.remaining(job))
        else:
            packable = int(sum(caps.values()))
            q = int(max(0, math.floor(
                min(job.max_workers, state.remaining(job), packable) + 1e-9
            )))
        for kappa in range(1, q + 1):
            pi = state.marginal_utility(job, kappa)
            if pi <= 0:
                continue
            cands.extend(
                generate_candidates(res, job, kappa, pi, cfg, rng, caps=caps)
            )
    if not cands:
        return GvneResult([], 0.0, 0.0, 0.0, 0, True, {"n_candidates": 0})

    # step 3: LP relaxation + ring selection (Lemma 7)
    phi, lp_value = _solve_selection_lp(cands, res, cfg.lp_engine)
    ring_sizes = lp_ring_selection(cands, phi)

    # step 4: augmented LP restricted to selected ring sizes
    aug = [c for c in cands if ring_sizes.get(c.job_id) == c.kappa]
    phi_aug, _ = _solve_selection_lp(aug, res, cfg.lp_engine)

    # step 5: mapping-selection tuples M_i
    by_job: Dict[int, List[Tuple[float, Candidate]]] = {}
    for c, f in zip(aug, phi_aug):
        if f > 1e-9:
            by_job.setdefault(c.job_id, []).append((float(f), c))

    # step 6: randomized rounding until (alpha, beta^r, gamma)-approx or u_b
    betas, gamma_slack = _violation_slacks(aug, res, cfg.epsilon)
    best_choice: List[Candidate] = []
    best_value = -1.0
    accepted = False
    n_rounds = 0
    for n_rounds in range(1, cfg.u_b + 1):
        chosen = _round_once(by_job, rng)
        value, node_use, edge_use = _eval_choice(chosen, res)
        if value > best_value:
            best_value, best_choice = value, chosen
        ok = value >= cfg.alpha * lp_value - 1e-9
        for (s, r), v in node_use.items():
            if v > betas.get(r, 1.0) * res.free_node[s].get(r, 0.0) + 1e-9:
                ok = False
                break
        if ok:
            for e, v in edge_use.items():
                if v > gamma_slack * res.admissible_edge_capacity(e) + 1e-9:
                    ok = False
                    break
        if ok:
            accepted = True
            best_value, best_choice = value, chosen
            break

    # step 7: strict-feasibility repair + greedy backfill of rejected jobs
    scratch = res.clone()
    kept = _repair(best_choice, scratch, job_map)
    kept = _backfill(kept, cands, scratch, job_map, state)
    if res.oversubscription > 1.0:
        # the LP cannot price fair-sharing; re-route rings that landed on
        # oversubscribed edges now that the slot's full commit set is known
        kept = _reroute_contended(kept, scratch, job_map)
    embeddings = [c.embedding for c in kept]
    final_value = sum(
        state.marginal_utility(job_map[e.job_id], e.n_workers) for e in embeddings
    )
    return GvneResult(
        embeddings=embeddings,
        lp_value=lp_value,
        rounded_value=best_value,
        value=final_value,
        n_rounds=n_rounds,
        accepted=accepted,
        diagnostics={
            "n_candidates": float(len(cands)),
            "n_aug": float(len(aug)),
            "n_jobs_embedded": float(len(embeddings)),
            "n_jobs_active": float(n_active),
            "n_jobs_admitted": float(len(jobs)),
        },
    )


def solve_slot_exact(
    res: ResourceState,
    jobs: Sequence[Job],
    state: ScheduleState,
    max_servers: int = 4,
    time_limit: float = 60.0,
) -> GvneResult:
    """Exact per-slot optimum via HiGHS MILP over exhaustive candidates.

    This is the paper's Gurobi branch-and-bound baseline (Fig. 7). Use only on
    small instances — candidate enumeration is exponential.
    """
    cands: List[Candidate] = []
    for job in jobs:
        q = worker_upper_bound(res, job, state.remaining(job))
        for kappa in range(1, q + 1):
            pi = state.marginal_utility(job, kappa)
            if pi <= 0:
                continue
            cands.extend(enumerate_all_candidates(res, job, kappa, pi, max_servers))
    if not cands:
        return GvneResult([], 0.0, 0.0, 0.0, 0, True, {"n_candidates": 0})
    A, b, c, _ = _build_lp(cands, res)
    r = solve_ilp(c, A_ub=A, b_ub=b, upper=np.ones(len(c)), time_limit=time_limit)
    chosen = [cands[k] for k in range(len(cands)) if r.x[k] > 0.5]
    embeddings = [c.embedding for c in chosen]
    return GvneResult(
        embeddings=embeddings,
        lp_value=r.value,
        rounded_value=r.value,
        value=sum(c.utility for c in chosen),
        n_rounds=0,
        accepted=True,
        diagnostics={"n_candidates": float(len(cands)), "milp_status": float(r.status)},
    )
