"""Fat-tree substrate graph + multi-resource state tracking — paper §IV.

The physical cluster is a directed substrate graph: servers (leaves) connect
to their rack's ToR switch; ToR switches connect to ``n_core`` core switches
(ECMP gives multiple server-to-server paths, exercising the paper's path sets
P_ss'[t]). Node resources are multi-dimensional (e.g. gpus, memory); link
resources are bandwidth. ``ResourceState`` tracks free capacities over time
and commits/releases ring embeddings atomically.

A ring **Embedding** (paper Fig. 2) is an ordered cycle of (server, #workers)
groups. Workers on one server are contiguous in the ring — this is exactly the
paper's degree-2 constraint, Eq. (9): every participating server has ring-path
degree 2 (or the whole job is colocated on one server and needs no paths).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

NodeId = str  # "s<i>" servers, "r<i>" ToR switches, "c<i>" core switches
Edge = Tuple[NodeId, NodeId]


@dataclasses.dataclass(frozen=True)
class Server:
    id: int
    rack: int
    caps: Dict[str, float]  # type-r capacities C_s^r, e.g. {"gpus": 8}

    @property
    def node(self) -> NodeId:
        return f"s{self.id}"


@dataclasses.dataclass(frozen=True)
class Link:
    u: NodeId
    v: NodeId
    capacity: float  # bandwidth (bytes/s or abstract units)


class SubstrateGraph:
    """Static cluster topology. Mutable free-capacity state lives in
    :class:`ResourceState`."""

    def __init__(self, servers: Sequence[Server], links: Sequence[Link], n_racks: int,
                 n_core: int):
        self.servers = list(servers)
        self.n_racks = n_racks
        self.n_core = n_core
        self.links: Dict[Edge, float] = {(l.u, l.v): l.capacity for l in links}
        self.server_by_id = {s.id: s for s in self.servers}
        self.resource_types = sorted({r for s in self.servers for r in s.caps})
        self._path_cache: Dict[Tuple[int, int], List[Tuple[NodeId, ...]]] = {}

    # -- path enumeration (the paper's P_ss'[t]) ---------------------------
    def paths(self, s: int, s2: int) -> List[Tuple[NodeId, ...]]:
        """All simple fat-tree paths between servers s and s2.

        Same rack: one path via the ToR. Different racks: one path per core
        switch (ECMP multipath).
        """
        if s == s2:
            return [(f"s{s}",)]
        key = (s, s2)
        if key in self._path_cache:
            return self._path_cache[key]
        a, b = self.server_by_id[s], self.server_by_id[s2]
        out: List[Tuple[NodeId, ...]] = []
        if a.rack == b.rack:
            out.append((a.node, f"r{a.rack}", b.node))
        else:
            for c in range(self.n_core):
                out.append((a.node, f"r{a.rack}", f"c{c}", f"r{b.rack}", b.node))
        self._path_cache[key] = out
        return out

    @staticmethod
    def path_edges(path: Tuple[NodeId, ...]) -> List[Edge]:
        return list(zip(path[:-1], path[1:]))

    def total_caps(self) -> Dict[str, float]:
        out: Dict[str, float] = {r: 0.0 for r in self.resource_types}
        for s in self.servers:
            for r, c in s.caps.items():
                out[r] += c
        return out

    def all_edges(self) -> List[Edge]:
        return list(self.links)


@dataclasses.dataclass
class Embedding:
    """A placed ring for one job: the paper's (x, y, r) decision at one slot.

    groups: ring-ordered (server_id, n_workers); total workers = ring size κ.
    paths:  one substrate path per consecutive server pair in the cycle
            (len == len(groups) if len(groups) >= 2 else 0). For a 2-server
            ring the forward and return paths are both present (directed).
    """

    job_id: int
    groups: List[Tuple[int, int]]
    paths: List[Tuple[NodeId, ...]]
    bandwidth: float  # b_i reserved on every edge of every path

    @property
    def n_workers(self) -> int:
        return sum(n for _, n in self.groups)

    @property
    def servers(self) -> List[int]:
        return [s for s, _ in self.groups]

    def node_demand(self, demands: Dict[str, float]) -> Dict[int, Dict[str, float]]:
        """Per-server multi-resource demand l_i^r * y_is."""
        out: Dict[int, Dict[str, float]] = {}
        for s, n in self.groups:
            d = out.setdefault(s, {r: 0.0 for r in demands})
            for r, l in demands.items():
                d[r] += l * n
        return out

    def edge_demand(self) -> Dict[Edge, float]:
        out: Dict[Edge, float] = {}
        for p in self.paths:
            for e in SubstrateGraph.path_edges(p):
                out[e] = out.get(e, 0.0) + self.bandwidth
        return out

    def validate_ring(self) -> None:
        """Degree-2 / single-cycle structural checks (paper Eq. (9))."""
        servers = self.servers
        if len(set(servers)) != len(servers):
            raise ValueError("server appears twice in ring order (degree > 2)")
        if len(servers) >= 2 and len(self.paths) != len(servers):
            raise ValueError("cycle needs exactly one path per adjacent server pair")
        if len(servers) == 1 and self.paths:
            raise ValueError("colocated ring must not reserve paths")
        for k, p in enumerate(self.paths):
            a = servers[k]
            b = servers[(k + 1) % len(servers)]
            if p[0] != f"s{a}" or p[-1] != f"s{b}":
                raise ValueError(f"path {k} does not connect s{a}->s{b}")


class ResourceState:
    """Free multi-resource node capacities + free link bandwidth at one slot.

    ``oversubscription`` > 1 switches edge admission from hard reservation to
    a contended regime: an edge accepts reservations up to
    ``oversubscription * capacity``, and every ring crossing an oversubscribed
    edge sees only its fair share of the physical capacity (cf. Yu et al.,
    arXiv:2207.07817; Wang et al., arXiv:2002.10105). The default of 1.0
    reproduces the paper's isolated-ring pricing exactly.
    """

    def __init__(self, graph: SubstrateGraph, oversubscription: float = 1.0):
        self.graph = graph
        self.oversubscription = max(1.0, float(oversubscription))
        self.free_node: Dict[int, Dict[str, float]] = {
            s.id: dict(s.caps) for s in graph.servers
        }
        # residual = capacity - sum of reservations; may go *negative* when
        # oversubscription > 1 (reservations may exceed physical capacity).
        self.free_edge: Dict[Edge, float] = dict(graph.links)
        self.committed: Dict[int, Embedding] = {}

    # -- queries ------------------------------------------------------------
    def max_workers_on_server(
        self, server: int, demands: Dict[str, float], cap: Optional[int] = None
    ) -> int:
        """Workers of per-worker demand ``demands`` fitting in free capacity.

        ``cap`` (the job's N_i) bounds the answer; it is *required* when no
        demand entry is positive, since free capacity then imposes no limit.
        """
        if not demands:
            raise ValueError("max_workers_on_server: empty demand vector")
        free = self.free_node[server]
        lim = float("inf")
        for r, l in demands.items():
            if l > 0:
                lim = min(lim, free.get(r, 0.0) / l)
        if lim == float("inf"):
            if cap is None:
                raise ValueError(
                    "max_workers_on_server: no positive demand and no cap — "
                    "placement would be unbounded"
                )
            return max(0, int(cap))
        n = int(np.floor(lim + 1e-9))
        return min(n, max(0, int(cap))) if cap is not None else n

    def _edge_slack(self, e: Edge) -> float:
        """Extra admissible reservation beyond residual under oversubscription."""
        return (self.oversubscription - 1.0) * self.graph.links.get(e, 0.0)

    def admissible_edge_capacity(self, e: Edge) -> float:
        """Reservation an edge can still accept: residual plus the
        oversubscription allowance, floored at zero. The single admission
        bound shared by feasibility, path selection, and the G-VNE LP."""
        return max(0.0, self.free_edge.get(e, 0.0) + self._edge_slack(e))

    def reserved_edge(self, e: Edge) -> float:
        """Total bandwidth currently reserved on edge e."""
        cap = self.graph.links.get(e, 0.0)
        return cap - self.free_edge.get(e, cap)

    def best_path(self, s: int, s2: int, bandwidth: float) -> Optional[Tuple[NodeId, ...]]:
        """Max-bottleneck admissible path in P_ss', else None.

        Paths are scored by bottleneck residual, so among admissible paths the
        *least contended* one wins; under oversubscription a path whose
        residual is below ``bandwidth`` is still admissible as long as every
        edge stays within ``oversubscription * capacity``.
        """
        best, best_bn = None, -float("inf")
        for p in self.graph.paths(s, s2):
            edges = SubstrateGraph.path_edges(p)
            bn = min(self.free_edge[e] for e in edges)
            admissible = all(
                bandwidth <= self.admissible_edge_capacity(e) + 1e-9
                for e in edges
            )
            if admissible and bn > best_bn:
                best, best_bn = p, bn
        return best

    def feasible(self, emb: Embedding, demands: Dict[str, float]) -> bool:
        emb.validate_ring()
        for s, need in emb.node_demand(demands).items():
            for r, v in need.items():
                if v > self.free_node[s].get(r, 0.0) + 1e-9:
                    return False
        for e, v in emb.edge_demand().items():
            if v > self.admissible_edge_capacity(e) + 1e-9:
                return False
        return True

    # -- contention (fair-share effective bandwidth) ------------------------
    def effective_bandwidth(self, emb: Embedding, include_self: bool = False) -> float:
        """Effective per-hop bandwidth of ``emb`` under fair-share contention.

        For each edge the ring reserves, its share of the physical capacity is
        ``reservation * capacity / total_reserved`` whenever the edge is
        oversubscribed (total reserved > capacity); the ring's per-hop
        bandwidth is the bottleneck share over all its edges. With no
        oversubscribed edge this equals the reserved b_i (the paper's Eq. (1)
        pricing). ``include_self=True`` adds the embedding's own demand first
        (pre-commit prediction for candidate pricing).
        """
        if not emb.paths:
            return emb.bandwidth
        b_eff = emb.bandwidth
        for e, v in emb.edge_demand().items():
            cap = self.graph.links.get(e, 0.0)
            reserved = self.reserved_edge(e) + (v if include_self else 0.0)
            if cap <= 0.0:
                return 0.0
            if reserved > cap:
                b_eff = min(b_eff, emb.bandwidth * cap / reserved)
        return b_eff

    def edge_contention(self) -> Dict[Edge, float]:
        """reserved/capacity per edge with a nonzero reservation."""
        out: Dict[Edge, float] = {}
        for e, cap in self.graph.links.items():
            reserved = self.reserved_edge(e)
            if reserved > 1e-12 and cap > 0:
                out[e] = reserved / cap
        return out

    def max_edge_contention(self) -> float:
        """Max reserved/capacity over edges (0.0 when nothing is reserved;
        values > 1.0 mean at least one edge is oversubscribed)."""
        cont = self.edge_contention()
        return max(cont.values()) if cont else 0.0

    # -- mutation -----------------------------------------------------------
    def commit(self, emb: Embedding, demands: Dict[str, float]) -> None:
        if not self.feasible(emb, demands):
            raise ValueError(f"infeasible embedding for job {emb.job_id}")
        for s, need in emb.node_demand(demands).items():
            for r, v in need.items():
                self.free_node[s][r] -= v
        for e, v in emb.edge_demand().items():
            self.free_edge[e] -= v
        self.committed[emb.job_id] = emb

    def release(self, job_id: int, demands: Dict[str, float]) -> None:
        emb = self.committed.pop(job_id)
        for s, need in emb.node_demand(demands).items():
            for r, v in need.items():
                self.free_node[s][r] += v
        for e, v in emb.edge_demand().items():
            self.free_edge[e] += v

    def clone(self) -> "ResourceState":
        out = ResourceState.__new__(ResourceState)
        out.graph = self.graph
        out.oversubscription = self.oversubscription
        out.free_node = {s: dict(v) for s, v in self.free_node.items()}
        out.free_edge = dict(self.free_edge)
        out.committed = dict(self.committed)
        return out

    def utilization(self, exclude: Optional[Iterable[int]] = None) -> Dict[str, float]:
        """Fraction of capacity in use, per resource type.

        ``exclude`` removes servers (e.g. failed ones) from both the used and
        total sides, so downed capacity never counts as *in use*; with every
        server excluded the utilization is defined as 0.0.
        """
        excl = set(exclude or ())
        total = {r: 0.0 for r in self.graph.resource_types}
        free = {r: 0.0 for r in total}
        for s in self.graph.servers:
            if s.id in excl:
                continue
            for r in total:
                total[r] += s.caps.get(r, 0.0)
                free[r] += self.free_node[s.id].get(r, 0.0)
        return {r: 1.0 - free[r] / total[r] if total[r] else 0.0 for r in total}


def make_fat_tree(
    n_servers: int = 50,
    *,
    n_racks: Optional[int] = None,
    n_core: int = 2,
    gpus_choices: Sequence[int] = (1, 2, 4, 8),
    mem_per_gpu: float = 4.0,
    server_rack_bw: Tuple[float, float] = (10e9, 100e9),
    rack_core_bw: Tuple[float, float] = (200e9, 3200e9),
    seed: int = 0,
) -> SubstrateGraph:
    """Paper §VI settings: S=50 servers, racks ~ U[2,5], GPUs in {1,2,4,8},
    server<->rack bandwidth U[10,100] Gbps, rack<->core U[200,3200] Gbps."""
    rng = np.random.default_rng(seed)
    if n_racks is None:
        n_racks = int(rng.integers(2, 6))
    servers = []
    for i in range(n_servers):
        g = int(rng.choice(gpus_choices))
        servers.append(
            Server(id=i, rack=int(rng.integers(0, n_racks)),
                   caps={"gpus": float(g), "mem": float(g) * mem_per_gpu})
        )
    links: List[Link] = []
    for s in servers:
        bw = float(rng.uniform(*server_rack_bw))
        links.append(Link(s.node, f"r{s.rack}", bw))
        links.append(Link(f"r{s.rack}", s.node, bw))
    for r in range(n_racks):
        for c in range(n_core):
            bw = float(rng.uniform(*rack_core_bw))
            links.append(Link(f"r{r}", f"c{c}", bw))
            links.append(Link(f"c{c}", f"r{r}", bw))
    return SubstrateGraph(servers, links, n_racks, n_core)
