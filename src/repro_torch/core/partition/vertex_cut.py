"""Vertex-cut partitioning (the port's copy of
`repro/core/partition/vertex_cut.py`): edges are partitioned and vertices
replicate.  The 2D Cartesian vertex cut of CAGNET/DeepGalois, a random cut
and a balance-capped Libra/PowerGraph greedy.

Edge order convention: edges are numbered in CSR order, ``for v in
range(V): for u in g.neighbors(v)``, so edge ``e`` has destination
``repeat(arange(V), deg)[e]`` and source ``g.indices[e]``.  Every function
here, and the replica layout built on top in ``vertex_layout.py``, relies on
that order.  Each cut makes the reference's numpy RNG calls in the same
order, so one seed gives the same assignment in both packages; the Libra
greedy stays a loop over every edge, as the reference's, and runs on small
graphs only.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np

from repro_torch.core.graph import Graph


def edge_endpoints(g: Graph) -> Tuple[np.ndarray, np.ndarray]:
    """(src, dst) arrays in CSR edge order (see module docstring)."""
    dst = np.repeat(np.arange(g.num_vertices, dtype=np.int64), g.degree())
    return g.indices.astype(np.int64), dst


@dataclasses.dataclass
class VertexCut:
    edge_owner: np.ndarray  # [E] partition id per edge (CSR order)
    num_parts: int
    masters: np.ndarray  # [V] master partition per vertex

    def replica_counts(self, g: Graph, include_masters: bool = False
                       ) -> np.ndarray:
        """[V] number of partitions in which each vertex appears (as an
        endpoint of an owned edge; with ``include_masters`` also counting the
        forced master replica the execution layout materializes)."""
        V = g.num_vertices
        src, dst = edge_endpoints(g)
        owner = self.edge_owner.astype(np.int64)
        keys = [owner * V + dst, owner * V + src]
        if include_masters:
            keys.append(self.masters.astype(np.int64) * V
                        + np.arange(V, dtype=np.int64))
        uniq = np.unique(np.concatenate(keys)) if len(owner) or include_masters \
            else np.zeros(0, np.int64)
        return np.bincount(uniq % V, minlength=V)

    def replication_factor(self, g: Graph) -> float:
        """Mean number of partitions in which a vertex appears."""
        appears = self.replica_counts(g)
        return float(appears[appears > 0].mean()) if (appears > 0).any() else 0.0


def random_vertex_cut(g: Graph, k: int, seed: int = 0) -> VertexCut:
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, k, g.num_edges).astype(np.int32)
    masters = rng.integers(0, k, g.num_vertices).astype(np.int32)
    return VertexCut(owner, k, masters)


def cartesian_2d_vertex_cut(g: Graph, rows: int, cols: int, seed: int = 0) -> VertexCut:
    """2D Cartesian: edge (u->v) owned by grid block (row(u), col(v)), so
    each vertex replicates across at most rows+cols-1 partitions; the master
    block (row(v), col(v)) sits in that same row/col cross."""
    rng = np.random.default_rng(seed)
    row_of = rng.integers(0, rows, g.num_vertices)
    col_of = rng.integers(0, cols, g.num_vertices)
    src, dst = edge_endpoints(g)
    owner = (row_of[src] * cols + col_of[dst]).astype(np.int32)
    masters = (row_of * cols + col_of).astype(np.int32)
    return VertexCut(owner, rows * cols, masters)


def libra_vertex_cut(g: Graph, k: int, seed: int = 0,
                     slack: float = 1.15) -> VertexCut:
    """Degree-aware greedy vertex cut (Libra/PowerGraph/HDRF-style).  Per
    edge, in order: a partition already holding BOTH endpoints, else one
    holding the LOWER-degree endpoint (replicate the hub, keep the tail
    vertex local), else one holding either, else the globally least-loaded,
    always the least-loaded within the chosen tier.  Candidates at or above
    the balance cap ``slack * E / k`` are skipped.  Masters: the
    highest-replication vertices first, each to its least-traffic holding
    partition.  A loop over every edge, as the reference's."""
    V = g.num_vertices
    deg = g.degree() + g.out_degree()  # total degree: the HDRF tie-break
    loads = np.zeros(k, np.int64)
    holds = np.zeros((k, V), bool)
    cap = max(slack * g.num_edges / k, 1.0)
    owner = np.zeros(g.num_edges, np.int32)
    big = np.iinfo(np.int64).max
    e = 0
    for v in range(V):
        for u in g.neighbors(v):
            under = loads < cap
            hu, hv = holds[:, u] & under, holds[:, v] & under
            both = hu & hv
            if both.any():
                cand = both
            else:
                lo = hu if deg[u] <= deg[v] else hv  # replicate the hub
                cand = lo if lo.any() else (hu | hv)
            if cand.any():
                i = int(np.where(cand, loads, big).argmin())
            else:
                i = int(loads.argmin())
            owner[e] = i
            holds[i, u] = True
            holds[i, v] = True
            loads[i] += 1
            e += 1
    r = holds.sum(0)
    masters = np.empty(V, np.int32)
    traffic = np.zeros(k, np.int64)
    for v in np.argsort(-r, kind="stable"):
        hs = np.flatnonzero(holds[:, v])
        if len(hs) == 0:
            masters[v] = v % k
            continue
        i = hs[np.argmin(traffic[hs])]
        masters[v] = i
        traffic[i] += max(int(r[v]) - 1, 0)
    return VertexCut(owner, k, masters)


def grid_for(k: int) -> Tuple[int, int]:
    """rows x cols = k with rows the largest divisor <= sqrt(k): the 2D
    Cartesian grid the engine uses when only a rank count is given."""
    r = max(int(np.sqrt(k)), 1)
    while k % r:
        r -= 1
    return r, k // r


VERTEX_CUTS: Dict[str, Callable] = {
    "random": random_vertex_cut,
    "cartesian2d": lambda g, k, seed=0: cartesian_2d_vertex_cut(
        g, *grid_for(k), seed=seed),
    "libra": libra_vertex_cut,
}
