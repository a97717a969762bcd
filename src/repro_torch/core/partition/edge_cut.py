"""Edge-cut graph partitioners (the port's copy of
`repro/core/partition/edge_cut.py`, survey §4.2): hash, range, LDG streaming
with GNN affinity scores, block-based (multi-source-BFS coarsening + greedy),
and a METIS-like multilevel partitioner with boundary refinement.

Every partitioner gives the reference's assignment for the same graph and
seed.  The quality metrics and the coarsening's edge list are vectorised over
the CSR (the reference loops over every vertex; both visit the edges in CSR
order).  What is sequential by nature stays a loop over the vertices in the
reference's order: the streaming assignment (LDG, the block greedy), the
heavy-edge matching and the FM refinement.  At one part every partitioner
assigns every vertex to part 0.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List

import numpy as np

from repro_torch.core.graph import Graph, from_edges
from repro_torch.core.partition.cost_models import (
    bgl_score,
    bytegnn_score,
    pagraph_score,
)


def _edge_rows(g: Graph) -> np.ndarray:
    """The destination vertex of every CSR entry: ``indices[e]`` is an
    in-neighbor of ``_edge_rows(g)[e]``."""
    return np.repeat(np.arange(g.num_vertices, dtype=np.int64), g.degree())


@dataclasses.dataclass
class Partition:
    assignment: np.ndarray  # [V] int32 partition id
    num_parts: int

    def parts(self) -> List[np.ndarray]:
        return [np.where(self.assignment == i)[0] for i in range(self.num_parts)]

    # -- quality metrics (survey challenges #1/#3) --------------------------
    def edge_cut_fraction(self, g: Graph) -> float:
        a = self.assignment
        cut = int((a[g.indices] != a[_edge_rows(g)]).sum())
        return cut / max(g.num_edges, 1)

    def vertex_balance(self) -> float:
        sizes = np.bincount(self.assignment, minlength=self.num_parts)
        return float(sizes.max() / max(sizes.mean(), 1e-9))

    def train_balance(self, g: Graph) -> float:
        if g.train_mask is None:
            return 1.0
        counts = np.bincount(self.assignment[g.train_mask], minlength=self.num_parts)
        return float(counts.max() / max(counts.mean(), 1e-9))

    def boundary_vertices(self, g: Graph, part: int) -> np.ndarray:
        """Remote in-neighbors needed by `part` (communication volume
        proxy), sorted."""
        a = self.assignment
        sel = (a[_edge_rows(g)] == part) & (a[g.indices] != part)
        return np.unique(g.indices[sel]).astype(np.int64)

    def communication_volume(self, g: Graph) -> int:
        """The sum over parts of `boundary_vertices`' sizes: the distinct
        (part, remote in-neighbor) pairs over the cut edges."""
        a = self.assignment.astype(np.int64)
        rows = a[_edge_rows(g)]
        cut = rows != a[g.indices]
        pairs = rows[cut] * g.num_vertices + g.indices[cut]
        return int(np.unique(pairs).size)


def hash_partition(g: Graph, k: int, seed: int = 0) -> Partition:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(g.num_vertices)
    return Partition((perm % k).astype(np.int32), k)


def range_partition(g: Graph, k: int) -> Partition:
    """ROC-style contiguous ranges (consecutively-numbered vertices)."""
    bounds = np.linspace(0, g.num_vertices, k + 1).astype(np.int64)
    a = np.zeros(g.num_vertices, np.int32)
    for i in range(k):
        a[bounds[i] : bounds[i + 1]] = i
    return Partition(a, k)


def range_partition_by_cost(g: Graph, k: int, vertex_cost: np.ndarray) -> Partition:
    """ROC: contiguous ranges balanced by a cost model's per-vertex cost."""
    c = np.cumsum(vertex_cost)
    total = c[-1]
    a = np.minimum((c / total * k).astype(np.int32), k - 1)
    return Partition(a, k)


def ldg_partition(g: Graph, k: int, score: str = "ldg", slack: float = 1.1,
                  seed: int = 0) -> Partition:
    """Linear Deterministic Greedy streaming partition [Stanton & Kliot],
    optionally with the GNN affinity scores of Eq. 3 ('pagraph')."""
    rng = np.random.default_rng(seed)
    V = g.num_vertices
    cap = slack * V / k
    assignment = np.full(V, -1, np.int32)
    part_sets: List[set] = [set() for _ in range(k)]
    train_sets: List[set] = [set() for _ in range(k)]
    sizes = np.zeros(k)
    train_mask = g.train_mask if g.train_mask is not None else np.zeros(V, bool)
    order = rng.permutation(V)
    n_train = train_mask.sum()
    for v in order:
        nb = g.neighbors(v)
        if score == "pagraph" and train_mask[v]:
            s = pagraph_score(nb, train_sets, sizes, n_train / k)
        else:  # classic LDG: |P_i ∩ N(v)| * (1 - |P_i|/cap)
            s = np.zeros(k)
            nbs = set(nb.tolist())
            for i in range(k):
                s[i] = len(part_sets[i] & nbs) * (1.0 - sizes[i] / cap)
        full = sizes >= cap
        s = np.where(full, -np.inf, s)
        if np.all(~np.isfinite(s)) or s.max() <= 0:
            i = int(np.argmin(sizes))
        else:
            i = int(np.argmax(s))
        assignment[v] = i
        part_sets[i].add(int(v))
        sizes[i] += 1
        if train_mask[v]:
            train_sets[i].add(int(v))
    return Partition(assignment, k)


def multi_source_bfs_blocks(g: Graph, num_blocks: int, seed: int = 0) -> np.ndarray:
    """Coarsen into blocks by multi-source BFS (BGL / ByteGNN §4.2)."""
    rng = np.random.default_rng(seed)
    V = g.num_vertices
    sources = rng.choice(V, size=min(num_blocks, V), replace=False)
    block = np.full(V, -1, np.int64)
    q = deque()
    for b, s in enumerate(sources):
        block[s] = b
        q.append(s)
    while q:
        v = q.popleft()
        for u in g.neighbors(v):
            if block[u] < 0:
                block[u] = block[v]
                q.append(u)
    # orphans (disconnected): round-robin
    orphans = np.where(block < 0)[0]
    block[orphans] = np.arange(len(orphans)) % max(num_blocks, 1)
    return block


def block_partition(g: Graph, k: int, *, blocks_per_part: int = 8,
                    score: str = "bgl", seed: int = 0) -> Partition:
    """Block-based streaming partition (BGL Eq. 4 / ByteGNN Eq. 5):
    multi-source BFS -> greedy block assignment -> uncoarsen."""
    nb_blocks = k * blocks_per_part
    block = multi_source_bfs_blocks(g, nb_blocks, seed)
    V = g.num_vertices
    train_mask = g.train_mask if g.train_mask is not None else np.zeros(V, bool)
    val_mask = g.val_mask if g.val_mask is not None else np.zeros(V, bool)
    test_mask = g.test_mask if g.test_mask is not None else np.zeros(V, bool)
    assignment = np.full(V, -1, np.int32)
    part_sets: List[set] = [set() for _ in range(k)]
    sizes = np.zeros(k)
    tr = np.zeros(k)
    va = np.zeros(k)
    te = np.zeros(k)
    # the blocks, largest first (ties in the reference's sort order)
    order = np.argsort(-np.bincount(block, minlength=nb_blocks)[:nb_blocks])
    for b in order:
        verts = np.where(block == b)[0]
        if len(verts) == 0:
            continue
        in_nbrs = np.unique(np.concatenate([g.neighbors(v) for v in verts]))
        if score == "bgl":
            s = bgl_score(in_nbrs, part_sets, sizes, tr, V / k,
                          max(train_mask.sum() / k, 1))
        else:  # bytegnn
            cross = np.array([len(part_sets[i] & set(in_nbrs.tolist()))
                              for i in range(k)], float)
            s = bytegnn_score(cross, sizes, tr, va, te,
                              (max(train_mask.sum() / k, 1),
                               max(val_mask.sum() / k, 1),
                               max(test_mask.sum() / k, 1)))
        i = (int(np.argmax(s)) if np.isfinite(s).any() and s.max() > 0
             else int(np.argmin(sizes)))
        assignment[verts] = i
        part_sets[i].update(verts.tolist())
        sizes[i] += len(verts)
        tr[i] += train_mask[verts].sum()
        va[i] += val_mask[verts].sum()
        te[i] += test_mask[verts].sum()
    return Partition(assignment, k)


# ---------------------------------------------------------------------------
# METIS-like multilevel partitioner
# ---------------------------------------------------------------------------


def _heavy_edge_matching(g: Graph, rng) -> np.ndarray:
    """Match each vertex with an unmatched neighbor; returns coarse ids."""
    V = g.num_vertices
    matched = np.full(V, -1, np.int64)
    order = rng.permutation(V)
    next_id = 0
    for v in order:
        if matched[v] >= 0:
            continue
        mate = -1
        for u in g.neighbors(v):
            if matched[u] < 0 and u != v:
                mate = int(u)
                break
        matched[v] = next_id
        if mate >= 0:
            matched[mate] = next_id
        next_id += 1
    return matched


def _coarsen(g: Graph, coarse_id: np.ndarray) -> Graph:
    """The coarse graph: an edge cu -> cv for every fine edge u -> v whose
    ends fall in different coarse vertices, in CSR order."""
    Vc = int(coarse_id.max()) + 1
    cv = coarse_id[_edge_rows(g)]
    cu = coarse_id[g.indices]
    keep = cu != cv
    return from_edges(cu[keep].astype(np.int64), cv[keep].astype(np.int64), Vc)


def _refine_boundary(g: Graph, assignment: np.ndarray, k: int, passes: int = 2,
                     balance_slack: float = 1.05) -> np.ndarray:
    """FM-style single-vertex moves that reduce cut while keeping balance."""
    sizes = np.bincount(assignment, minlength=k).astype(np.int64)
    cap = balance_slack * g.num_vertices / k
    for _ in range(passes):
        moved = 0
        for v in range(g.num_vertices):
            nb = g.neighbors(v)
            if len(nb) == 0:
                continue
            counts = np.bincount(assignment[nb], minlength=k)
            cur = assignment[v]
            best = int(np.argmax(counts))
            if best != cur and counts[best] > counts[cur] and sizes[best] < cap:
                assignment[v] = best
                sizes[cur] -= 1
                sizes[best] += 1
                moved += 1
        if moved == 0:
            break
    return assignment


def metis_like_partition(g: Graph, k: int, *, coarsen_to: int = 256,
                         seed: int = 0) -> Partition:
    """Multilevel: heavy-edge matching coarsening -> LDG on the coarse graph
    -> uncoarsen with FM refinement at each level."""
    rng = np.random.default_rng(seed)
    graphs = [g]
    maps = []
    while graphs[-1].num_vertices > max(coarsen_to, 4 * k):
        cid = _heavy_edge_matching(graphs[-1], rng)
        if cid.max() + 1 >= graphs[-1].num_vertices:  # no progress
            break
        maps.append(cid)
        graphs.append(_coarsen(graphs[-1], cid))
    part = ldg_partition(graphs[-1], k, seed=seed)
    assignment = part.assignment
    for cid, fine_g in zip(reversed(maps), reversed(graphs[:-1])):
        assignment = assignment[cid]
        assignment = _refine_boundary(fine_g, assignment.copy(), k)
    return Partition(assignment.astype(np.int32), k)


PARTITIONERS: Dict[str, Callable] = {
    "hash": hash_partition,
    "range": lambda g, k, **kw: range_partition(g, k),
    "ldg": ldg_partition,
    "pagraph": lambda g, k, **kw: ldg_partition(g, k, score="pagraph", **kw),
    "block": block_partition,
    "bytegnn": lambda g, k, **kw: block_partition(g, k, score="bytegnn", **kw),
    "metis_like": metis_like_partition,
}
