"""Graph container and deterministic synthetic graph generators (the port's
copy of `repro/core/graph.py`).

The generators make the same numpy RNG calls in the same order as the
reference, so one seed gives a bitwise-identical graph in both packages.
`powerlaw_graph` is not copied: its Python loop is O(V*E) and cannot build
the 2**20-vertex gcn-paper graph; the full-width run uses `er_graph`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Graph:
    indptr: np.ndarray  # [V+1] int64
    indices: np.ndarray  # [E] int32 (in-neighbors of each vertex)
    num_vertices: int
    features: Optional[np.ndarray] = None  # [V, D] float32
    labels: Optional[np.ndarray] = None  # [V] int32
    train_mask: Optional[np.ndarray] = None
    val_mask: Optional[np.ndarray] = None
    test_mask: Optional[np.ndarray] = None

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def degree(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def out_degree(self) -> np.ndarray:
        """`indices` are in-neighbors: a vertex's out-degree counts how often
        it appears as someone's in-neighbor."""
        return np.bincount(self.indices, minlength=self.num_vertices).astype(np.int64)


def from_edges(src: np.ndarray, dst: np.ndarray, num_vertices: int, **kw) -> Graph:
    """Build CSR of in-neighbors: edge (u -> v) stores u in v's list."""
    order = np.argsort(dst, kind="stable")
    src, dst = np.asarray(src)[order], np.asarray(dst)[order]
    indptr = np.zeros(num_vertices + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(dst, minlength=num_vertices))
    return Graph(indptr=indptr, indices=src.astype(np.int32),
                 num_vertices=num_vertices, **kw)


def _attach(g: Graph, feature_dim: int, num_classes: int, train_frac: float,
            rng: np.random.Generator) -> Graph:
    V = g.num_vertices
    # features correlated with labels so GNNs can actually learn
    labels = rng.integers(0, num_classes, V).astype(np.int32)
    centers = rng.standard_normal((num_classes, feature_dim)).astype(np.float32)
    g.features = (centers[labels] + 0.5 * rng.standard_normal((V, feature_dim))).astype(np.float32)
    g.labels = labels
    masks = rng.random(V)
    g.train_mask = masks < train_frac
    g.val_mask = (masks >= train_frac) & (masks < train_frac + 0.1)
    g.test_mask = masks >= train_frac + 0.1
    return g


def sbm_graph(num_vertices: int, num_blocks: int = 4, p_in: float = 0.05,
              p_out: float = 0.002, feature_dim: int = 32, num_classes: int = 0,
              train_frac: float = 0.3, seed: int = 0) -> Graph:
    """Stochastic block model — ground-truth communities for partition tests."""
    rng = np.random.default_rng(seed)
    block = rng.integers(0, num_blocks, num_vertices)
    src, dst = [], []
    for bi in range(num_blocks):
        vi = np.where(block == bi)[0]
        for bj in range(num_blocks):
            vj = np.where(block == bj)[0]
            p = p_in if bi == bj else p_out
            n_try = rng.binomial(len(vi) * len(vj), p)
            if n_try == 0:
                continue
            s = rng.choice(vi, n_try)
            d = rng.choice(vj, n_try)
            keep = s != d
            src.append(s[keep])
            dst.append(d[keep])
    src = np.concatenate(src) if src else np.zeros(0, np.int64)
    dst = np.concatenate(dst) if dst else np.zeros(0, np.int64)
    g = from_edges(src, dst, num_vertices)
    g = _attach(g, feature_dim, num_classes or num_blocks, train_frac, rng)
    g.labels = block.astype(np.int32)  # labels = communities
    return g


def er_graph(num_vertices: int, avg_degree: int = 8, feature_dim: int = 16,
             num_classes: int = 4, train_frac: float = 0.3, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    E = num_vertices * avg_degree
    src = rng.integers(0, num_vertices, E)
    dst = rng.integers(0, num_vertices, E)
    keep = src != dst
    g = from_edges(src[keep], dst[keep], num_vertices)
    return _attach(g, feature_dim, num_classes, train_frac, rng)
