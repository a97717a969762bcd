"""Edge-cut graph partitioners (the port's copy of the part of
`repro/core/partition/edge_cut.py` the one-card slice runs).

With one rank every partitioner assigns every vertex to part 0; `hash` and
`range` are copied so that a layout for k > 1 can be built and compared with
the reference.  The streaming and multilevel partitioners wait for the
multi-rank slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np

from repro_torch.core.graph import Graph


@dataclasses.dataclass
class Partition:
    assignment: np.ndarray  # [V] int32 partition id
    num_parts: int


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


PARTITIONERS: Dict[str, Callable] = {
    "hash": hash_partition,
    "range": lambda g, k, **kw: range_partition(g, k),
}
