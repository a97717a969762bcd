"""Feature partitioning (the port's copy of
`repro/core/partition/feature_partition.py`, survey §4.3): row-wise (with
the graph), column-wise (P3 / GIST), replicated and 2D, plus replication of
boundary features (DistDGL's one-hop replication cache).  Host numpy, array
for array the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.core.partition.edge_cut import Partition


@dataclasses.dataclass
class FeatureShards:
    kind: str  # row | column | replicated | twod
    shards: List[np.ndarray]
    index_maps: Optional[List[np.ndarray]] = None  # row ids per shard (row kind)

    def total_bytes(self) -> int:
        return sum(s.nbytes for s in self.shards)


def row_partition(g: Graph, part: Partition) -> FeatureShards:
    """Each vertex's feature lives with its vertex (the default everywhere)."""
    shards, idx = [], []
    for i in range(part.num_parts):
        rows = np.where(part.assignment == i)[0]
        shards.append(g.features[rows])
        idx.append(rows)
    return FeatureShards("row", shards, idx)


def row_partition_with_halo(g: Graph, part: Partition) -> FeatureShards:
    """DistDGL: replicate one-hop boundary features so samplers stay local."""
    shards, idx = [], []
    for i in range(part.num_parts):
        rows = np.where(part.assignment == i)[0]
        halo = part.boundary_vertices(g, i)
        all_rows = np.concatenate([rows, halo]) if len(halo) else rows
        shards.append(g.features[all_rows])
        idx.append(all_rows)
    return FeatureShards("row", shards, idx)


def column_partition(g: Graph, k: int) -> FeatureShards:
    """P3: every partition holds a feature-column slice of ALL vertices;
    the first layer's aggregation runs model-parallel on the slice."""
    cols = np.array_split(np.arange(g.features.shape[1]), k)
    return FeatureShards("column", [g.features[:, c] for c in cols])


def replicated(g: Graph, k: int) -> FeatureShards:
    return FeatureShards("replicated", [g.features] * k)


def twod_partition(g: Graph, rows: int, cols: int) -> FeatureShards:
    rblocks = np.array_split(np.arange(g.num_vertices), rows)
    cblocks = np.array_split(np.arange(g.features.shape[1]), cols)
    shards = [g.features[np.ix_(r, c)] for r in rblocks for c in cblocks]
    return FeatureShards("twod", shards)
