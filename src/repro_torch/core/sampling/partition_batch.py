"""Partition-based mini-batch generation (the port's copy of the part of
`repro/core/sampling/partition_batch.py` the sampled mini-batch engine
reads): the targets a rank draws from its own partition block, and the
static p2p frontier halo cap.  The PSGD-PA and LLCG helpers arrive with the
single-device trainers.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.core.partition.edge_cut import Partition
from repro_torch.core.partition.vertex_cut import edge_endpoints


def partition_targets(g: Graph, part: Partition, worker: int, batch_size: int,
                      rng: np.random.Generator, train_only: bool = True
                      ) -> np.ndarray:
    """Draw up to `batch_size` mini-batch target (or walk-root) vertices from
    `worker`'s owned partition block — the same ownership rule as
    `partition_minibatch`, but subsampled so samplers can expand them into
    layered computation graphs.  Falls back to all owned vertices when the
    block has no train vertices; returns fewer than `batch_size` ids when the
    pool is smaller (callers pad to static shapes)."""
    owned = np.where(part.assignment == worker)[0]
    pool = owned
    if train_only and g.train_mask is not None:
        train = owned[g.train_mask[owned]]
        if len(train):
            pool = train
    if len(pool) <= batch_size:
        return np.sort(pool).astype(np.int64)
    return np.sort(rng.choice(pool, size=batch_size, replace=False)).astype(np.int64)


def p2p_frontier_halo_cap(g: Graph, part: Partition, hops: int,
                          cap0: int) -> int:
    """Tight static cap on the p2p mini-batch halo: the most rows any single
    source partition can ever ship to one destination's sampled frontier.

    Every sampler expands targets drawn from the destination's OWNED block by
    at most `hops` in-neighbor hops (node/layer-wise: num_layers; subgraph:
    walk_length), so the frontier rows remote-from-one-owner are bounded by
    that owner's share of the destination's `hops`-hop in-neighborhood — the
    measured edge-cut halo — never by the worst case `cap0` (every frontier
    row remote from one owner).  Always a TRUE upper bound: shrinking the
    all_to_all buffer by it can never overflow a sampled batch."""
    V = g.num_vertices
    e_src, e_dst = edge_endpoints(g)
    assign = part.assignment
    best = 1
    for d in range(part.num_parts):
        cur = assign == d
        reached = cur.copy()
        for _ in range(hops):
            nxt = np.zeros(V, bool)
            nxt[e_src[cur[e_dst]]] = True
            cur = nxt & ~reached
            reached |= nxt
            if not cur.any():
                break
        remote = reached & (assign != d)
        if remote.any():
            counts = np.bincount(assign[remote], minlength=part.num_parts)
            best = max(best, int(counts.max()))
    return max(1, min(int(cap0), best))
