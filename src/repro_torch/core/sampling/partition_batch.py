"""Partition-based mini-batch generation (the port's copy of the part of
`repro/core/sampling/partition_batch.py` the sampled mini-batch engine
and the single-device trainers read, survey §5.2): the targets a rank
draws from its own partition block, the static p2p frontier halo cap, the
local partition as the batch (PSGD-PA), subgraph expansion to restore
boundary context, and LLCG's schedule (Learn Locally, Correct Globally).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.core.partition.edge_cut import Partition
from repro_torch.core.partition.vertex_cut import edge_endpoints
from repro_torch.core.sampling.samplers import MiniBatch


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


def partition_minibatch(g: Graph, part: Partition, worker: int,
                        num_layers: int = 2) -> MiniBatch:
    """PSGD-PA: ignore cross edges; train on the induced local subgraph."""
    verts = np.where(part.assignment == worker)[0]
    sub, _ = g.subgraph(verts)
    A = sub.to_dense_adj(normalized=True)
    return MiniBatch(
        targets=verts,
        layer_vertices=[verts] * (num_layers + 1),
        layer_adj=[A] * num_layers,
        input_features=g.features[verts] if g.features is not None else None,
        labels=g.labels[verts] if g.labels is not None else None,
    )


def expanded_partition_minibatch(g: Graph, part: Partition, worker: int,
                                 hops: int = 1, num_layers: int = 2) -> MiniBatch:
    """Subgraph expansion (Xue/Angerd): add `hops` rings of remote in-neighbors
    so boundary vertices keep their local structure; the loss is on the
    owned targets only."""
    owned = np.where(part.assignment == worker)[0]
    e_src, e_dst = edge_endpoints(g)
    reached = part.assignment == worker
    frontier = reached.copy()
    for _ in range(hops):
        nxt = np.zeros(g.num_vertices, bool)
        nxt[e_src[frontier[e_dst]]] = True
        frontier = nxt & ~reached
        reached |= frontier
    all_verts = np.where(reached)[0].astype(np.int64)
    sub, _ = g.subgraph(all_verts)
    A = sub.to_dense_adj(normalized=True)
    return MiniBatch(
        targets=owned,  # loss restricted to owned vertices
        layer_vertices=[all_verts] * (num_layers + 1),
        layer_adj=[A] * num_layers,
        input_features=g.features[all_verts] if g.features is not None else None,
        labels=g.labels[owned] if g.labels is not None else None,
    )


@dataclasses.dataclass
class LLCGSchedule:
    """Learn Locally, Correct Globally (Ramezani et al.): each round, workers
    take `local_steps` on their partition; a server then applies one global
    full-graph correction step."""
    local_steps: int = 5
    rounds: int = 10

    def plan(self) -> List[Tuple[str, int]]:
        out = []
        for r in range(self.rounds):
            out.extend([("local", r)] * self.local_steps)
            out.append(("global_correct", r))
        return out
