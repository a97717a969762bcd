"""Mini-batch samplers (the port's copy of `repro/core/sampling/samplers.py`):
node-wise (GraphSAGE), layer-wise (FastGCN-style importance) and subgraph
(GraphSAINT random walk), host numpy loops as in the reference, so one
`np.random.Generator` state gives the same arrays in both packages.

A MiniBatch carries the layered computation graph as dense block matrices
(rows = targets of layer l, cols = sources of layer l-1): the
"computation graph generation" stage of the survey's pipeline.  The
padding helpers (`frontier_caps`, `pad_minibatch`) give every batch of one
sampler configuration the same shapes, which the engine's step and its
batch arrays rely on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.graph import Graph


@dataclasses.dataclass
class MiniBatch:
    targets: np.ndarray  # [B] final-layer vertex ids (global)
    layer_vertices: List[np.ndarray]  # L+1 frontiers, [0]=input layer
    layer_adj: List[np.ndarray]  # L dense normalized blocks [n_l, n_{l-1}]
    input_features: Optional[np.ndarray] = None
    labels: Optional[np.ndarray] = None

    @property
    def num_input_vertices(self) -> int:
        return len(self.layer_vertices[0])

    def accessed_vertices(self) -> np.ndarray:
        return np.unique(np.concatenate(self.layer_vertices))

    def self_indices(self) -> List[np.ndarray]:
        """out[l][i] = position of layer_vertices[l+1][i] within
        layer_vertices[l] (valid because every sampler keeps its frontiers
        nested: each layer's vertex set contains the next layer's)."""
        out = []
        for l in range(len(self.layer_vertices) - 1):
            cols = self.layer_vertices[l]
            pos = {int(v): j for j, v in enumerate(cols)}
            out.append(np.asarray(
                [pos[int(v)] for v in self.layer_vertices[l + 1]], np.int64))
        return out

    def relabel(self) -> "MiniBatch":
        """Rewrite every frontier (and targets) as positions within the input
        frontier `layer_vertices[0]` — the batch-local id space a device
        computes in.  Round-trips: `lv0[relabeled.layer_vertices[l]] ==
        self.layer_vertices[l]` for every layer."""
        lv0 = self.layer_vertices[0]
        pos = {int(v): j for j, v in enumerate(lv0)}
        local = [np.asarray([pos[int(v)] for v in lv], np.int64)
                 for lv in self.layer_vertices]
        return MiniBatch(
            targets=np.asarray([pos[int(v)] for v in self.targets], np.int64),
            layer_vertices=local,
            layer_adj=self.layer_adj,
            input_features=self.input_features,
            labels=self.labels,
        )


def _block_adj(g: Graph, rows: np.ndarray, cols: np.ndarray,
               sampled_nbrs: List[np.ndarray]) -> np.ndarray:
    col_pos = {int(c): j for j, c in enumerate(cols)}
    A = np.zeros((len(rows), len(cols)), np.float32)
    for i, nbrs in enumerate(sampled_nbrs):
        for u in nbrs:
            A[i, col_pos[int(u)]] = 1.0
        # self loop
        A[i, col_pos[int(rows[i])]] += 1.0
    norm = A.sum(1, keepdims=True)
    return A / np.maximum(norm, 1.0)


def node_wise_sample(g: Graph, targets: np.ndarray, fanouts: Sequence[int],
                     rng: np.random.Generator) -> MiniBatch:
    """GraphSAGE: sample `fanout` neighbors per vertex per layer."""
    layer_vertices = [np.asarray(targets, np.int64)]
    per_layer_nbrs: List[List[np.ndarray]] = []
    frontier = layer_vertices[0]
    for fanout in fanouts:  # from top layer down
        sampled = []
        nxt = set(frontier.tolist())
        for v in frontier:
            nb = g.neighbors(v)
            if len(nb) > fanout:
                nb = rng.choice(nb, size=fanout, replace=False)
            sampled.append(np.asarray(nb))
            nxt.update(np.asarray(nb).tolist())
        per_layer_nbrs.append(sampled)
        frontier = np.asarray(sorted(nxt), np.int64)
        layer_vertices.append(frontier)
    # build blocks: layer l rows = layer_vertices[l], cols = layer_vertices[l+1]
    layer_adj = []
    for l, fanout in enumerate(fanouts):
        layer_adj.append(_block_adj(g, layer_vertices[l], layer_vertices[l + 1],
                                    per_layer_nbrs[l]))
    # reorder: MiniBatch stores [input ... output]
    layer_vertices = layer_vertices[::-1]
    layer_adj = layer_adj[::-1]
    return MiniBatch(
        targets=np.asarray(targets, np.int64),
        layer_vertices=layer_vertices,
        layer_adj=layer_adj,
        input_features=None if g.features is None else g.features[layer_vertices[0]],
        labels=None if g.labels is None else g.labels[targets],
    )


def layer_wise_sample(g: Graph, targets: np.ndarray, layer_sizes: Sequence[int],
                      rng: np.random.Generator) -> MiniBatch:
    """FastGCN-style: per layer, sample a fixed vertex set with probability
    proportional to degree; connect to the previous frontier."""
    deg = g.degree().astype(np.float64)
    p = deg / max(deg.sum(), 1)
    layer_vertices = [np.asarray(targets, np.int64)]
    per_layer_nbrs = []
    frontier = layer_vertices[0]
    for size in layer_sizes:
        pool = rng.choice(g.num_vertices, size=min(size, g.num_vertices),
                          replace=False, p=p)
        pool_set = set(pool.tolist())
        sampled = []
        used = set()
        for v in frontier:
            nb = np.asarray([u for u in g.neighbors(v) if int(u) in pool_set])
            sampled.append(nb)
            used.update(nb.tolist())
        used.update(frontier.tolist())
        nxt = np.asarray(sorted(used), np.int64)
        per_layer_nbrs.append(sampled)
        layer_vertices.append(nxt)
        frontier = nxt
    layer_adj = []
    for l in range(len(layer_sizes)):
        layer_adj.append(_block_adj(g, layer_vertices[l], layer_vertices[l + 1],
                                    per_layer_nbrs[l]))
    layer_vertices = layer_vertices[::-1]
    layer_adj = layer_adj[::-1]
    return MiniBatch(
        targets=np.asarray(targets, np.int64),
        layer_vertices=layer_vertices,
        layer_adj=layer_adj,
        input_features=None if g.features is None else g.features[layer_vertices[0]],
        labels=None if g.labels is None else g.labels[targets],
    )


def subgraph_sample(g: Graph, roots: np.ndarray, walk_length: int,
                    rng: np.random.Generator, num_layers: int = 2) -> MiniBatch:
    """GraphSAINT random-walk subgraph: induced subgraph over walk vertices;
    all layers share the same (sub)adjacency."""
    visited = set(np.asarray(roots).tolist())
    cur = np.asarray(roots)
    for _ in range(walk_length):
        nxt = []
        for v in cur:
            nb = g.neighbors(v)
            if len(nb):
                nxt.append(int(rng.choice(nb)))
        visited.update(nxt)
        cur = np.asarray(nxt) if nxt else cur
    verts = np.asarray(sorted(visited), np.int64)
    sub, remap = g.subgraph(verts)
    A = sub.to_dense_adj(normalized=True)
    layer_vertices = [verts] * (num_layers + 1)
    return MiniBatch(
        targets=verts,
        layer_vertices=layer_vertices,
        layer_adj=[A] * num_layers,
        input_features=None if g.features is None else g.features[verts],
        labels=None if g.labels is None else g.labels[verts],
    )


# ---------------------------------------------------------------------------
# static padding: every sampled batch of a given fanout config pads to the
# same shapes
# ---------------------------------------------------------------------------


def frontier_caps(batching: str, num_layers: int, batch_size: int, *,
                  fanouts: Sequence[int] = (), layer_sizes: Sequence[int] = (),
                  walk_length: int = 0, num_vertices: int = 0) -> List[int]:
    """Worst-case frontier sizes caps[l] for layer_vertices[l] (0 = input
    layer, num_layers = targets), clipped to the vertex count: node-wise
    frontiers grow by at most x(fanout+1) per hop, layer-wise by +layer_size,
    subgraph walks visit at most roots*(walk_length+1) vertices."""
    L = num_layers
    if batching == "node_wise":
        if len(fanouts) != L:
            raise ValueError(f"need {L} fanouts, got {fanouts}")
        caps = [batch_size]
        for f in fanouts:  # applied from the target layer down
            caps.append(caps[-1] * (int(f) + 1))
        caps = caps[::-1]  # index 0 = input layer
    elif batching == "layer_wise":
        if len(layer_sizes) != L:
            raise ValueError(f"need {L} layer sizes, got {layer_sizes}")
        caps = [batch_size]
        for s in layer_sizes:
            caps.append(caps[-1] + int(s))
        caps = caps[::-1]
    elif batching == "subgraph":
        caps = [batch_size * (int(walk_length) + 1)] * (L + 1)
    else:
        raise ValueError(f"unknown batching mode {batching!r}")
    if num_vertices:
        caps = [min(c, num_vertices) for c in caps]
    return caps


def pad_minibatch(mb: MiniBatch, caps: Sequence[int]) -> Dict[str, np.ndarray]:
    """Pad a sampled MiniBatch to the static `caps` shapes.  Pad frontier /
    target slots carry vertex id -1 and mask 0; pad adjacency rows/cols are
    zero, so padded positions stay inert through a forward pass.

    Returns dict(frontier [caps[0]], fmask, tgt [caps[-1]], tmask,
    adj = tuple of [caps[l+1], caps[l]] blocks, self_idx = tuple of
    [caps[l+1]] positions of each layer-(l+1) row within layer l — the
    resident self-feature table for sage/gin/gat; pad rows point at slot 0
    (inert: no real row reads a pad row))."""
    L = len(mb.layer_adj)
    if len(caps) != L + 1:
        raise ValueError(f"need {L + 1} caps, got {len(caps)}")
    for l, lv in enumerate(mb.layer_vertices):
        if len(lv) > caps[l]:
            raise ValueError(
                f"layer {l} frontier {len(lv)} exceeds cap {caps[l]}")
    self_idx = []
    for l, si in enumerate(mb.self_indices()):
        a = np.zeros(caps[l + 1], np.int64)
        a[: len(si)] = si
        self_idx.append(a)
    frontier = np.full(caps[0], -1, np.int64)
    frontier[: mb.num_input_vertices] = mb.layer_vertices[0]
    fmask = np.zeros(caps[0], np.float32)
    fmask[: mb.num_input_vertices] = 1.0
    tgt = np.full(caps[-1], -1, np.int64)
    tgt[: len(mb.targets)] = mb.targets
    tmask = np.zeros(caps[-1], np.float32)
    tmask[: len(mb.targets)] = 1.0
    adj = []
    for l, A in enumerate(mb.layer_adj):
        P = np.zeros((caps[l + 1], caps[l]), np.float32)
        P[: A.shape[0], : A.shape[1]] = A
        adj.append(P)
    return dict(frontier=frontier, fmask=fmask, tgt=tgt, tmask=tmask,
                adj=tuple(adj), self_idx=tuple(self_idx))
