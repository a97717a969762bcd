"""Feature-cache policies (survey §5.1) and a hit-ratio simulator (the
port's copy of `repro/core/sampling/cache.py`, host numpy).

Policies:
  StaticDegreeCache   — PaGraph: cache highest out-degree vertices.
  ImportanceCache     — AliGraph: cache vertices with Imp^l(v) = D_in/D_out
                        above a threshold (capped at capacity).
  PreSamplingCache    — GNNLab: run K sampling epochs, cache hottest.
  AnalysisCache       — SALIENT++: propagate sampled-probability through the
                        graph analytically, cache highest-probability.
  FIFOCache           — BGL: dynamic FIFO with proximity-aware ordering.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Iterable, List, Sequence

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.core.sampling.samplers import node_wise_sample


def simulate_hit_ratio(cached_ids: np.ndarray, access_stream: Iterable[np.ndarray]) -> float:
    cached = set(np.asarray(cached_ids).tolist())
    hits = total = 0
    for batch in access_stream:
        for v in np.asarray(batch).ravel():
            hits += int(v) in cached
            total += 1
    return hits / max(total, 1)


def static_degree_cache(g: Graph, capacity: int) -> np.ndarray:
    """PaGraph: high OUT-degree vertices are accessed most by samplers."""
    return np.argsort(-g.out_degree())[:capacity]


def importance_cache(g: Graph, capacity: int, l: int = 1) -> np.ndarray:
    """AliGraph Imp^l(v) = D_in^l / D_out^l (1-hop approximation for l=1)."""
    d_in = g.degree().astype(np.float64)
    d_out = g.out_degree().astype(np.float64)
    imp = d_in / np.maximum(d_out, 1.0)
    # among high-importance, prefer frequently accessed (high out-degree):
    order = np.lexsort((-d_out, -imp))
    return order[:capacity]


def presampling_cache(g: Graph, capacity: int, *, fanouts=(5, 5), batch_size=32,
                      epochs: int = 3, seed: int = 0) -> np.ndarray:
    """GNNLab: K pre-sampling epochs measure empirical hotness."""
    rng = np.random.default_rng(seed)
    train = np.where(g.train_mask)[0] if g.train_mask is not None else np.arange(g.num_vertices)
    counts = np.zeros(g.num_vertices, np.int64)
    for _ in range(epochs):
        perm = rng.permutation(train)
        for i in range(0, len(perm), batch_size):
            mb = node_wise_sample(g, perm[i : i + batch_size], fanouts, rng)
            np.add.at(counts, mb.layer_vertices[0], 1)
    return np.argsort(-counts)[:capacity]


def analysis_propagation(g: Graph, *, fanouts=(5, 5)) -> tuple:
    """SALIENT++ propagation model: p_0 = uniform over train set; each hop
    ships p[v] * min(fanout/deg, 1) of v's mass SPLIT EVENLY across its
    in-neighbors (a sampler visits each neighbor with probability ~fanout/deg,
    and the per-vertex mass is a probability, so it divides — it doesn't
    replicate).  Duplicate neighbor entries (parallel edges) accumulate via
    np.add.at; fancy-index `+=` would silently keep only one of them.

    Returns ``(total, per_hop)`` — total [V] is the cache-ranking score,
    per_hop[h] the mass vector after hop h.  Because scale <= 1 and the split
    sums to one, each hop's mass is conserved: per_hop[h].sum() <= the
    previous hop's mass (the regression tier asserts this)."""
    V = g.num_vertices
    train = np.where(g.train_mask)[0] if g.train_mask is not None else np.arange(V)
    p = np.zeros(V)
    p[train] = 1.0 / max(len(train), 1)
    total = p.copy()
    deg = g.degree().astype(np.float64)
    per_hop: List[np.ndarray] = []
    for fanout in fanouts:
        nxt = np.zeros(V)
        scale = np.minimum(fanout / np.maximum(deg, 1.0), 1.0)
        for v in range(V):
            if p[v] > 0 and deg[v] > 0:
                nb = g.neighbors(v)
                np.add.at(nxt, nb, p[v] * scale[v] / len(nb))
        total += nxt
        per_hop.append(nxt)
        p = nxt
    return total, per_hop


def analysis_cache(g: Graph, capacity: int, *, fanouts=(5, 5)) -> np.ndarray:
    """SALIENT++: cache the highest analytically-propagated access probability."""
    total, _ = analysis_propagation(g, fanouts=fanouts)
    return np.argsort(-total)[:capacity]


# Static (build-once) policies usable as a device-resident feature cache:
# input features never change during training, so a static cache is exact —
# hits are free reads, never stale.
CACHE_POLICIES = {
    "static_degree": static_degree_cache,
    "importance": importance_cache,
    "presampling": presampling_cache,
    "analysis": analysis_cache,
}


def device_cache_ids(g: Graph, assignment: np.ndarray, worker: int,
                     policy: str, capacity: int, **policy_kw) -> np.ndarray:
    """Per-device resident feature cache: the policy's global hotness ranking
    filtered to vertices REMOTE to `worker` (local features are already
    resident), truncated to `capacity`."""
    if policy in ("none", None) or capacity <= 0:
        return np.zeros(0, np.int64)
    ranked = CACHE_POLICIES[policy](g, g.num_vertices, **policy_kw)
    remote = ranked[np.asarray(assignment)[ranked] != worker]
    return remote[:capacity].astype(np.int64)


@dataclasses.dataclass
class FIFOCache:
    """BGL dynamic FIFO cache; feed access batches in (proximity-aware) order."""
    capacity: int

    def __post_init__(self):
        self._set = OrderedDict()

    def access(self, v: int) -> bool:
        hit = v in self._set
        if not hit and self.capacity > 0:
            # capacity <= 0: nothing can be resident (the old popitem on an
            # empty OrderedDict raised KeyError); everything misses
            if len(self._set) >= self.capacity:
                self._set.popitem(last=False)
            self._set[v] = True
        return hit

    def run(self, stream: Iterable[np.ndarray]) -> float:
        hits = total = 0
        for batch in stream:
            for v in np.asarray(batch).ravel():
                hits += self.access(int(v))
                total += 1
        return hits / max(total, 1)


def proximity_ordering(g: Graph, train: np.ndarray, *, seed: int = 0,
                       shift: bool = True) -> np.ndarray:
    """BGL: BFS-ordered training sequence (+ random shift for convergence)."""
    rng = np.random.default_rng(seed)
    train_set = set(train.tolist())
    order: List[int] = []
    seen = set()
    q = deque()
    # Restart source: a pre-shuffled pass over the train vertices with a
    # monotone cursor.  Each restart advances past already-seen vertices, so
    # the total restart work is O(|train|) across the whole traversal — the
    # old `[t for t in train_set if t not in set(order)]` rebuilt the emitted
    # set every restart, turning many-component graphs quadratic.  (When the
    # queue drains, every seen train vertex has been popped into `order`, so
    # "unseen" == "not yet emitted".)
    restart = rng.permutation(np.asarray(train, np.int64))
    cursor = 0
    start = int(rng.choice(train))
    q.append(start)
    seen.add(start)
    while q:
        v = q.popleft()
        if v in train_set:
            order.append(v)
        for u in g.neighbors(v):
            if int(u) not in seen:
                seen.add(int(u))
                q.append(int(u))
        if not q:
            while cursor < len(restart) and int(restart[cursor]) in seen:
                cursor += 1
            if cursor < len(restart):
                nxt = int(restart[cursor])
                q.append(nxt)
                seen.add(nxt)
    arr = np.asarray(order, np.int64)
    if shift and len(arr):
        k = int(rng.integers(0, len(arr)))
        arr = np.roll(arr, k)
    return arr
