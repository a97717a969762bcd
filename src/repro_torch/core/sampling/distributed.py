"""Distributed sampling and communication accounting (the port's copy of
`repro/core/sampling/distributed.py`): `CommStats`, pull-based vs CSP
push-based sampling with their byte counts, skewed weighted sampling, and
`feature_fetch_bytes` and `embedding_update_bytes`, the cost models the
mini-batch engine's CommStats equal exactly.  Host numpy, as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.core.partition.edge_cut import Partition

ID_BYTES = 8
FEAT_BYTES = 4


@dataclasses.dataclass
class CommStats:
    pull_bytes: int = 0  # neighbor lists / features moved to the requester
    push_bytes: int = 0  # sampling requests + results (CSP)
    cache_hit_bytes: int = 0  # feature bytes served by a local cache instead
    replica_sync_bytes: int = 0  # vertex-cut partial/aggregate rows exchanged
    halo_bytes: int = 0  # edge-cut/hybrid full-graph halo exchange
    embed_grad_bytes: int = 0  # trainable embeddings: layer-0 gradient rows
    inference_bytes: int = 0  # layer-wise full-graph inference sweeps: one
    #   forward-only exchange per layer (cost_models.inference_bytes_per_sweep)

    def reset(self) -> "CommStats":
        """Zero every field IN PLACE, so a reference a caller holds keeps
        observing traffic."""
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)
        return self

    def total(self) -> int:
        """Bytes that actually cross the wire (cache hits excluded)."""
        return (self.pull_bytes + self.push_bytes + self.replica_sync_bytes
                + self.halo_bytes + self.embed_grad_bytes
                + self.inference_bytes)

    def requested(self) -> int:
        """Bytes the computation asked for, whether cached or fetched."""
        return self.total() + self.cache_hit_bytes


def pull_based_sample(g: Graph, part: Partition, worker: int, targets: np.ndarray,
                      fanout: int, rng: np.random.Generator
                      ) -> Tuple[List[np.ndarray], CommStats]:
    """Baseline: the local worker pulls FULL remote neighbor lists, then
    samples locally (what a naive DistDGL sampler does)."""
    stats = CommStats()
    out = []
    for v in targets:
        nb = g.neighbors(v)
        if part.assignment[v] != worker:
            stats.pull_bytes += len(nb) * ID_BYTES  # whole list crosses the wire
        sel = nb if len(nb) <= fanout else rng.choice(nb, fanout, replace=False)
        out.append(np.asarray(sel))
    return out, stats


def csp_sample(g: Graph, part: Partition, worker: int, targets: np.ndarray,
               fanout: int, rng: np.random.Generator
               ) -> Tuple[List[np.ndarray], CommStats]:
    """Collective Sampling Primitive (DSP): push the sampling task to the
    owner; only the sampled ids return."""
    stats = CommStats()
    out = []
    for v in targets:
        nb = g.neighbors(v)
        sel = nb if len(nb) <= fanout else rng.choice(nb, fanout, replace=False)
        if part.assignment[v] != worker:
            stats.push_bytes += ID_BYTES  # the request (vertex id)
            stats.push_bytes += len(sel) * ID_BYTES  # only results return
        out.append(np.asarray(sel))
    return out, stats


def skewed_weighted_sample(g: Graph, part: Partition, worker: int,
                           targets: np.ndarray, fanout: int, s: float,
                           rng: np.random.Generator
                           ) -> Tuple[List[np.ndarray], CommStats, float]:
    """Jiang & Rumi: scale LOCAL neighbors' sampling weight by s>1. Returns
    (samples, comm stats, locality = fraction of local picks)."""
    stats = CommStats()
    out = []
    local_picks = total_picks = 0
    for v in targets:
        nb = g.neighbors(v)
        if len(nb) == 0:
            out.append(nb)
            continue
        local = part.assignment[nb] == worker
        w = np.where(local, s, 1.0)
        p = w / w.sum()
        k = min(fanout, len(nb))
        sel = rng.choice(nb, size=k, replace=False, p=p)
        remote_sel = sel[part.assignment[sel] != worker]
        stats.pull_bytes += len(remote_sel) * ID_BYTES
        local_picks += int((part.assignment[sel] == worker).sum())
        total_picks += k
        out.append(sel)
    return out, stats, local_picks / max(total_picks, 1)


def feature_fetch_bytes(part: Partition, worker: int, vertices: np.ndarray,
                        feature_dim: int, cached_ids=frozenset(),
                        stats: CommStats = None) -> int:
    """Bytes to fetch input features for a batch.  Remote vertices present in
    `cached_ids` are cache hits: they cost nothing on the wire but are tracked
    in `stats.cache_hit_bytes` when a CommStats accumulator is passed (so an
    engine's reported bytes and this standalone cost model agree exactly).
    Returns the miss (wire) bytes; local vertices are free."""
    cached = (cached_ids if isinstance(cached_ids, (set, frozenset))
              else set(int(v) for v in np.asarray(cached_ids).ravel()))
    miss = hit = 0
    for v in np.asarray(vertices).ravel():
        if part.assignment[v] != worker:
            if int(v) in cached:
                hit += feature_dim * FEAT_BYTES
            else:
                miss += feature_dim * FEAT_BYTES
    if stats is not None:
        stats.pull_bytes += miss
        stats.cache_hit_bytes += hit
    return miss


def embedding_update_bytes(part: Partition, worker: int, vertices: np.ndarray,
                           feature_dim: int, cached_ids=frozenset(),
                           overlay_rows: int = 0,
                           stats: CommStats = None) -> int:
    """Wire bytes one rank adds per mini-batch step when layer-0 rows are
    TRAINABLE embeddings: the cotangent of every remote frontier MISS goes
    back to its owner (the reverse of the feature fetch: same rows, same
    width), and the hot-row overlay costs 2 * overlay_rows rows a step (the
    live refresh down from the owners and the hits' gradients back), since
    a frozen snapshot can no longer serve the cached rows.

    Like `feature_fetch_bytes` this counts requested rows (the p2p volume)
    whichever collective ships them, the convention the engine's CommStats
    follow.  Returns the bytes; adds them to ``stats.embed_grad_bytes`` when
    given."""
    cached = (cached_ids if isinstance(cached_ids, (set, frozenset))
              else set(int(v) for v in np.asarray(cached_ids).ravel()))
    rows = 0
    for v in np.asarray(vertices).ravel():
        if part.assignment[v] != worker and int(v) not in cached:
            rows += 1
    b = (rows + 2 * int(overlay_rows)) * feature_dim * FEAT_BYTES
    if stats is not None:
        stats.embed_grad_bytes += b
    return b
