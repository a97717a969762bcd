"""Communication cost models (the port's copy of the edge-cut, vertex-cut and
hybrid byte models of `repro/core/partition/cost_models.py`): the heuristic
affinity scores the streaming partitioners read (survey Eq. 3-5), and the
standalone byte models the engine's CommStats accounting is cross-checked
against (the trainable embeddings' `embedding_grad_bytes_per_step` too),
and the per-device byte models (`edge_cut_halo_device_bytes`,
`replica_sync_device_bytes`, `hybrid_device_bytes`) the layouts'
`device_bytes_per_step` and the autotuner read."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.graph import Graph

# ---------------------------------------------------------------------------
# Heuristic affinity scores for streaming partition
# ---------------------------------------------------------------------------


def pagraph_score(candidate_in_nbrs: np.ndarray, part_train_sets: Sequence[set],
                  part_sizes: np.ndarray, avg_train: float) -> np.ndarray:
    """Eq. 3 (Lin et al. / PaGraph):
    |V_train^i ∩ IN(v)| * (avg - |V_train^i|) / |P_i|."""
    K = len(part_train_sets)
    scores = np.zeros(K)
    nbrs = set(candidate_in_nbrs.tolist())
    for i in range(K):
        inter = len(part_train_sets[i] & nbrs)
        denom = max(part_sizes[i], 1)
        scores[i] = inter * (avg_train - len(part_train_sets[i])) / denom
    return scores


def bgl_score(block_in_nbrs: np.ndarray, part_vertex_sets: Sequence[set],
              part_sizes: np.ndarray, part_train_counts: np.ndarray,
              avg_part: float, avg_train: float) -> np.ndarray:
    """Eq. 4 (Liu et al. / BGL):
    |P_i ∩ IN(B)| * (1 - |P_i|/P_avg) * (1 - train_i/train_avg)."""
    K = len(part_vertex_sets)
    nbrs = set(block_in_nbrs.tolist())
    scores = np.zeros(K)
    for i in range(K):
        inter = len(part_vertex_sets[i] & nbrs)
        scores[i] = (inter * (1.0 - part_sizes[i] / max(avg_part, 1.0))
                     * (1.0 - part_train_counts[i] / max(avg_train, 1.0)))
    return scores


def bytegnn_score(cross_edges: np.ndarray, part_sizes: np.ndarray,
                  train_counts: np.ndarray, valid_counts: np.ndarray,
                  test_counts: np.ndarray, avgs: tuple, alpha=0.5, beta=0.3,
                  gamma=0.2) -> np.ndarray:
    """Eq. 5 (Zheng et al. / ByteGNN)."""
    t_avg, v_avg, s_avg = avgs
    frac = cross_edges / np.maximum(part_sizes, 1)
    penalty = (1.0 - alpha * train_counts / max(t_avg, 1.0)
               - beta * valid_counts / max(v_avg, 1.0)
               - gamma * test_counts / max(s_avg, 1.0))
    return frac * penalty


# ---------------------------------------------------------------------------
# Partition-family communication models, per training step and per sweep
# ---------------------------------------------------------------------------

FEAT_BYTES = 4


def model_exchange_widths(model: str, dims: Sequence[int],
                          family: str = "edge_cut") -> list:
    """Per-layer floats per exchanged row: gcn/sage/gin ship the layer's
    INPUT rows (width dims[l]); gat ships the transformed rows plus one
    attention-coefficient column (two under vertex_cut)."""
    L = len(dims) - 1
    if model == "gat":
        extra = 2 if family == "vertex_cut" else 1
        return [int(dims[l + 1]) + extra for l in range(L)]
    return [int(d) for d in dims[:-1]]


def replica_sync_bytes_per_step(rep_counts: np.ndarray, k: int, nv: int,
                                execution: str, dims: Sequence[int],
                                feat_bytes: int = FEAT_BYTES,
                                model: str = "gcn") -> int:
    """Replication-aware wire bytes of one vertex-cut train step.
    ``rep_counts`` [V] = replicas per vertex (incl. the forced master).
    broadcast / ring: every rank ships its whole nv-slot partial block to
    the other k-1 ranks per layer.  p2p (master-based GAS): each non-master
    replica sends one partial row and receives one aggregate row per layer,
    2 * sum_v (r(v) - 1) rows."""
    if execution in ("broadcast", "ring"):
        rows = k * (k - 1) * nv
    elif execution == "p2p":
        rows = 2 * int(np.maximum(np.asarray(rep_counts) - 1, 0).sum())
    else:
        raise ValueError(f"unknown execution {execution!r}")
    widths = model_exchange_widths(model, dims, "vertex_cut")
    return rows * int(sum(widths)) * feat_bytes


def edge_cut_halo_bytes_per_step(g: Graph, part, dims: Sequence[int],
                                 feat_bytes: int = FEAT_BYTES,
                                 model: str = "gcn") -> int:
    """Edge-cut p2p halo volume of one train step: every layer ships each
    partition's remote in-neighbor set (`Partition.boundary_vertices`) once,
    at that layer's model-dependent exchange width."""
    widths = model_exchange_widths(model, dims, "edge_cut")
    return part.communication_volume(g) * int(sum(widths)) * feat_bytes


def inference_bytes_per_sweep(execution: str, dims: Sequence[int], *,
                              model: str = "gcn", family: str = "edge_cut",
                              k: int = None, nb: int = None, g: Graph = None,
                              part=None, rep_counts: np.ndarray = None,
                              nv: int = None,
                              feat_bytes: int = FEAT_BYTES) -> int:
    """Wire bytes of ONE layer-wise full-graph inference sweep: every layer
    runs its exchange once at that layer's model-dependent width.  edge_cut
    broadcast/ring: every device gathers the other k-1 padded blocks per
    layer, k*(k-1)*nb rows.  edge_cut p2p: each layer ships each
    partition's remote in-neighbor (halo) set once,
    ``part.communication_volume(g)`` rows, the engine's bucketed all_to_all
    need sets.  vertex_cut: one replica-sync combine per layer, so the sweep
    volume is `replica_sync_bytes_per_step`."""
    if family == "vertex_cut":
        return replica_sync_bytes_per_step(rep_counts, k, nv, execution,
                                           dims, feat_bytes, model)
    widths = model_exchange_widths(model, dims, "edge_cut")
    if execution in ("broadcast", "ring"):
        rows = k * (k - 1) * int(nb)
    elif execution == "p2p":
        rows = part.communication_volume(g)
    else:
        raise ValueError(f"unknown execution {execution!r}")
    return rows * int(sum(widths)) * feat_bytes


def embedding_grad_bytes_per_step(g: Graph, execution: str,
                                  dims: Sequence[int], *, k: int,
                                  family: str = "edge_cut", part=None,
                                  nb: int = None, replica_rows: int = None,
                                  feat_bytes: int = FEAT_BYTES) -> int:
    """Wire bytes per FULL-GRAPH train step for routing the layer-0
    embedding gradients back to their owner shards (trainable features):
    the reverse of one exchange pass at width dims[0].

      edge_cut broadcast/ring  the all_gather's (or the rotations') reverse
                               carries the same table: k*(k-1)*nb rows.
      edge_cut p2p             each halo row's cotangent returns to its
                               owner once: `part.communication_volume(g)`
                               rows, the bucketed all_to_all's need sets.
      vertex_cut               two replica-sync passes at width dims[0]: the
                               replicas' partial gradients combine into the
                               vertex's, and the master's delta goes back to
                               the replicas -> 2 * replica_rows rows (the
                               plan's rows_per_layer).

    The engine's CommStats.embed_grad_bytes equal it."""
    D = int(dims[0])
    if family == "vertex_cut":
        return 2 * int(replica_rows) * D * feat_bytes
    if execution in ("broadcast", "ring"):
        rows = k * (k - 1) * int(nb)
    elif execution == "p2p":
        rows = part.communication_volume(g)
    else:
        raise ValueError(f"unknown execution {execution!r}")
    return rows * D * feat_bytes


def edge_cut_halo_device_bytes(g: Graph, part, dims: Sequence[int],
                               feat_bytes: int = FEAT_BYTES,
                               model: str = "gcn") -> np.ndarray:
    """[k] per-device halo bytes per step, counting BOTH directions (a row's
    owner sends it, its consumer receives it): the max of this array is the
    critical-path (straggler) comm volume that sets the step time.  On
    skewed graphs a hub's owner ships its row to up to k-1 consumers, the
    bottleneck a vertex cut's bounded replication removes."""
    from repro_torch.core.partition.vertex_cut import edge_endpoints

    src, dst = edge_endpoints(g)
    a = part.assignment.astype(np.int64)
    k = part.num_parts
    pairs = np.unique(src * k + a[dst])  # distinct (vertex, consumer) pairs
    pv, pc = pairs // k, pairs % k
    rem = a[pv] != pc
    send = np.bincount(a[pv][rem], minlength=k)
    recv = np.bincount(pc[rem], minlength=k)
    widths = model_exchange_widths(model, dims, "edge_cut")
    return (send + recv) * int(sum(widths)) * feat_bytes


def replica_sync_device_bytes(layout, masters: np.ndarray,
                              dims: Sequence[int],
                              feat_bytes: int = FEAT_BYTES,
                              model: str = "gcn") -> np.ndarray:
    """[k] per-device replica-sync bytes per step (p2p accounting), both
    directions as `edge_cut_halo_device_bytes`: a non-master replica slot
    sends one partial and receives one aggregate a layer; a master does the
    mirror image for every other replica of the vertices it masters.
    Bounded per device by the replication factor: no hub-owner
    straggler."""
    V = layout.slot_of.shape[1]
    nonmaster = ((layout.vert_ids < V)
                 & (layout.master_mask < 0.5)).sum(1).astype(np.int64)
    rm1 = np.maximum(layout.rep_count - 1, 0)
    master_traffic = np.bincount(np.asarray(masters, np.int64), weights=rm1,
                                 minlength=layout.k).astype(np.int64)
    widths = model_exchange_widths(model, dims, "vertex_cut")
    return (2 * (nonmaster + master_traffic)
            * int(sum(widths)) * feat_bytes)


# ---------------------------------------------------------------------------
# Hybrid (PowerLyra-style degree-threshold) family: low-degree vertices live
# edge-cut-local behind a halo exchange; hub vertices replicate with the
# vertex-cut replica-sync combine.  One step pays both wires, each over its
# own row population.
# ---------------------------------------------------------------------------


def hybrid_exchange_widths(model: str, dims: Sequence[int]) -> tuple:
    """(halo_widths, sync_widths): per-layer floats per row of the two wire
    populations.  Halo rows ship complete source rows: the layer input for
    gcn/sage/gin, the transformed Hw alone for gat (the SDDMM derives both
    logit halves locally).  Sync rows pay the vertex_cut widths (gat: +2
    for the attention and max columns)."""
    L = len(dims) - 1
    if model == "gat":
        return ([int(dims[l + 1]) for l in range(L)],
                [int(dims[l + 1]) + 2 for l in range(L)])
    w = [int(d) for d in dims[:-1]]
    return (list(w), list(w))


def hybrid_bytes_per_step(halo_rows: int, sync_rows: int,
                          dims: Sequence[int], model: str = "gcn",
                          feat_bytes: int = FEAT_BYTES) -> int:
    """Wire bytes of one hybrid-family train step: ``halo_rows`` rows cross
    per halo exchange pass and ``sync_rows`` rows per replica-sync combine,
    each once per layer at that wire's width.  Either may be 0: threshold
    inf is a pure edge cut (sync_rows 0), threshold 0 a pure src-replicating
    vertex cut (halo_rows 0)."""
    halo_w, sync_w = hybrid_exchange_widths(model, dims)
    return (int(halo_rows) * int(sum(halo_w))
            + int(sync_rows) * int(sum(sync_w))) * feat_bytes


def hybrid_device_bytes(layout, masters: np.ndarray, need,
                        execution: str, dims: Sequence[int], *,
                        model: str = "gcn",
                        feat_bytes: int = FEAT_BYTES,
                        halo_active: bool = True,
                        sync_active: bool = True) -> np.ndarray:
    """[k] per-device hybrid bytes per step, both directions (the halo term
    as `edge_cut_halo_device_bytes`, the sync term as
    `replica_sync_device_bytes`); the max is the critical-path volume.
    ``layout`` is the hybrid family's inner replica layout, ``need`` the
    [k][k] halo need lists (need[d][s] = home slots owner d fetches from
    master s).  Under p2p both terms are population-bounded; broadcast and
    the ring pay the full (k-1)*nv block per active wire."""
    k, nv = layout.k, layout.nv
    halo_w, sync_w = hybrid_exchange_widths(model, dims)
    hw, sw = int(sum(halo_w)), int(sum(sync_w))
    out = np.zeros(k, np.int64)
    if halo_active:
        if execution == "p2p":
            send = np.zeros(k, np.int64)
            recv = np.zeros(k, np.int64)
            for d in range(k):
                for s in range(k):
                    n = len(need[d][s])
                    recv[d] += n
                    send[s] += n
            out += (send + recv) * hw * feat_bytes
        else:
            out += 2 * (k - 1) * nv * hw * feat_bytes
    if sync_active:
        if execution == "p2p":
            out += replica_sync_device_bytes(layout, masters, dims,
                                             feat_bytes, model)
        else:
            out += 2 * (k - 1) * nv * sw * feat_bytes
    return out
