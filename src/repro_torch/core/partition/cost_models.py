"""Communication cost models (the port's copy of the edge-cut, vertex-cut and
hybrid byte models of `repro/core/partition/cost_models.py`): the heuristic
affinity scores the streaming partitioners read (survey Eq. 3-5), and the
standalone byte models the engine's CommStats accounting is cross-checked
against.  The per-device byte models the autotuner reads are not copied."""
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
