"""Streaming partition ingest (the port's copy of
`repro/core/partition/streaming.py`): build the edge-cut layout from a
CHUNKED edge stream instead of a resident CSR graph.

The in-memory builder (`layout_api.EdgeCutLayout`) walks a whole `Graph`;
when |E| dwarfs host memory, systems such as DGL's ``data_shuffle`` ingest
the edge list in chunks, shuffle each chunk to the partition that owns its
destination and grow the per-partition structures as they go, so the peak
host memory is O(E/chunks + layout), never O(E).

`build_streaming_layout` does that in two passes over a re-iterable chunk
stream:

  pass 1  the per-destination degree histogram -> the ELL width K (with
          the per-part sizes -> nb, Vp and the contiguous relabeling,
          exactly as the in-memory builder derives them);
  pass 2  the owner shuffle: each chunk's edges are stably grouped by the
          owner of their destination and written into that owner's ELL
          rows at per-vertex slot cursors.  A stable grouping keeps the
          order of a destination's edges, so a stream in edge-list order
          gives the rows `from_edges` + the in-memory builder give (whose
          CSR is a stable sort of the same list by destination).

`peak_transient_bytes` makes the memory claim checkable: the builder reports
the largest footprint of one chunk's transient arrays, which depends on
``chunk_edges`` only.  The vertex plane (features, labels, masks) is O(V)
and arrives as arrays; the stream carries what scales, the edges.

numpy only, host side: ingest runs in loader processes, never on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

from repro_torch.core.graph import Graph


class GraphEdgeChunks:
    """Re-iterable chunked edge stream over a CSR `Graph`: yields (src, dst)
    int64 pairs in CSR order, which for a `from_edges` graph is a stable
    by-destination order of the original edge list.  Each chunk holds at
    most ``chunk_edges`` edges; nothing references the whole edge list."""

    def __init__(self, g: Graph, chunk_edges: int):
        if chunk_edges < 1:
            raise ValueError(f"chunk_edges must be >= 1, got {chunk_edges}")
        self._g = g
        self.chunk_edges = int(chunk_edges)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        g, step = self._g, self.chunk_edges
        indptr = np.asarray(g.indptr)
        E = int(indptr[-1])
        for lo in range(0, E, step):
            hi = min(lo + step, E)
            src = np.asarray(g.indices[lo:hi], np.int64)
            # the destination of CSR position e is the v with
            # indptr[v] <= e < indptr[v+1]: a searchsorted on the O(V)
            # indptr, no O(E) expansion
            dst = np.searchsorted(indptr, np.arange(lo, hi), side="right") - 1
            yield src, dst.astype(np.int64)


@dataclasses.dataclass
class StreamingLayout:
    """The edge-cut layout as numpy arrays, with the ingest's own memory
    accounting."""

    k: int
    nb: int          # padded rows a part
    Vp: int          # k * nb
    K: int           # the ELL width (the largest in-degree)
    new_of_old: np.ndarray   # [V] int64 relabeling, owner*nb + slot
    ids: np.ndarray          # [Vp, K] int64 in-neighbor ids, pad = Vp
    mask: np.ndarray         # [Vp, K] float32 slot validity
    deg: np.ndarray          # [Vp, 1] float32 max(valid slots, 1)
    X: np.ndarray            # [k, nb, D] float32 owner-sharded features
    y: np.ndarray            # [Vp] int32
    train_w: np.ndarray      # [Vp] float32
    test_w: np.ndarray       # [Vp] float32
    emb_touched: np.ndarray  # [Vp] float32: 1 on the real (non-pad) rows
    bmask: np.ndarray        # [Vp] bool: rows read by >= 1 remote partition
    peak_transient_bytes: int  # the largest per-chunk transient footprint
    layout_bytes: int          # the arrays above


def _chunk_transient_bytes(*arrays: np.ndarray) -> int:
    return int(sum(a.nbytes for a in arrays))


def build_streaming_layout(stream: Iterable[Tuple[np.ndarray, np.ndarray]],
                           assignment: np.ndarray, k: int, num_vertices: int,
                           *, features: np.ndarray, labels: np.ndarray,
                           train_mask: Optional[np.ndarray] = None,
                           test_mask: Optional[np.ndarray] = None
                           ) -> StreamingLayout:
    """Two-pass chunked ingest -> owner shuffle -> incremental ELL layout.

    ``stream`` must be RE-ITERABLE (two passes) and yield (src, dst) edge
    chunks meaning "src is an in-neighbor of dst", in a fixed order; within
    each destination that order becomes the ELL slot order, so a stream in
    edge-list order reproduces the in-memory build exactly.
    """
    V = int(num_vertices)
    assignment = np.asarray(assignment, np.int32)
    if assignment.shape != (V,):
        raise ValueError(f"assignment must be [V]={V}, got {assignment.shape}")
    peak = 0

    # ---- pass 1: degree histogram (O(V) state, one chunk resident) -------
    deg_v = np.zeros(V, np.int64)
    for src, dst in stream:
        # O(chunk) transients: the chunk's distinct destinations and counts
        u, n = np.unique(dst, return_counts=True)
        deg_v[u] += n
        peak = max(peak, _chunk_transient_bytes(src, dst))
    K = max(int(deg_v.max(initial=0)), 1)

    # ---- relabeling, exactly as the in-memory builder ---------------------
    sizes = np.bincount(assignment, minlength=k)
    nb = max(int(sizes.max(initial=0)), 1)
    Vp = k * nb
    new_of_old = np.full(V, -1, np.int64)
    for p in range(k):
        olds = np.where(assignment == p)[0]
        new_of_old[olds] = p * nb + np.arange(len(olds))

    # ---- vertex plane: O(V) scatter into the owner-sharded blocks ---------
    features = np.asarray(features, np.float32)
    D = features.shape[1]
    X = np.zeros((Vp, D), np.float32)
    y = np.zeros((Vp,), np.int32)
    train_w = np.zeros((Vp,), np.float32)
    test_w = np.zeros((Vp,), np.float32)
    X[new_of_old] = features
    y[new_of_old] = np.asarray(labels)
    if train_mask is not None:
        train_w[new_of_old] = np.asarray(train_mask).astype(np.float32)
    if test_mask is not None:
        test_w[new_of_old] = np.asarray(test_mask).astype(np.float32)
    emb_touched = np.zeros((Vp,), np.float32)
    emb_touched[new_of_old] = 1.0

    # ---- pass 2: owner shuffle + incremental ELL scatter ------------------
    ids = np.full((Vp, K), Vp, np.int64)
    mask = np.zeros((Vp, K), np.float32)
    bmask = np.zeros((Vp,), bool)
    cursor = np.zeros(Vp, np.int64)  # next free ELL slot per new dst id
    for src, dst in stream:
        new_src = new_of_old[src]
        new_dst = new_of_old[dst]
        owner = assignment[dst]
        # the owner shuffle: a stable grouping by owning part, each part's
        # edges routed to its builder with their order per dst intact
        route = np.argsort(owner, kind="stable")
        s_r, d_r, o_r = new_src[route], new_dst[route], owner[route]
        # slot of each routed edge: cursor[dst] + its rank among its dst's
        # edges in this chunk (a cumcount over the edges sorted by dst)
        order = np.argsort(d_r, kind="stable")
        d_sorted = d_r[order]
        run_start = np.r_[0, np.flatnonzero(np.diff(d_sorted)) + 1]
        within = np.arange(len(d_sorted)) - np.repeat(
            run_start, np.diff(np.r_[run_start, len(d_sorted)]))
        slot = np.empty(len(d_r), np.int64)
        slot[order] = cursor[d_sorted] + within
        ids[d_r, slot] = s_r
        mask[d_r, slot] = 1.0
        # one run of d_sorted per distinct dst: advance its cursor by the
        # run's length
        if len(d_sorted):
            cursor[d_sorted[run_start]] += np.diff(
                np.r_[run_start, len(d_sorted)])
        # the boundary rides the same shuffle: an edge whose source lives
        # on another part than its destination's owner makes the source a
        # halo row
        remote = (s_r // nb) != o_r
        bmask[s_r[remote]] = True
        peak = max(peak, _chunk_transient_bytes(
            src, dst, new_src, new_dst, owner, route, s_r, d_r, o_r, order,
            d_sorted, within, slot, np.empty(0)) + remote.nbytes)
    deg = np.maximum(mask.sum(1, keepdims=True), 1.0).astype(np.float32)

    layout = StreamingLayout(
        k=k, nb=nb, Vp=Vp, K=K, new_of_old=new_of_old, ids=ids, mask=mask,
        deg=deg, X=X.reshape(k, nb, D), y=y, train_w=train_w, test_w=test_w,
        emb_touched=emb_touched, bmask=bmask, peak_transient_bytes=peak,
        layout_bytes=0)
    layout.layout_bytes = int(sum(
        getattr(layout, f.name).nbytes
        for f in dataclasses.fields(layout)
        if isinstance(getattr(layout, f.name), np.ndarray)))
    return layout
