"""Static padded replica layout for vertex-cut execution (the port's copy of
`repro/core/partition/vertex_layout.py`).  Edges are partitioned; every
endpoint of a rank's owned edges, plus each vertex's master replica, becomes
a replica SLOT on that rank, and the owned edges become a rank-local ELL
block whose columns index those slots.

``k`` ranks each hold ``nv`` padded slots, so the flattened replica space
``[k * nv]`` plays the role the padded vertex space ``[k * nb]`` plays for
edge cut: the features, labels, loss weights and the historical embeddings
are all laid out over it, rank r's rows at [r*nv, (r+1)*nv).

Invariants (`execution/replica_sync.py` and the engine rely on them):
  * every vertex is present on its master partition, so the loss over
    master slots covers every train vertex exactly once;
  * slots are sorted by global vertex id per rank (with
    ``sorted_masters=True`` the master slots come first as a contiguous
    prefix, each group still ascending); the layout is a pure function of
    (graph, cut, sorted_masters);
  * pad slots (``vert_ids == V``) have no owned edges, zero features and
    zero weights, and no gather table names them.

The per-(rank, slot) in-edge count is one `np.bincount` where the reference
calls `np.add.at` (the same counts; seconds faster at 16.7M edges).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.core.partition.vertex_cut import VertexCut, edge_endpoints


@dataclasses.dataclass
class VertexCutLayout:
    k: int    # ranks / partitions
    nv: int   # padded replica slots per rank
    Kc: int   # ELL width: max owned in-edges of any (rank, dst slot)
    Rm: int   # max replicas of any vertex (incl. the forced master)
    vert_ids: np.ndarray    # [k, nv] int64 global vertex per slot, pad = V
    slot_of: np.ndarray     # [k, V] int64 slot of vertex on rank, -1 absent
    master_mask: np.ndarray  # [k, nv] f32, 1 on the master replica slot
    rep_count: np.ndarray   # [V] replicas per vertex (incl. forced master)
    ids_owned: np.ndarray   # [k, nv, Kc] int32 local src slot, pad = nv
    mask_owned: np.ndarray  # [k, nv, Kc] f32
    deg: np.ndarray         # [k, nv, 1] f32 GLOBAL in-degree (>= 1)
    bmask: np.ndarray       # [k, nv] bool, replicated (rep_count > 1) slots
    X: np.ndarray           # [k, nv, D] f32 replica features
    y: np.ndarray           # [k, nv] int32
    train_w: np.ndarray     # [k, nv] f32, master & train only
    test_w: np.ndarray      # [k, nv] f32, master & test only
    sorted_masters: bool = False  # masters are the per-rank slot prefix?
    master_counts: np.ndarray = None  # [k] masters per rank

    def replication_factor(self) -> float:
        appears = self.rep_count
        return float(appears[appears > 0].mean()) if (appears > 0).any() else 0.0


def owned_ell(owner: np.ndarray, dslot: np.ndarray, cols: np.ndarray, k: int,
              nv: int, pad_id: int, extra=()):
    """The owned-edge ELL [k, nv, Kc]: row (rank, dst slot) lists the
    columns ``cols`` of its in-edges in CSR order.  ``extra`` holds more
    per-edge columns laid out the same way, each (values, pad).  Returns
    (Kc, ids int32, mask f32, [extra tables])."""
    grp = owner * nv + dslot
    cnt = np.bincount(grp, minlength=k * nv)
    Kc = max(int(cnt.max(initial=0)), 1)
    ids = np.full((k, nv, Kc), pad_id, np.int32)
    mask = np.zeros((k, nv, Kc), np.float32)
    tables = [np.full((k, nv, Kc), pad, np.asarray(vals).dtype)
              for vals, pad in extra]
    if len(owner):
        order = np.argsort(grp, kind="stable")
        gs = grp[order]
        run_id = np.cumsum(np.r_[0, (np.diff(gs) != 0).astype(np.int64)])
        first = np.r_[0, np.flatnonzero(np.diff(gs)) + 1]
        pos = np.arange(len(gs)) - first[run_id]
        at = (owner[order], dslot[order], pos)
        ids[at] = cols[order]
        mask[at] = 1.0
        for table, (vals, _) in zip(tables, extra):
            table[at] = vals[order]
    return Kc, ids, mask, tables


def slot_tables(g: Graph, vert_ids: np.ndarray, masters: np.ndarray, k: int):
    """The per-slot tables of a replica layout: (deg [k, nv, 1], master_mask,
    present, safe vertex ids, X, y, train_w, test_w); pad slots get degree
    1 and zero everything."""
    V = g.num_vertices
    deg_g = np.maximum(g.degree(), 1).astype(np.float32)
    present = vert_ids < V
    safe = np.minimum(vert_ids, V - 1)
    deg = np.where(present, deg_g[safe], 1.0)[..., None].astype(np.float32)
    master_mask = (present & (masters[safe] == np.arange(k)[:, None])
                   ).astype(np.float32)
    X = np.where(present[..., None], g.features[safe], 0.0).astype(np.float32)
    y = np.where(present, g.labels[safe], 0).astype(np.int32)
    shape = vert_ids.shape
    train = (g.train_mask[safe] if g.train_mask is not None
             else np.zeros(shape, bool))
    test = (g.test_mask[safe] if g.test_mask is not None
            else np.zeros(shape, bool))
    train_w = (master_mask * np.where(present, train, False)).astype(np.float32)
    test_w = (master_mask * np.where(present, test, False)).astype(np.float32)
    return deg, master_mask, present, safe, X, y, train_w, test_w


def place_slots(keys: np.ndarray, V: int, k: int, masters: np.ndarray,
                sorted_masters: bool = False):
    """Slots from the sorted, unique presence keys (rank * V + vertex):
    (vert_ids [k, nv], slot_of [k, V], master_counts [k], rep_count [V])."""
    part_of, vid = keys // V, keys % V
    rep_count = np.bincount(vid, minlength=V)
    sizes = np.bincount(part_of, minlength=k)
    nv = max(int(sizes.max()), 1)
    vert_ids = np.full((k, nv), V, np.int64)
    slot_of = np.full((k, V), -1, np.int64)
    master_counts = np.zeros(k, np.int64)
    bounds = np.r_[0, np.cumsum(sizes)]
    for d in range(k):
        vs = vid[bounds[d]:bounds[d + 1]]  # sorted ascending (keys are sorted)
        is_m = masters[vs] == d
        master_counts[d] = int(is_m.sum())
        if sorted_masters:
            vs = np.concatenate([vs[is_m], vs[~is_m]])
        vert_ids[d, : len(vs)] = vs
        slot_of[d, vs] = np.arange(len(vs))
    return vert_ids, slot_of, master_counts, rep_count


def build_vertex_layout(g: Graph, vc: VertexCut, k: int,
                        sorted_masters: bool = False) -> VertexCutLayout:
    """Turn a VertexCut into the static padded layout above."""
    V = g.num_vertices
    src, dst = edge_endpoints(g)
    owner = vc.edge_owner.astype(np.int64)
    masters = vc.masters.astype(np.int64)
    # presence set: endpoints of owned edges and the forced master replicas
    keys = np.unique(np.concatenate([
        owner * V + dst, owner * V + src,
        masters * V + np.arange(V, dtype=np.int64)]))
    vert_ids, slot_of, master_counts, rep_count = place_slots(
        keys, V, k, masters, sorted_masters)
    nv = vert_ids.shape[1]
    # owned-edge ELL: row = dst slot, col = src slot, both on the owner
    Kc, ids_owned, mask_owned, _ = owned_ell(
        owner, slot_of[owner, dst], slot_of[owner, src], k, nv, nv)
    deg, master_mask, present, safe, X, y, train_w, test_w = slot_tables(
        g, vert_ids, masters, k)
    bmask = present & (rep_count[safe] > 1)
    return VertexCutLayout(
        k=k, nv=nv, Kc=Kc, Rm=max(int(rep_count.max()), 1),
        vert_ids=vert_ids, slot_of=slot_of, master_mask=master_mask,
        rep_count=rep_count, ids_owned=ids_owned, mask_owned=mask_owned,
        deg=deg, bmask=bmask, X=X, y=y, train_w=train_w, test_w=test_w,
        sorted_masters=sorted_masters, master_counts=master_counts)
