"""PowerLyra-style hybrid degree-threshold cut (the port's copy of
`repro/core/partition/hybrid_cut.py`): low-degree vertices live
edge-cut-local behind a halo exchange; hub vertices (in-degree >= threshold)
replicate vertex-cut-style with the replica-sync combine.

Construction: start from an edge-cut master assignment (any `PARTITIONERS`
entry, or a given `Partition`) and classify ``hub = in_degree >=
threshold``.  Each edge (src -> dst, CSR order) is owned by ``masters[dst]``
when dst is LOW-degree (the edge-cut rule: a low src that lives elsewhere
crosses the HALO wire, no replica is made) and by ``masters[src]`` when dst
is a HUB (dst's partials accumulate where its in-edges live, and the
replica-sync combine sums them).  Hub sources of owned edges are also
materialized as replica slots.  Threshold ``inf``: nobody is a hub, every
vertex has one replica and the halo carries the edge-cut communication
volume; ``0``: everybody is a hub, zero halo, a src-replicating vertex cut.

`HybridLayout` builds an inner `VertexCutLayout` over the presence sets (so
`build_replica_sync_plan` and `ReplicaLayoutBase`'s flattening apply) and
per-execution halo tables the `ReplicaSyncBackend` reads when
``halo_active``:

  halo_send [k, B, k, w]  p2p installments (with ``halo_send_mask``);
  halo_src  [k, Hbuf]     broadcast: flat index into the all_gathered
                          [k*nv] table per canonical halo slot (pad k*nv);
  halo_ring [k, k, Hbuf]  ring: per source owner, the local slot to read
                          (pad nv; each canonical slot has ONE real
                          source, so the sum over the rounds is exact).

Canonical halo slots use the edge-cut p2p plan's installment-major
`halo_slot` numbering, so the owned-edge ELL ids serve all three execution
models.  The reference fills the halo columns with a loop over the absent
edges through a dict of need positions; here one `np.unique` over
(owner, source master, home slot) keys and a `searchsorted` give the same
arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.execution.bucketing import (
    bucketed_cap_widths,
    bucketed_send_mask,
    bucketed_send_table,
    halo_slot,
)
from repro_torch.core.graph import Graph
from repro_torch.core.partition.cost_models import (
    FEAT_BYTES,
    hybrid_device_bytes,
    hybrid_exchange_widths,
)
from repro_torch.core.partition.edge_cut import PARTITIONERS
from repro_torch.core.partition.layout_api import (
    LAYOUT_BUILDERS,
    ReplicaLayoutBase,
)
from repro_torch.core.partition.vertex_cut import edge_endpoints
from repro_torch.core.partition.vertex_layout import (
    VertexCutLayout,
    owned_ell,
    place_slots,
    slot_tables,
)


def auto_hub_threshold(g: Graph, q: float = 95.0) -> float:
    """Default hub threshold: the q-th percentile of the in-degree
    distribution."""
    deg = g.degree()
    if len(deg) == 0:
        return np.inf
    return float(np.percentile(deg, q))


@dataclasses.dataclass
class HybridCut:
    """The cut decision alone (layout-free)."""
    threshold: float
    hub: np.ndarray         # [V] bool: in_degree >= threshold
    masters: np.ndarray     # [V] int64 master partition (the edge-cut side)
    edge_owner: np.ndarray  # [E] int64 owner per CSR edge
    num_parts: int


def build_hybrid_cut(g: Graph, k: int, threshold: Optional[float] = None,
                     partition=None,
                     partitioner: str = "metis_like") -> HybridCut:
    """Classify vertices by the degree threshold and assign edge owners
    (see module docstring).  ``threshold=None``: `auto_hub_threshold`."""
    if threshold is None:
        threshold = auto_hub_threshold(g)
    part = partition or PARTITIONERS[partitioner](g, k)
    masters = np.asarray(part.assignment, np.int64)
    deg = g.degree()
    hub = deg.astype(np.float64) >= threshold
    src, dst = edge_endpoints(g)
    owner = np.where(hub[dst], masters[src], masters[dst]).astype(np.int64) \
        if len(src) else np.zeros(0, np.int64)
    return HybridCut(threshold=float(threshold), hub=hub, masters=masters,
                     edge_owner=owner, num_parts=k)


class HybridLayout(ReplicaLayoutBase):
    family = "hybrid"

    @classmethod
    def validate(cls, cfg, partition=None) -> None:
        if cfg.batching != "full_graph":
            raise ValueError(
                "hybrid supports batching='full_graph' only "
                "(vertex-cut mini-batch sampling is a ROADMAP follow-up)")
        thr = cfg.hub_threshold
        if thr is not None and not thr >= 0:  # rejects negatives and NaN
            raise ValueError(
                "hub_threshold must be >= 0 (np.inf -> pure edge-cut, "
                "0 -> pure vertex-cut) or None for the auto percentile")

    def _build(self, partition):
        c, g, k = self.cfg, self.g, self.k
        self.part = partition or PARTITIONERS[c.partitioner](g, k)
        cut = self.cut = build_hybrid_cut(g, k, threshold=c.hub_threshold,
                                          partition=self.part)
        V = g.num_vertices
        src, dst = edge_endpoints(g)
        owner, masters = cut.edge_owner, cut.masters
        # presence: every master replica; dst of each owned edge; hub srcs
        # (low srcs are NOT materialized remotely: they ride the halo)
        key_list = [masters * V + np.arange(V, dtype=np.int64)]
        if len(owner):
            key_list.append(owner * V + dst)
            hs = cut.hub[src]
            if hs.any():
                key_list.append((owner * V + src)[hs])
        keys = np.unique(np.concatenate(key_list))
        vert_ids, slot_of, master_counts, rep_count = place_slots(
            keys, V, k, masters)
        nv = vert_ids.shape[1]
        dslot, sslot = slot_of[owner, dst], slot_of[owner, src]
        absent = sslot < 0  # low-degree remote src -> halo
        sm = masters[src]
        home = slot_of[sm, src]  # src is present at its own master
        # halo need sets: need[d][s] = sorted home slots (on master s) that
        # owner d's ELL reads through the wire, one key each
        hkey = np.unique((owner[absent] * k + sm[absent]) * nv + home[absent])
        counts = np.bincount(hkey // nv, minlength=k * k).reshape(k, k)
        split = np.split(hkey % nv, np.cumsum(counts.reshape(-1))[:-1])
        need = [[split[d * k + s] for s in range(k)] for d in range(k)]
        self.halo_need = need
        self.halo_rows = int(counts.sum())
        self.halo_active = self.halo_rows > 0
        execution = c.execution
        buckets = c.p2p_buckets if execution == "p2p" else 1
        Hcap = max(1, int(counts.max(initial=0)))
        widths = bucketed_cap_widths(Hcap, buckets)
        B, w = len(widths), widths[0]
        Hbuf = B * k * w if self.halo_active else 0
        self.halo_widths = widths
        # ELL columns: local slot, or nv + canonical halo slot; the pad /
        # zero row sits AFTER the halo block; reference columns: the flat
        # replica slot, a halo source's HOME flat slot
        col = np.maximum(sslot, 0)
        refc = owner * nv + col
        if absent.any():
            ekey = (owner[absent] * k + sm[absent]) * nv + home[absent]
            t = (np.searchsorted(hkey, ekey)
                 - np.searchsorted(hkey, (ekey // nv) * nv))
            col = col.copy()
            col[absent] = nv + halo_slot(t, sm[absent], w, k, 0)
            refc[absent] = sm[absent] * nv + home[absent]
        Kc, ids_owned, mask_owned, (ref_cols,) = owned_ell(
            owner, dslot, col, k, nv, nv + Hbuf, extra=[(refc, k * nv)])
        deg, master_mask, present, safe, X, y, train_w, test_w = slot_tables(
            g, vert_ids, masters, k)
        # boundary = rows other ranks read: replicated slots + halo sources
        bmask = present & (rep_count[safe] > 1)
        for s in range(k):
            lis = [need[d][s] for d in range(k) if len(need[d][s])]
            if lis:
                bmask[s, np.unique(np.concatenate(lis))] = True
        self.layout = VertexCutLayout(
            k=k, nv=nv, Kc=Kc, Rm=max(int(rep_count.max()), 1),
            vert_ids=vert_ids, slot_of=slot_of, master_mask=master_mask,
            rep_count=rep_count, ids_owned=ids_owned, mask_owned=mask_owned,
            deg=deg, bmask=bmask, X=X, y=y, train_w=train_w, test_w=test_w,
            master_counts=master_counts)
        self._flatten_layout()
        self.table_rows = nv + Hbuf + 1  # [own slots | halo | zero row]
        self.ids_global = np.where(mask_owned > 0, ref_cols,
                                   k * nv).reshape(self.Vp, Kc
                                                   ).astype(np.int64)
        self.sync_active = int(rep_count.max()) > 1 if V else False
        if self.sync_active:
            self._build_sync_plan(masters)
        else:
            self._vc_plan = {}
            self._vc_rows_per_layer = 0
            self.squeeze_keys = ()
        # per-execution halo tables (see module docstring)
        self._halo_consts = {}
        if self.halo_active:
            d_of, s_of = np.divmod(hkey // nv, k)
            li = hkey % nv
            t = np.arange(len(hkey)) - np.r_[0, np.cumsum(
                counts.reshape(-1))][hkey // nv]
            at = halo_slot(t, s_of, w, k, 0)
            if execution == "p2p":
                self._halo_consts["halo_send"] = bucketed_send_table(
                    [[need[d][s] for d in range(k)] for s in range(k)],
                    k, widths)
                self._halo_consts["halo_send_mask"] = bucketed_send_mask(
                    counts.T, widths)
            elif execution == "broadcast":
                halo_src = np.full((k, Hbuf), k * nv, np.int32)
                halo_src[d_of, at] = s_of * nv + li
                self._halo_consts["halo_src"] = halo_src
            else:  # ring
                halo_ring = np.full((k, k, Hbuf), nv, np.int32)
                halo_ring[d_of, s_of, at] = li
                self._halo_consts["halo_ring"] = halo_ring
            self.squeeze_keys += tuple(self._halo_consts)
        # halo rows crossing the wire per exchange pass
        if not self.halo_active:
            self.halo_rows_exec = 0
        elif execution == "p2p":
            self.halo_rows_exec = self.halo_rows
        else:
            self.halo_rows_exec = k * (k - 1) * nv

    def exchange_consts(self) -> dict:
        """`ReplicaLayoutBase.exchange_consts` and the execution's halo
        table (see module docstring)."""
        consts = super().exchange_consts()
        consts.update(self._halo_consts)
        return consts

    def wire_fields_per_step(self, model, dims) -> dict:
        # == cost_models.hybrid_bytes_per_step(halo_rows_exec,
        #    _vc_rows_per_layer, dims, model), split per CommStats field
        halo_w, sync_w = hybrid_exchange_widths(model, dims)
        out = {}
        if self.halo_active:
            out["halo_bytes"] = (self.halo_rows_exec
                                 * int(sum(halo_w)) * FEAT_BYTES)
        if self.sync_active:
            out["replica_sync_bytes"] = (self._vc_rows_per_layer
                                         * int(sum(sync_w)) * FEAT_BYTES)
        return out

    def embed_grad_bytes(self, dims) -> int:
        # the halo gradient's return (one width-dims[0] pass) and the
        # vertex cut's gradient combine and master-delta pair over the
        # replica rows
        rows = self.halo_rows_exec
        if self.sync_active:
            rows += 2 * self._vc_rows_per_layer
        return rows * int(dims[0]) * FEAT_BYTES

    def device_bytes_per_step(self, model, dims) -> np.ndarray:
        return hybrid_device_bytes(
            self.layout, self.cut.masters, self.halo_need,
            self.cfg.execution, dims, model=model,
            halo_active=self.halo_active, sync_active=self.sync_active)

    def telemetry_gauges(self, tel) -> None:
        super().telemetry_gauges(tel)
        recv = [sum(len(self.halo_need[d][s]) for s in range(self.k))
                for d in range(self.k)]
        for d in range(self.k):
            tel.gauge("layout.halo_rows", device=d).set(int(recv[d]))


LAYOUT_BUILDERS["hybrid"] = HybridLayout
