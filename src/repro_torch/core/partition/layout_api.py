"""PartitionLayout: the partition-family interface (the port's copy of the
edge-cut part of `repro/core/partition/layout_api.py`).

A layout owns everything a partition family decides about how a graph lands
on k devices: the slot tables, the local-multiply ELL constants
(`ids`/`mask`/`deg`), the exchange-plan constants, byte accounting and the
host-side mapping back to original vertex ids.  The engine only dispatches.

The reference builds the ELL table with a Python loop over every vertex;
this copy builds the same arrays with vectorised numpy from the CSR, so the
2**20-vertex gcn-paper layout takes seconds.  Arrays stay numpy here; the
engine moves its rank's rows of what the sweep and the step read onto its
device.  Every rank builds the whole layout, identically, as the reference
builds it globally.  The broadcast, ring and p2p exchange plans are ported,
the boundary mask the historical-embedding protocols read, and only the
parts of the layout that the inference sweep and the full-graph training
step read.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.execution.bucketing import (
    bucketed_cap_widths,
    bucketed_send_table,
    halo_slot,
)
from repro_torch.core.feature_store import FeatureStore
from repro_torch.core.partition.cost_models import (
    FEAT_BYTES,
    model_exchange_widths,
)
from repro_torch.core.partition.edge_cut import PARTITIONERS


class PartitionLayout:
    """Base class of the partition families."""

    family = "abstract"

    def __init__(self, g, k: int, cfg, partition=None, device="cpu",
                 rank=None):
        self.g = g
        self.k = k
        self.cfg = cfg
        self.device = torch.device(device)
        self.rank = rank  # the store's device part: this block (None: all)
        self._build(partition)

    def _build(self, partition) -> None:
        raise NotImplementedError

    def exchange_consts(self) -> dict:
        """Numpy constants the device-local exchange reads (always includes
        "ids" and "mask")."""
        raise NotImplementedError

    def wire_fields_per_step(self, model: str, dims) -> dict:
        """CommStats field name -> wire bytes ONE full-graph step accrues on
        that field (their sum is one inference sweep's bytes)."""
        raise NotImplementedError

    def global_embeddings(self, H: np.ndarray) -> np.ndarray:
        """Map padded per-slot rows [Vp, D] back to original ids [V, D]."""
        raise NotImplementedError


class EdgeCutLayout(PartitionLayout):
    """A partitioner assigns VERTICES; contiguous relabeled blocks + halo
    exchange (the neighbor rows cross the wire)."""

    family = "edge_cut"

    def _build(self, partition):
        self.part = (partition
                     or PARTITIONERS[self.cfg.partitioner](self.g, self.k))
        self._build_vertex_blocks()
        self._build_exchange_plan()

    def _build_vertex_blocks(self):
        """Relabel vertices so partition p owns global rows [p*nb, (p+1)*nb).
        Pad slots are dead: no edges, zero features/weights."""
        g, k = self.g, self.k
        assign = self.part.assignment
        V = g.num_vertices
        sizes = np.bincount(assign, minlength=k)
        self.nb = nb = max(int(sizes.max()), 1)
        self.Vp = Vp = k * nb
        # a stable sort by part keeps each part's vertices in id order, as
        # the reference's np.where per part does
        order = np.argsort(assign, kind="stable")
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        slot = np.arange(V) - np.repeat(starts, sizes)
        new_of_old = np.empty(V, np.int64)
        new_of_old[order] = assign[order].astype(np.int64) * nb + slot
        self.new_of_old = new_of_old
        D = g.features.shape[1]
        X = np.zeros((Vp, D), np.float32)
        X[new_of_old] = g.features
        # labels and loss weights per slot; pad slots weigh 0
        self.y = np.zeros((Vp,), np.int32)
        self.y[new_of_old] = g.labels
        self.train_w = np.zeros((Vp,), np.float32)
        self.test_w = np.zeros((Vp,), np.float32)
        if g.train_mask is not None:
            self.train_w[new_of_old] = g.train_mask
        if g.test_mask is not None:
            self.test_w[new_of_old] = g.test_mask
        # ELL adjacency in new ids; pad id = Vp (zero row in gather tables).
        # Slot j of row v holds v's j-th in-neighbor in CSR order.
        deg = g.degree()
        self.K = K = max(int(deg.max(initial=0)), 1)
        row_of_edge = np.repeat(new_of_old, deg)
        slot_of_edge = np.arange(g.num_edges) - np.repeat(g.indptr[:-1], deg)
        ids = np.full((Vp, K), Vp, np.int64)
        mask = np.zeros((Vp, K), np.float32)
        ids[row_of_edge, slot_of_edge] = new_of_old[g.indices]
        mask[row_of_edge, slot_of_edge] = 1.0
        self.ids_global = ids
        self.mask = mask
        self.deg = np.maximum(mask.sum(1, keepdims=True), 1.0).astype(np.float32)
        # the feature plane lives in an owner-partitioned store: flat store
        # id == the relabeled vertex id (owner * nb + slot)
        self.store = FeatureStore(X.reshape(k, nb, D), self.device,
                                  owner=self.rank)
        self.X = torch.from_numpy(self.store.host_table())

    @functools.cached_property
    def bmask(self) -> np.ndarray:
        """[Vp] bool, the boundary: rows read by at least one remote
        partition (only the historical-embedding protocols read it, so it
        is built at the first read)."""
        Vp, nb = self.Vp, self.nb
        ids = self.ids_global
        remote = (self.mask > 0) & (ids // nb != (np.arange(Vp) // nb)[:, None])
        src = ids[remote]
        bmask = np.zeros((Vp,), bool)
        bmask[src[src < Vp]] = True
        return bmask

    def _build_exchange_plan(self):
        """Execution-model-specific static arrays.  broadcast: the gather
        table is every block, all-gathered, then the zero row at Vp.  ring:
        the table is the rotating block of nb rows, one ELL per source
        block.  p2p: the table is [own block nb | halo rows B*k*w | zero
        row], the halo rows arriving through B installments of
        all_to_all."""
        ex = self.cfg.execution
        if ex == "broadcast":
            self.ids_exec = self.ids_global.astype(np.int32)
            self.table_rows = self.Vp + 1
        elif ex == "ring":
            self._build_ring_plan()
        else:
            self._build_p2p_plan()

    def _build_ring_plan(self):
        """The ring plan, vectorised over the reference's loop over source
        blocks: ids_exec and mask_exec [k(dev), k(src), nb, K], slot j of
        row v naming its neighbor's row within source block s when the
        neighbor lives there.  Every other slot carries id 0 with mask 0:
        the masked ELL reduction drops it, so the rotating block needs no
        zero row and the table has nb rows."""
        k, nb, Vp, K = self.k, self.nb, self.Vp, self.K
        ids = self.ids_global
        real = ids < Vp
        src = np.where(real, ids // nb, -1)[:, None, :]  # [Vp, 1, K]
        here = src == np.arange(k)[None, :, None]  # [Vp, k(src), K]
        local = np.where(real, ids % nb, 0).astype(np.int32)[:, None, :]
        ids_by_src = np.where(here, local, np.int32(0))
        mask_by_src = (self.mask[:, None, :] * here).astype(np.float32)
        self.ids_exec = np.ascontiguousarray(
            ids_by_src.reshape(k, nb, k, K).transpose(0, 2, 1, 3))
        self.mask_exec = np.ascontiguousarray(
            mask_by_src.reshape(k, nb, k, K).transpose(0, 2, 1, 3))
        self.table_rows = nb

    def _build_p2p_plan(self):
        """The p2p halo plan, vectorised over the reference's loops over
        every (dst, src) pair and every row x slot.  need[d][s] lists, in
        increasing order, the local rows (within block s) that block d's
        rows read; the pair's t-th need row lands at `halo_slot` t of d's
        table."""
        k, nb, Vp = self.k, self.nb, self.Vp
        ids = self.ids_global
        real = ids < Vp
        dst = np.broadcast_to(np.arange(Vp, dtype=np.int64)[:, None] // nb,
                              ids.shape)
        src = np.where(real, ids // nb, -1)
        local = np.where(real, ids % nb, 0)
        remote = real & (src != dst)
        # one key per (dst block, src block, local row); sorted and unique,
        # so each (dst, src) pair's rows form one increasing run
        key = (dst * k + src) * nb + local
        uniq = np.unique(key[remote])
        pair = uniq // nb
        counts = np.bincount(pair, minlength=k * k).reshape(k, k)  # [d, s]
        need = np.split(uniq % nb, np.cumsum(counts.reshape(-1))[:-1])
        cap = self.cap = max(1, int(counts.max(initial=0)))
        # true halo rows per pass (== part.communication_volume: each need
        # set is one partition's remote in-neighbor set)
        self._halo_rows = int(counts.sum())
        widths = self.p2p_widths = bucketed_cap_widths(
            cap, self.cfg.p2p_buckets)
        B, w = len(widths), widths[0]
        # send_rows[src, B, dst, w]: what each SOURCE ships per installment
        # and destination; send_mask marks the entries that carry a need row
        # (the rest pad the installment and ship zeros)
        self.send_rows = bucketed_send_table(
            [[need[d * k + s] for d in range(k)] for s in range(k)], k, widths)
        fill = np.arange(B * w)[None, None, :] < counts.T[:, :, None]
        self.send_mask = fill.astype(np.float32).reshape(
            k, k, B, w).transpose(0, 2, 1, 3).copy()
        # ids remapped into the local gather table:
        #   [0, nb)            own block
        #   [nb, nb + B*k*w)   halo slot (installment-major; see halo_slot)
        #   nb + B*k*w         zero row (pads + absent)
        ids_remap = np.full(ids.shape, nb + B * k * w, np.int32)
        own = real & ~remote
        ids_remap[own] = local[own]
        k_rem = key[remote]
        t = (np.searchsorted(uniq, k_rem)
             - np.searchsorted(uniq, (k_rem // nb) * nb))
        ids_remap[remote] = halo_slot(t, src[remote], w, k, nb)
        self.ids_exec = ids_remap
        self.table_rows = nb + B * k * w + 1

    def exchange_consts(self) -> dict:
        """broadcast, p2p: ids and mask [Vp, K] (rank r's rows at
        [r*nb, (r+1)*nb)); ring: [k(dev), k(src), nb, K] (rank r's block at
        [r]); p2p adds its send tables."""
        consts = dict(ids=self.ids_exec, mask=self.mask)
        if self.cfg.execution == "ring":
            consts["mask"] = self.mask_exec
        elif self.cfg.execution == "p2p":
            consts.update(send_rows=self.send_rows, send_mask=self.send_mask)
        return consts

    def _halo_rows_per_pass(self) -> int:
        if self.cfg.execution in ("broadcast", "ring"):
            # every device gathers (or receives in turn) the other k-1
            # padded blocks
            return self.k * (self.k - 1) * self.nb
        return self._halo_rows

    def wire_fields_per_step(self, model, dims) -> dict:
        widths = model_exchange_widths(model, dims, "edge_cut")
        return {"halo_bytes":
                self._halo_rows_per_pass() * int(sum(widths)) * FEAT_BYTES}

    def global_embeddings(self, H: np.ndarray) -> np.ndarray:
        return H[self.new_of_old]


LAYOUT_BUILDERS = {
    "edge_cut": EdgeCutLayout,
}


def get_layout_builder(family: str):
    try:
        return LAYOUT_BUILDERS[family]
    except KeyError:
        raise NotImplementedError(
            f"partition family {family!r}: only edge_cut is ported; "
            "vertex_cut and hybrid arrive with the replica-family slice "
            "(ROADMAP queue 1 item 7)"
        ) from None
