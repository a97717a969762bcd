"""PartitionLayout: the partition-family interface (the port's copy of the
edge-cut part of `repro/core/partition/layout_api.py`).

A layout owns everything a partition family decides about how a graph lands
on k devices: the slot tables, the local-multiply ELL constants
(`ids`/`mask`/`deg`), the exchange-plan constants, byte accounting and the
host-side mapping back to original vertex ids.  The engine only dispatches.

The reference builds the ELL table with a Python loop over every vertex;
this copy builds the same arrays with vectorised numpy from the CSR, so the
2**20-vertex gcn-paper layout takes seconds.  Arrays stay numpy here; the
engine moves what the sweep reads onto its device.  Only the broadcast
exchange plan is ported (ring and p2p arrive with the multi-rank slice), and
only the parts of the layout that the inference sweep reads.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.feature_store import FeatureStore
from repro_torch.core.partition.cost_models import (
    FEAT_BYTES,
    model_exchange_widths,
)
from repro_torch.core.partition.edge_cut import PARTITIONERS


class PartitionLayout:
    """Base class of the partition families."""

    family = "abstract"

    def __init__(self, g, k: int, cfg, partition=None, device="cpu"):
        self.g = g
        self.k = k
        self.cfg = cfg
        self.device = torch.device(device)
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
        Pad slots are dead: no edges, zero features."""
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
        self.store = FeatureStore(X.reshape(k, nb, D), self.device)
        self.X = self.store.device_table()

    def _build_exchange_plan(self):
        if self.cfg.execution != "broadcast":
            raise NotImplementedError(
                f"execution={self.cfg.execution!r}: only the broadcast plan "
                "is ported; ring and p2p arrive with the multi-rank slice")
        # gather table per device = all_gather(H) [Vp] + zero row at Vp
        self.ids_exec = self.ids_global.astype(np.int32)

    def exchange_consts(self) -> dict:
        return dict(ids=self.ids_exec, mask=self.mask)

    def wire_fields_per_step(self, model, dims) -> dict:
        # broadcast: every device gathers the other k-1 padded blocks
        rows = self.k * (self.k - 1) * self.nb
        widths = model_exchange_widths(model, dims, "edge_cut")
        return {"halo_bytes": rows * int(sum(widths)) * FEAT_BYTES}

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
            "vertex_cut and hybrid arrive with the replica-family slice"
        ) from None
