"""PartitionLayout: the partition-family interface (the port's copy of
`repro/core/partition/layout_api.py`: the edge-cut family and the replica
families' base, `ReplicaLayoutBase`, with the vertex-cut family; the hybrid
family is in `hybrid_cut.py` and registers itself).

A layout owns everything a partition family decides about how a graph lands
on k devices: the slot tables, the local-multiply ELL constants
(`ids`/`mask`/`deg`), the exchange-plan constants, master masking of the
loss weights, byte accounting and the host-side mapping back to original
vertex ids.  The engine only dispatches.

The reference builds the edge-cut ELL table with a Python loop over every
vertex; this copy builds the same arrays with vectorised numpy from the
CSR, so the 2**20-vertex gcn-paper layout takes seconds.  Arrays stay numpy
here; the engine moves its rank's rows of what the sweep and the step read
onto its device: the rows [r*nb, (r+1)*nb) of every per-row table, and
entry r of every table in ``squeeze_keys`` (whose leading axis is the
rank, as the reference's).  Every rank builds the whole layout,
identically, as the reference builds it globally: the parts of the layout
that the inference sweep and the training steps read, the
trainable-embedding touched mask (`emb_touched`) and its gradient bytes
(`embed_grad_bytes`), the per-device byte model the autotuner scores plans
by (`device_bytes_per_step`) and the per-device layout gauges of the
run-wide telemetry (`telemetry_gauges`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.execution.bucketing import (
    bucketed_cap_widths,
    bucketed_send_mask,
    bucketed_send_table,
    halo_slot,
)
from repro_torch.core.execution.replica_sync import build_replica_sync_plan
from repro_torch.core.feature_store import FeatureStore
from repro_torch.core.partition.cost_models import (
    FEAT_BYTES,
    edge_cut_halo_device_bytes,
    model_exchange_widths,
    replica_sync_device_bytes,
)
from repro_torch.core.partition.edge_cut import PARTITIONERS
from repro_torch.core.partition.vertex_cut import VERTEX_CUTS
from repro_torch.core.partition.vertex_layout import build_vertex_layout


class PartitionLayout:
    """Base class of the partition families."""

    family = "abstract"
    ref_vert_ids = None  # [k, n] global vertex of each row (pad = V) for the
    #   oracle's scatter-add replica combine; None: every row is unique
    squeeze_keys: tuple = ()  # exchange consts whose leading axis is the rank

    def __init__(self, g, k: int, cfg, partition=None, device="cpu",
                 rank=None):
        self.g = g
        self.k = k
        self.cfg = cfg
        self.device = torch.device(device)
        self.rank = rank  # the store's device part: this block (None: all)
        self._build(partition)

    @classmethod
    def validate(cls, cfg, partition=None) -> None:
        """Raise ValueError for configs this family cannot run."""

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

    def embed_grad_bytes(self, dims) -> int:
        """Wire bytes a full-graph step pays to route the layer-0 embedding
        gradients home (trainable features): the reverse of one exchange
        pass at width dims[0]."""
        raise NotImplementedError

    def device_bytes_per_step(self, model: str, dims) -> np.ndarray:
        """[k] per-device wire bytes of one step, both directions (sent +
        received): the max is the step's critical-path volume, the
        autotuner's bottleneck objective."""
        raise NotImplementedError

    def telemetry_gauges(self, tel) -> None:
        """Seed ``tel`` with the static per-device layout gauges (owned
        vertices / edges, replica rows, ...) the imbalance report reads."""
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
        if self.cfg.execution == "ring":
            self.squeeze_keys = ("ids", "mask")
        elif self.cfg.execution == "p2p":
            self.squeeze_keys = ("send_rows", "send_mask")

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
        self.X = torch.from_numpy(self.store.flat())
        # the full-graph touched set of trainable embeddings: every REAL
        # owned row is in the batch (pad rows stay untouched forever)
        self.emb_touched = np.zeros((Vp,), np.float32)
        self.emb_touched[new_of_old] = 1.0

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
        self.send_mask = bucketed_send_mask(counts.T, widths)
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

    def embed_grad_bytes(self, dims) -> int:
        return self._halo_rows_per_pass() * int(dims[0]) * FEAT_BYTES

    def device_bytes_per_step(self, model, dims) -> np.ndarray:
        if self.cfg.execution == "p2p":
            return edge_cut_halo_device_bytes(self.g, self.part, dims,
                                              model=model)
        widths = model_exchange_widths(model, dims, "edge_cut")
        per = 2 * (self.k - 1) * self.nb * int(sum(widths)) * FEAT_BYTES
        return np.full(self.k, per, np.int64)

    def telemetry_gauges(self, tel) -> None:
        k = self.k
        owned_v = np.bincount(self.part.assignment, minlength=k)
        owned_edges = self.mask.reshape(k, self.nb, -1).sum((1, 2))
        for d in range(k):
            tel.gauge("layout.owned_vertices", device=d).set(
                int(owned_v[d]))
            tel.gauge("layout.owned_edges", device=d).set(
                float(owned_edges[d]))

    def global_embeddings(self, H: np.ndarray) -> np.ndarray:
        return H[self.new_of_old]


# ---------------------------------------------------------------------------
# replica families: vertex_cut (and the hybrid cut, which subclasses the
# shared base in partition/hybrid_cut.py): replica slot tables, master
# masking and the replica-sync combine
# ---------------------------------------------------------------------------


class ReplicaLayoutBase(PartitionLayout):
    """Shared engine-facing plumbing for families built on replica slot
    tables: an inner `VertexCutLayout`-shaped ``self.layout`` and a
    `build_replica_sync_plan` exchange plan, flattened into the replica
    space [Vp = k*nv] (rank r's slots at [r*nv, (r+1)*nv))."""

    sync_active = True  # replicas exist: the partials are combined
    halo_active = False  # the owned-edge ELL reads remote rows (hybrid)

    def _flatten_layout(self):
        """Mirror the inner [k, nv] slot tables into the flattened replica
        space the engine uploads."""
        lay, k = self.layout, self.k
        self.nb = self.nv = nv = lay.nv
        self.Vp = Vp = k * nv
        self.K = lay.Kc
        self.store = FeatureStore(lay.X, self.device, owner=self.rank)
        self.X = torch.from_numpy(self.store.flat())
        # trainable embeddings update at MASTER slots only (the replicas
        # receive the master's delta through the replica sync, so they
        # never drift and never update twice)
        self.emb_touched = np.asarray(lay.master_mask.reshape(Vp), np.float32)
        self.y = lay.y.reshape(Vp)
        self.train_w = lay.train_w.reshape(Vp)
        self.test_w = lay.test_w.reshape(Vp)
        self.deg = lay.deg.reshape(Vp, 1)
        self.bmask = lay.bmask.reshape(Vp)
        self.mask = lay.mask_owned.reshape(Vp, lay.Kc)
        self.ids_exec = lay.ids_owned.reshape(Vp, lay.Kc)
        self.ref_vert_ids = lay.vert_ids  # [k, nv], pad = V
        # the owned-edge gather table: [own slots | zero row]
        self.table_rows = nv + 1

    def _build_sync_plan(self, masters):
        c, Vp = self.cfg, self.Vp
        plan = build_replica_sync_plan(self.layout, masters, c.execution,
                                       buckets=c.p2p_buckets)
        plan.pop("execution")
        self._vc_rows_per_layer = plan.pop("rows_per_layer")
        plan.pop("caps", None)  # p2p: the pre-bucket c1/c2
        slot_tables = ("rep_ids", "rep_mask", "gather_ids", "gather_mask",
                       "scatter_ids")  # [k, nv, ...] -> [Vp, ...]
        self._vc_plan = {key: (a.reshape((Vp,) + a.shape[2:])
                               if key in slot_tables else a)
                         for key, a in plan.items()}
        self.squeeze_keys = tuple(
            key for key in ("send1", "send1_mask", "send2", "send2_mask",
                            "ring_ids") if key in self._vc_plan)

    def exchange_consts(self) -> dict:
        """ids and mask [Vp, Kc] (the owned-edge ELL), and the sync plan:
        broadcast rep_ids, rep_mask [Vp, Rm]; ring ring_ids [k(rank),
        k(owner), nv]; p2p send1, send2 and their masks [k, B, k, w],
        gather_ids, gather_mask [Vp, Rm] and scatter_ids [Vp]."""
        return dict(ids=self.ids_exec, mask=self.mask, **self._vc_plan)

    def telemetry_gauges(self, tel) -> None:
        lay, k = self.layout, self.k
        V = self.g.num_vertices
        owned_edges = lay.mask_owned.reshape(k, -1).sum(1)
        replica_rows = (lay.vert_ids < V).sum(1)
        masters = lay.master_mask.reshape(k, -1).sum(1)
        for d in range(k):
            tel.gauge("layout.owned_edges", device=d).set(
                float(owned_edges[d]))
            tel.gauge("layout.replica_rows", device=d).set(
                int(replica_rows[d]))
            tel.gauge("layout.master_rows", device=d).set(
                float(masters[d]))

    def global_embeddings(self, H: np.ndarray) -> np.ndarray:
        """Read each vertex's MASTER replica row.  With sorted_masters
        layouts the masters are a contiguous per-rank prefix, so this is k
        prefix slices instead of a [Vp] boolean mask scan."""
        lay = self.layout
        V = self.g.num_vertices
        out = np.zeros((V, H.shape[1]), H.dtype)
        counts = getattr(lay, "master_counts", None)
        if getattr(lay, "sorted_masters", False) and counts is not None:
            for d in range(self.k):
                n = int(counts[d])
                out[lay.vert_ids[d, :n]] = H[d * self.nv: d * self.nv + n]
            return out
        flat_vid = lay.vert_ids.reshape(-1)  # pad slots -> V
        mm = lay.master_mask.reshape(-1) > 0.5
        out[flat_vid[mm]] = H[mm]
        return out


class VertexCutFamilyLayout(ReplicaLayoutBase):
    family = "vertex_cut"

    @classmethod
    def validate(cls, cfg, partition=None) -> None:
        if cfg.vertex_cut not in VERTEX_CUTS:
            raise ValueError(
                f"vertex_cut must be one of {tuple(VERTEX_CUTS)}")
        if cfg.batching != "full_graph":
            raise ValueError(
                "vertex_cut supports batching='full_graph' only "
                "(vertex-cut mini-batch sampling is a ROADMAP follow-up)")
        if partition is not None:
            raise ValueError(
                "partition= is an edge-cut Partition; vertex_cut builds "
                "its own cut from cfg.vertex_cut")

    def _build(self, partition):
        c, g, k = self.cfg, self.g, self.k
        self.vcut = VERTEX_CUTS[c.vertex_cut](g, k, seed=c.seed)
        self.layout = build_vertex_layout(
            g, self.vcut, k, sorted_masters=c.sorted_masters)
        self._flatten_layout()
        # reference-step ELL in the flattened replica space: local slot ->
        # global flat slot d*nv + slot; pads -> Vp (the appended zero row)
        lay, nv, Vp = self.layout, self.nv, self.Vp
        flat_off = (np.arange(k) * nv)[:, None, None]
        self.ids_global = np.where(lay.mask_owned > 0,
                                   lay.ids_owned + flat_off, Vp
                                   ).reshape(Vp, lay.Kc).astype(np.int64)
        self._build_sync_plan(self.vcut.masters)

    def wire_fields_per_step(self, model, dims) -> dict:
        # every layer's replica sync ships `rows_per_layer` rows at that
        # layer's exchange width (gat: + the attention and max columns), as
        # cost_models.replica_sync_bytes_per_step
        widths = model_exchange_widths(model, dims, "vertex_cut")
        return {"replica_sync_bytes":
                self._vc_rows_per_layer * int(sum(widths)) * FEAT_BYTES}

    def embed_grad_bytes(self, dims) -> int:
        # the gradient's combine and the masters' delta re-broadcast: two
        # sync passes at width dims[0]
        return 2 * self._vc_rows_per_layer * int(dims[0]) * FEAT_BYTES

    def device_bytes_per_step(self, model, dims) -> np.ndarray:
        if self.cfg.execution == "p2p":
            return replica_sync_device_bytes(self.layout, self.vcut.masters,
                                             dims, model=model)
        widths = model_exchange_widths(model, dims, "vertex_cut")
        per = 2 * (self.k - 1) * self.nv * int(sum(widths)) * FEAT_BYTES
        return np.full(self.k, per, np.int64)


LAYOUT_BUILDERS = {
    "edge_cut": EdgeCutLayout,
    "vertex_cut": VertexCutFamilyLayout,
}


def get_layout_builder(family: str):
    """Resolve a family string to its layout class.  The hybrid family
    registers itself on import (`hybrid_cut.py` imports this module's base
    classes)."""
    if family == "hybrid" and family not in LAYOUT_BUILDERS:
        from repro_torch.core.partition import hybrid_cut  # noqa: F401
    try:
        return LAYOUT_BUILDERS[family]
    except KeyError:
        raise ValueError(f"unknown partition family {family!r}; known: "
                         f"{tuple(LAYOUT_BUILDERS)}") from None
