"""DistGNNEngine (the port's counterpart of `repro/core/engine.py`): the
layer-wise full-graph inference sweep on one card.

The engine builds the partition family's layout (`partition/layout_api.py`),
moves the ELL constants and the feature plane onto its device once, and runs
each layer through the family's ExchangeBackend
(`execution/exchange_api.py`): exchange (chunked), masked ELL multiply
through the hand-written CUDA kernel, degree normalization, then the model's
dense combine.  `infer_full_graph(reference=True)` runs an independent
plain-PyTorch gather over the same padded space: the oracle every sweep is
held to.

Ported: model gcn, partition family edge_cut, execution broadcast, batching
full_graph, one rank.  Everything else raises NotImplementedError naming the
slice it waits for.  Training, the async protocols and telemetry arrive with
their own slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.execution.exchange_api import make_backend
from repro_torch.core.graph import Graph
from repro_torch.core.partition.edge_cut import Partition
from repro_torch.core.partition.layout_api import get_layout_builder
from repro_torch.core.sampling.distributed import CommStats
from repro_torch.kernels.ops import ell_spmm

EXECUTION_MODELS = ("broadcast", "ring", "p2p")
GNN_MODELS = ("gcn", "sage", "gat", "gin")
BATCHING_MODES = ("full_graph", "node_wise", "layer_wise", "subgraph")
PARTITION_FAMILIES = ("edge_cut", "vertex_cut", "hybrid")

# layout attributes the engine mirrors, so callers keep reading eng.<attr>
ENGINE_MIRROR_ATTRS = ("nb", "Vp", "K", "ids_global", "store")


@dataclasses.dataclass
class EngineConfig:
    execution: str = "broadcast"  # broadcast | ring | p2p
    model: str = "gcn"  # gcn | sage | gat | gin — the GNN layer program
    partition_family: str = "edge_cut"  # edge_cut | vertex_cut | hybrid
    partitioner: str = "hash"  # edge_cut: any key of PARTITIONERS (hash and
    #   range are ported; with one rank every partitioner gives part 0)
    batching: str = "full_graph"  # full_graph | node_wise | layer_wise | subgraph
    exchange_chunks: int = 1  # feature-dim chunks of the exchange
    hidden: int = 32
    num_layers: int = 2


def _world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class DistGNNEngine:
    """Builds the device layout + exchange plan from (graph, config) and
    exposes the layer-wise inference sweep plus its single-device oracle.

    ``device`` is where the sweep runs: "cuda" by default, and the
    constructor raises when CUDA is missing unless the caller asks for
    "cpu" (where the ELL multiply takes the kernel's plain version)."""

    def __init__(self, g: Graph, cfg: Optional[EngineConfig] = None,
                 partition: Optional[Partition] = None, *, device="cuda"):
        self.cfg = cfg = cfg or EngineConfig()
        if cfg.execution not in EXECUTION_MODELS:
            raise ValueError(f"execution must be one of {EXECUTION_MODELS}")
        if cfg.model not in GNN_MODELS:
            raise ValueError(f"model must be one of {GNN_MODELS}")
        if cfg.batching not in BATCHING_MODES:
            raise ValueError(f"batching must be one of {BATCHING_MODES}")
        if cfg.partition_family not in PARTITION_FAMILIES:
            raise ValueError(
                f"partition_family must be one of {PARTITION_FAMILIES}")
        if cfg.exchange_chunks < 1:
            raise ValueError("exchange_chunks must be >= 1")
        if cfg.model != "gcn":
            raise NotImplementedError(
                f"model={cfg.model!r}: only gcn is ported; sage/gat/gin "
                "arrive with the model-axis slice")
        if cfg.batching != "full_graph":
            raise NotImplementedError(
                f"batching={cfg.batching!r}: only full_graph is ported; the "
                "sampled mini-batch path arrives with its own slice")
        self.k = _world_size() if partition is None else partition.num_parts
        if cfg.execution != "broadcast" or self.k != 1:
            raise NotImplementedError(
                f"execution={cfg.execution!r} on {self.k} rank(s): only "
                "broadcast on one rank is ported; the multi-rank slice adds "
                "broadcast/ring/p2p over torch.distributed")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DistGNNEngine runs on the card (device='cuda') and CUDA is "
                "not available; pass device='cpu' to run on the CPU")
        # the sweep is held to the fp32 reference: no TF32 in the matmuls
        torch.backends.cuda.matmul.allow_tf32 = False
        self.g = g
        builder = get_layout_builder(cfg.partition_family)
        lay = self.playout = builder(g, self.k, cfg, partition=partition,
                                     device=self.device)
        for name in ENGINE_MIRROR_ATTRS:
            setattr(self, name, getattr(lay, name))
        consts = lay.exchange_consts()
        self._consts = dict(
            ids=torch.from_numpy(consts["ids"]).to(self.device),
            mask=torch.from_numpy(consts["mask"]).to(self.device),
            deg=torch.from_numpy(lay.deg).to(self.device))
        self.backend = make_backend(self)
        num_classes = int(g.labels.max()) + 1
        self.dims = ([g.features.shape[1]]
                     + [cfg.hidden] * (cfg.num_layers - 1) + [num_classes])
        self._wire_fields = lay.wire_fields_per_step(cfg.model, self.dims)
        self._infer_step = None
        self.comm_stats = CommStats()

    # ------------------------------------------------------------------
    # shared layer math
    # ------------------------------------------------------------------

    def _ell(self, ids, mask, table):
        """sum_k mask[v,k] * table[ids[v,k]]: the CUDA ELL kernel on the
        card, its plain version on the CPU."""
        return ell_spmm(ids, mask, table, normalize=False)

    @staticmethod
    def _combine(model, p_l, nbr, h_self, last: bool):
        """Model-specific combine of the aggregated neighbor rows with the
        RESIDENT self rows, shared by the sweep and the oracle."""
        if model != "gcn":
            raise NotImplementedError(model)
        z = (nbr + h_self) @ p_l["w"] + p_l["b"]
        return z if last else torch.relu(z)

    def _make_reference_layer(self):
        """Single-device reference layer over the padded [Vp] space: a plain
        slot-by-slot gather of the global ELL table (written apart from the
        kernel and its plain version, so it checks both)."""
        c = self.cfg
        ids_g = torch.from_numpy(self.ids_global).to(self.device)
        mask, deg = self._consts["mask"], self._consts["deg"]

        def layer_ref(p_l, H, last):
            table = torch.cat([H, H.new_zeros((1, H.shape[1]))], 0)
            gathered = torch.zeros_like(H)
            for j in range(ids_g.shape[1]):
                gathered += mask[:, j:j + 1] * table[ids_g[:, j]]
            return self._combine(c.model, p_l, gathered / deg, H, last=last)

        return layer_ref

    # ------------------------------------------------------------------
    # serving: layer-wise full-graph inference (the throughput tier)
    # ------------------------------------------------------------------

    def make_infer_step(self):
        """The layer-wise full-graph inference sweep: layer l for ALL
        vertices before layer l+1, each through the family's exchange.
        Layer-0 rows arrive as an argument, so the sweep reads the live
        FeatureStore."""
        if self._infer_step is not None:
            return self._infer_step
        cl = self._consts
        L = len(self.dims) - 1
        model = self.cfg.model

        @torch.no_grad()
        def istep(params, X):
            H = X
            for l, p_l in enumerate(params["layers"]):
                nbr = self.backend.aggregate(H, cl)
                H = self._combine(model, p_l, nbr, H, last=(l == L - 1))
            return H

        self._infer_step = istep
        return istep

    def infer_full_graph(self, *, params: Dict, reference: bool = False
                         ) -> torch.Tensor:
        """Owner-partitioned final-layer embeddings for EVERY vertex, [Vp, C]
        on the engine's device (`global_embeddings` maps them back to the
        original vertex ids).  One call = one O(L) layer-wise sweep; its
        wire bytes accrue into CommStats.inference_bytes.

        `reference=True` runs the independent single-device oracle instead
        (no bytes accrue)."""
        X = self.store.device_table()
        if reference:
            layer_ref = self._make_reference_layer()
            L = len(self.dims) - 1
            with torch.no_grad():
                H = X
                for l, p_l in enumerate(params["layers"]):
                    H = layer_ref(p_l, H, last=(l == L - 1))
            return H
        out = self.make_infer_step()(params, X)
        self.comm_stats.inference_bytes += self.inference_bytes_per_sweep()
        return out

    def inference_bytes_per_sweep(self) -> int:
        """Wire bytes of one layer-wise sweep: the layout's per-step wire
        fields summed (a sweep runs the same L exchange passes a training
        forward runs)."""
        return int(sum(self._wire_fields.values()))

    def global_embeddings(self, H) -> np.ndarray:
        """Map owner-partitioned padded embeddings [Vp, D] back to the
        ORIGINAL vertex ids, [V, D], on the host."""
        if isinstance(H, torch.Tensor):
            H = H.cpu().numpy()
        return self.playout.global_embeddings(np.asarray(H))
