"""DistGNNEngine (the port's counterpart of `repro/core/engine.py`): the
synchronous full-graph training step and the layer-wise full-graph inference
sweep, one process per rank over `torch.distributed`.

The engine builds the partition family's layout (`partition/layout_api.py`)
whole on the host, identically on every rank, moves this rank's block of the
ELL constants and of the feature plane onto its device once, and runs each
layer through the family's ExchangeBackend (`execution/exchange_api.py`).
gcn, sage, gin: exchange (chunked; over the process group an all_gather
under broadcast, the bucketed all_to_all halo installments under p2p),
masked ELL multiply through the hand-written CUDA kernel, degree
normalization, then the model's dense combine with the rank's own rows; the
ring instead rotates the blocks past every rank and multiplies each round
over the block it holds.  gat: the fused [a_src.Hw | Hw] exchange, the
masked segment-softmax and the attention-weighted ELL sum (`ell_attend`);
the ring runs a one-pass online softmax over the rotating blocks.  The
training step (`make_step`) runs the same forward under autograd, so every
gather's backward is a CUDA kernel over a CSR transpose plan built once here
(the transpose, ell_attend's dw, the slot transpose; one plan per source
block under the ring), every all_gather's backward a reduce-scatter, every
all_to_all's the reverse all_to_all and every rotation's the reverse
rotation; under a historical-embedding protocol each layer's output passes
through `protocols.block_refresh` with this rank's boundary rows; the loss
numerator, the rows pushed and the gradients are then summed over the ranks
in one all_reduce.  `make_reference_step` and
`infer_full_graph(reference=True)` run an independent plain-PyTorch gather
over the whole padded space on every rank, with no collective (gat's edge
logits through the SDDMM kernel, as the reference's do): the oracle every
step and sweep is held to.

The replica families (vertex_cut, hybrid) run the same layers through
`ReplicaSyncBackend`: the owned-edge partial ELL over [own slots | halo
rows | zero] (the halo: hybrid only), the replica-sync combine over the
collective the execution model names (an all_gather and the ELL over
``rep_ids``, k - 1 rotations, or p2p's two sets of all_to_all installments
around the masters' ELL over ``gather_ids``), then / the global degree; gat
adds a detached max combine of the floored local maxima before the one sum
combine of [ell_attend | sum of the weights].  Their reference layer
scatter-adds every replica's partial into the global vertex space
(`replica_sync.reference_combine`, `reference_combine_max` for gat's
stabilizer) and gathers back.  The loss weights live on the master slots.

The sampled mini-batch path (batching node_wise, layer_wise, subgraph; the
edge-cut family): every rank samples and extracts the whole padded batch
on the host (`sampling/host_batch.py`, deterministic in (seed, step,
rank)) and uploads its own slice; `_fetch_frontier` reads the frontier's
input features under no gradient, the resident cache's rows plus the
misses through the execution model (an all_gather a feature chunk under
broadcast; under p2p the bucketed all_to_all of the batch's send rows, a
chunk and an installment at a time, each installment's gather the ELL
forward kernel at K = 1; exactly k - 1 rotations of the ring); then the
model runs over the dense padded blocks (`models/gnn.py`
`padded_minibatch_forward`, fp32 products) under autograd, and the loss
numerator, the loss weights and the gradients are summed over the ranks
in one all_reduce.  `make_reference_minibatch_step` runs every rank's
block of the same batch on every rank, features read straight from the
global table, with no collective.  `run_epoch_minibatch` drives the §6.1
schedules: the blocking ones stage by stage, and ``pipelined`` with a
producer lane beside the trainer's, a `PrefetchWorker` thread or a
persistent pool of sampling processes writing finished batches into a
shared-memory ring (`sampling/proc_prefetch.py`); the trainer dispatches
each step without waiting for the card and synchronizes once at the end
of the epoch, bitwise equal to the blocking epoch.

Ported: models gcn, sage, gat and gin, partition families edge_cut (every
partitioner), vertex_cut (random, cartesian2d, libra) and hybrid (any
hub_threshold, over any partitioner), execution p2p (the default, as in
the reference), broadcast and ring, batching full_graph, node_wise,
layer_wise and subgraph (edge cut; the replica families refuse mini-batch
with a ValueError, as the reference does), the static feature cache
policies, the conventional, factored, operator_parallel and pipelined
schedules (prefetch thread or sampling-process pool), protocols sync,
epoch_fixed, epoch_adaptive and variation (full graph), trainable
features (sync), on any number of ranks.  The ranks are the process
group's (`execution/collectives.py`); without one the engine runs on one
rank.

Telemetry (`core/telemetry.py`, off until `enable_telemetry`): spans wrap
the host-side stage boundaries (``sample`` with a ``sample_device`` span a
rank, ``extract``, ``train``, ``infer_sweep``, the pipelined epoch's
``finalize``) and never wait for the card; every CommStats change is
mirrored into ``comm.<field>`` counters and an instant ``exchange`` span
carrying the wire bytes (`_account_exchange`), labeled with the device
whose batch paid them.  Every rank applies every rank's deltas, so each
rank's registry equals the reference's single-host one.  The layout seeds
its per-device gauges, the extract stage records each rank's
``frontier_occupancy`` and the store's overlay hits and misses, and each
step appends a `log_step` record.

Trainable features (``trainable_features``): the layer-0 rows are learnable
embeddings.  The state holds a copy of this rank's store rows (``embed``)
and their row-sparse AdamW moments and per-row counts; the store itself
changes only at `publish_embeddings`.  The full-graph step differentiates
the numerator with respect to ``embed`` too, so layer 0's gathers and
exchanges now run their backward (the transpose kernel over each plan,
the reduce-scatter, the reverse all_to_all or rotation); the gradient
arrives summed over the ranks that read each row and `_embed_update_full`
updates the touched rows (every real row; the masters under the replica
families, whose gradient and delta pass through the backend's
`combine_rows`).  The mini-batch step moves the fetch inside the gradient
(`_fetch_live`): the live overlay refresh and every fetch gather a K = 1
ELL over plans built when the batch is taken in, then `sparse_adamw_ids`
over the batch's touched rows.  No gradient scatter uses float atomics.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.execution import collectives
from repro_torch.core.execution.bucketing import (
    bucketed_cap_widths,
    bucketed_send_mask,
)
from repro_torch.core.execution.exchange_api import make_backend
from repro_torch.core.execution.minibatch_pipeline import (
    SCHEDULES,
    run_pipelined,
    run_pipelined_process,
)
from repro_torch.core.execution.pipeline_exchange import (
    bucketed_all_to_all,
    chunked_overlap,
    ring_blocks,
    send_installments,
    single_slot,
    zero_pad_row,
)
from repro_torch.core.execution.replica_sync import (
    reference_combine,
    reference_combine_max,
)
from repro_torch.core.feature_store import overlay_refresh_plan
from repro_torch.core.graph import Graph
from repro_torch.core.models.gnn import (
    PARAM_KEYS,
    accuracy,
    init_gnn_params,
    padded_minibatch_forward,
    softmax_xent,
)
from repro_torch.core.partition.edge_cut import Partition
from repro_torch.core.partition.layout_api import get_layout_builder
from repro_torch.core.protocols.async_hist import block_refresh
from repro_torch.core.sampling.cache import CACHE_POLICIES, device_cache_ids
from repro_torch.core.sampling.distributed import CommStats
from repro_torch.core.sampling.host_batch import HostBatchBuilder
from repro_torch.core.sampling.partition_batch import p2p_frontier_halo_cap
from repro_torch.core.sampling.proc_prefetch import (
    ProcPrefetchPool,
    share_graph,
)
from repro_torch.core.sampling.samplers import frontier_caps
from repro_torch.core.telemetry import Telemetry
from repro_torch.kernels.ops import (
    ell_attend,
    ell_spmm,
    ell_transpose_plan,
    sddmm_ell,
)
from repro_torch.optim.sparse_optim import row_adamw_update, sparse_adamw_ids

EXECUTION_MODELS = ("broadcast", "ring", "p2p")
GNN_MODELS = ("gcn", "sage", "gat", "gin")
PROTOCOLS = ("sync", "epoch_fixed", "epoch_adaptive", "variation")
BATCHING_MODES = ("full_graph", "node_wise", "layer_wise", "subgraph")
PARTITION_FAMILIES = ("edge_cut", "vertex_cut", "hybrid")
PREFETCH_MODES = ("thread", "process")
ENGINE_CACHE_POLICIES = ("none",) + tuple(CACHE_POLICIES)

# layout attributes the engine mirrors, so callers keep reading eng.<attr>
ENGINE_MIRROR_ATTRS = ("nb", "Vp", "K", "ids_global", "store", "y",
                       "train_w", "test_w", "emb_touched")
# the trainable embedding table and its row-sparse AdamW state in a state
EMBED_KEYS = ("embed", "emb_m", "emb_v", "emb_t")


@dataclasses.dataclass
class EngineConfig:
    execution: str = "p2p"  # broadcast | ring | p2p
    protocol: str = "sync"  # sync | epoch_fixed | epoch_adaptive | variation
    model: str = "gcn"  # gcn | sage | gat | gin — the GNN layer program
    partition_family: str = "edge_cut"  # edge_cut | vertex_cut | hybrid
    partitioner: str = "metis_like"  # edge_cut/hybrid: any key of PARTITIONERS
    vertex_cut: str = "cartesian2d"  # vertex_cut: any key of VERTEX_CUTS
    hub_threshold: Optional[float] = None  # hybrid: in-degree >= threshold
    #   replicates; None = the 95th percentile of the in-degree, inf = pure
    #   edge-cut dataflow, 0 = pure (src-replicating) vertex cut
    sorted_masters: bool = False  # vertex_cut: master slots first per rank
    batching: str = "full_graph"  # full_graph | node_wise | layer_wise | subgraph
    batch_size: int = 16  # per-rank targets (node/layer-wise) or walk roots
    fanouts: Tuple[int, ...] = (4, 4)  # node_wise, target layer first;
    #   len == num_layers
    layer_sizes: Tuple[int, ...] = (32, 32)  # layer_wise; len == num_layers
    walk_length: int = 4  # subgraph random walk
    cache_policy: str = "none"  # none | any key of sampling CACHE_POLICIES
    cache_capacity: int = 0  # remote feature rows resident per rank
    exchange_chunks: int = 1  # feature-dim chunks of the exchange
    p2p_buckets: int = 1  # power-of-two installments splitting the p2p
    #   all_to_all send caps (1 = single max-pairwise-need buffer); the
    #   full-graph halo plan and the mini-batch frontier fetch alike
    prefetch_depth: int = 2  # batches the pipelined epoch builds ahead
    prefetch_mode: str = "thread"  # thread | process: who runs the
    #   pipelined producer.  "thread": the in-process `PrefetchWorker`
    #   (its overlap limited by the GIL).  "process": a `ProcPrefetchPool`
    #   of sampling processes feeding a shared-memory batch ring
    #   (sampling/proc_prefetch.py), bitwise equal all the same
    num_sample_workers: int = 2  # process-pool size for prefetch_mode=process
    trainable_features: bool = False  # layer-0 rows are LEARNABLE
    #   embeddings: the rank's store rows move into the state and a
    #   row-sparse AdamW (optim/sparse_optim.py) updates only the rows the
    #   step touched: every real owned row under full_graph (the master
    #   slots under the replica families, whose deltas are re-broadcast
    #   through the replica sync so copies never drift), the frontier's
    #   rows under mini-batch.  Requires protocol='sync'
    embed_lr: float = 0.1  # the row-sparse AdamW of the embedding rows
    embed_b1: float = 0.9
    embed_b2: float = 0.999
    embed_eps: float = 1e-8
    embed_weight_decay: float = 0.0
    hidden: int = 32
    num_layers: int = 2
    lr: float = 0.5  # SGD step of the training step
    staleness: int = 2  # epoch_fixed / epoch_adaptive refresh period
    eps_v: float = 0.05  # variation: relative drift that forces a push
    hard_bound: int = 4  # variation: the most epochs a block stays stale
    seed: int = 0  # init_state's params generator


def _leaves(params: Dict, keys) -> List[torch.Tensor]:
    """The params as one flat list, layer by layer, ``keys`` in order."""
    return [p_l[key] for p_l in params["layers"] for key in keys]


def _from_leaves(leaves, keys) -> Dict:
    it = iter(leaves)
    return {"layers": [dict(zip(keys, group))
                       for group in zip(*[it] * len(keys))]}


class _SlotGather(torch.autograd.Function):
    """The reference's masked gather, sum_j mask[:, j] * table[ids[:, j]],
    one ELL slot at a time.  Its backward adds each unmasked slot's
    mask * ct into the table rows it read with index_add_.  Autograd's own
    rule for ``table[ids]`` would also scatter the masked slots, which all
    name the pad row, into one serial run per slot on the card."""

    @staticmethod
    def forward(ctx, ids, mask, table):
        ctx.save_for_backward(ids, mask)
        ctx.rows = table.shape[0]
        out = table.new_zeros((ids.shape[0], table.shape[1]))
        for j in range(ids.shape[1]):
            out += mask[:, j:j + 1] * table[ids[:, j]]
        return out

    @staticmethod
    def backward(ctx, ct):
        ids, mask = ctx.saved_tensors
        d_table = ct.new_zeros((ctx.rows, ct.shape[1]))
        for j in range(ids.shape[1]):
            (r,) = torch.nonzero(mask[:, j], as_tuple=True)
            d_table.index_add_(0, ids[r, j], mask[r, j, None] * ct[r])
        return None, None, d_table


class _SlotAttend(torch.autograd.Function):
    """The reference's attention-weighted gather,
    sum_j pw[:, j] * table[ids[:, j]], one ELL slot at a time, with the
    gradient to both the weights and the table slot by slot: d_pw[:, j] =
    ct . table[ids[:, j]], and each unmasked slot's pw * ct index_add_-ed
    into the table rows it read (pw vanishes on masked slots).  One slot at
    a time keeps the gathered block at [V, D]; the [V, K, D] block at the
    gcn-paper shape would be 40 GB."""

    @staticmethod
    def forward(ctx, ids, mask, pw, table):
        ctx.save_for_backward(ids, mask, pw, table)
        out = table.new_zeros((ids.shape[0], table.shape[1]))
        for j in range(ids.shape[1]):
            out += pw[:, j:j + 1] * table[ids[:, j]]
        return out

    @staticmethod
    def backward(ctx, ct):
        ids, mask, pw, table = ctx.saved_tensors
        d_pw = torch.empty_like(pw)
        d_table = torch.zeros_like(table)
        for j in range(ids.shape[1]):
            d_pw[:, j] = (ct * table[ids[:, j]]).sum(1)
            (r,) = torch.nonzero(mask[:, j], as_tuple=True)
            d_table.index_add_(0, ids[r, j], pw[r, j, None] * ct[r])
        return None, None, d_pw, d_table


class DistGNNEngine:
    """Builds the device layout + exchange plan from (graph, config) and
    exposes the full-graph training step, the layer-wise inference sweep and
    their single-device oracles.

    ``device`` is where the step and the sweep run: "cuda" by default, and
    the constructor raises when CUDA is missing unless the caller asks for
    "cpu" (where the ELL multiply and its gradient take the kernels' plain
    versions).  The ranks are the process group's, one engine per rank
    (`collectives.init_group`, before the engine is built); a
    ``partition`` must have as many parts."""

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
        if cfg.protocol not in PROTOCOLS:
            raise ValueError(f"protocol must be one of {PROTOCOLS}")
        if cfg.cache_policy not in ENGINE_CACHE_POLICIES:
            raise ValueError(
                f"cache_policy must be one of {ENGINE_CACHE_POLICIES}")
        if cfg.batching != "full_graph" and cfg.protocol != "sync":
            raise ValueError(
                "mini-batch training supports protocol='sync' only: the "
                "historical-embedding protocols are full-graph state")
        if cfg.trainable_features and cfg.protocol != "sync":
            raise ValueError(
                "trainable_features requires protocol='sync': the "
                "historical-embedding protocols cache layer outputs of a "
                "FROZEN layer-0 table")
        if cfg.exchange_chunks < 1:
            raise ValueError("exchange_chunks must be >= 1")
        if cfg.p2p_buckets < 1:
            raise ValueError("p2p_buckets must be >= 1")
        if cfg.prefetch_depth < 1:
            raise ValueError("prefetch_depth must be >= 1")
        if cfg.prefetch_mode not in PREFETCH_MODES:
            raise ValueError("prefetch_mode must be 'thread' or 'process'")
        if cfg.num_sample_workers < 1:
            raise ValueError("num_sample_workers must be >= 1")
        builder = get_layout_builder(cfg.partition_family)
        builder.validate(cfg, partition=partition)
        self.k = collectives.world_size()
        if partition is not None and partition.num_parts != self.k:
            raise ValueError(
                f"the partition has {partition.num_parts} parts and the "
                f"process group {self.k} rank(s): they must be equal")
        self.rank = collectives.rank()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DistGNNEngine runs on the card (device='cuda') and CUDA is "
                "not available; pass device='cpu' to run on the CPU")
        # the step and the sweep are held to the fp32 reference: no TF32 in
        # the matmuls
        torch.backends.cuda.matmul.allow_tf32 = False
        self.g = g
        lay = self.playout = builder(g, self.k, cfg, partition=partition,
                                     device=self.device, rank=self.rank)
        for name in ENGINE_MIRROR_ATTRS:
            setattr(self, name, getattr(lay, name))
        # this rank's part of every table the layer reads: the rows
        # [r*nb, (r+1)*nb) of a per-row table, entry r of a table whose
        # leading axis is the rank (the layout's squeeze_keys: the
        # edge-cut ring's [k(dev), k(src), nb, K] ids and mask, the p2p
        # send tables, the replica ring's ring_ids, the hybrid halo tables)
        own = slice(self.rank * self.nb, (self.rank + 1) * self.nb)

        def upload(a, at=own):
            return torch.from_numpy(np.ascontiguousarray(a[at])).to(
                self.device)
        self._consts = {key: upload(a, self.rank if key in lay.squeeze_keys
                                    else own)
                        for key, a in lay.exchange_consts().items()}
        self._consts.update(deg=upload(lay.deg), y=upload(lay.y).long(),
                            train_w=upload(lay.train_w),
                            test_w=upload(lay.test_w))
        # the family's device constants: the transpose plans of every ELL
        # table and single-slot gather, and the send installments, built
        # once and read by every layer, chunk, round and step
        self.backend = make_backend(self)
        self._consts.update(self.backend.device_consts(self._consts))
        if cfg.protocol != "sync":
            # this rank's boundary rows: the rows another rank reads
            self._consts["bmask"] = upload(lay.bmask)
        if cfg.trainable_features and cfg.batching == "full_graph":
            # the full-graph touched set: this rank's real rows (its master
            # slots under the replica families)
            self._consts["emb_touched"] = upload(lay.emb_touched)
        # the loss's denominator, max(sum of every rank's weights, 1)
        w_sum = self._consts["train_w"].sum()
        if collectives.group_active():
            (w_sum,) = collectives.all_reduce_flat([w_sum])
        self._den = torch.clamp(w_sum, min=1.0)
        self._global = None  # the whole layout's tables: `_global_consts`
        num_classes = int(g.labels.max()) + 1
        self.dims = ([g.features.shape[1]]
                     + [cfg.hidden] * (cfg.num_layers - 1) + [num_classes])
        self._wire_fields = lay.wire_fields_per_step(cfg.model, self.dims)
        if cfg.trainable_features and cfg.batching == "full_graph":
            # the layer-0 gradients' way home, a step (the reverse of one
            # exchange pass at width dims[0]):
            # cost_models.embedding_grad_bytes_per_step
            self._emb_bytes_per_step = lay.embed_grad_bytes(self.dims)
        self._infer_step = None
        self._step = None
        self._ref_step = None
        self._mb_step = None
        self._mb_ref_step = None
        self._proc_pool = None  # the sampling processes: _ensure_proc_pool
        self._proc_pool_key = None
        self.comm_stats = CommStats()
        # off by default: no-op spans and metrics until enable_telemetry()
        self.telemetry = Telemetry(enabled=False)
        if cfg.batching != "full_graph":
            self._build_minibatch_plan()

    # ------------------------------------------------------------------
    # shared layer math
    # ------------------------------------------------------------------

    def _ell(self, ids, mask, table, plan=None):
        """sum_k mask[v,k] * table[ids[v,k]]: the CUDA ELL kernel on the
        card (its backward the transpose kernel over ``plan``), its plain
        version on the CPU."""
        return ell_spmm(ids, mask, table, normalize=False, plan=plan)

    def _ell_attend(self, ids, w, table, plan=None):
        """sum_k w[v,k] * table[ids[v,k]] with gradients to both w and the
        table: the GAT aggregation (the forward kernel with the weights in
        the mask lane; backward the transpose kernel over ``plan`` and the
        dw kernel), plain versions on the CPU."""
        return ell_attend(ids, w, table, plan=plan)

    def _sddmm(self, ids, mask, table, a_src, a_dst, plan=None):
        """Masked GAT edge logits over the ELL structure (the CUDA SDDMM
        kernel, its plain version on the CPU); dst row v must be table row v
        (prefix contract)."""
        return sddmm_ell(ids, mask, table, a_src, a_dst, plan=plan)

    @staticmethod
    def _gat_softmax(e_masked):
        """Masked segment-softmax pieces over ELL slots: (weights, den) from
        logits already masked to -1e30.  Rows with no real slots get
        den == 0 (the caller falls back to the self row).  The stabilizer
        carries no gradient: softmax is shift-invariant, so treating it as a
        constant gives the exact gradient."""
        m = torch.amax(e_masked, dim=1, keepdim=True).detach()
        pw = torch.exp(e_masked - m) * (e_masked > -1e29)
        return pw, pw.sum(1, keepdim=True)

    @staticmethod
    def _combine(model, p_l, nbr, h_self, last: bool):
        """Model-specific combine of the aggregated neighbor rows with the
        RESIDENT self rows, shared by the sweep and the oracle (gat has its
        own program: the aggregation itself is attention-weighted).  sage
        and gin read h_self from the rank's own rows, so they exchange no
        more bytes than gcn."""
        if model == "gcn":
            z = (nbr + h_self) @ p_l["w"] + p_l["b"]
        elif model == "sage":
            z = h_self @ p_l["w_self"] + nbr @ p_l["w_nbr"] + p_l["b"]
        elif model == "gin":
            z = torch.relu(
                ((1.0 + p_l["eps"]) * h_self + nbr) @ p_l["w1"]) @ p_l["w2"]
        else:
            raise ValueError(model)
        return z if last else torch.relu(z)

    def _layer(self, p_l, H, cl, last: bool):
        """One model-aware layer of the distributed forward: gat runs the
        backend's attention program; gcn, sage and gin the backend's
        exchange-aggregate and the shared combine."""
        if self.cfg.model == "gat":
            return self.backend.gat_layer(p_l, H, cl, last)
        nbr = self.backend.aggregate(H, cl)
        return self._combine(self.cfg.model, p_l, nbr, H, last)

    def _protocol_kwargs(self) -> Dict:
        c = self.cfg
        return dict(staleness=c.staleness, eps=c.eps_v,
                    hard_bound=c.hard_bound)

    def _forward(self, params, X, hist=None, age=None, step: int = 0):
        """The distributed forward, every layer through `_layer`: returns
        (logits, new history, new ages, rows pushed as a float32 tensor).
        With this rank's history ``hist`` (one [nb, d] block a layer) and
        ages ``age`` [L], each layer's output passes through `block_refresh`
        with this rank's boundary rows and part id (the reference's
        `_forward_local`), and the new history comes back detached; without
        them (sync, the sweep) the history and ages come back None and the
        rows pushed 0."""
        cl = self._consts
        L = len(self.dims) - 1
        H = X
        new_hist, new_age = [], []
        pushed = torch.zeros((), dtype=torch.float32, device=X.device)
        for l, p_l in enumerate(params["layers"]):
            H = self._layer(p_l, H, cl, last=(l == L - 1))
            if hist is not None:
                H, h2, a2, rows = block_refresh(
                    self.cfg.protocol, hist[l], H, age[l], step,
                    cl["bmask"], self.rank, **self._protocol_kwargs())
                new_hist.append(h2.detach())
                new_age.append(a2)
                pushed = pushed + rows.to(torch.float32)
        if hist is None:
            return H, None, None, pushed
        return H, tuple(new_hist), torch.stack(new_age), pushed

    def _global_consts(self) -> Dict:
        """The whole layout's per-vertex tables on the device, which the
        single-device oracle and `accuracy` read: on one rank the engine's
        own; on more, uploaded from the host layout at the first call."""
        if self._global is None:
            keys = ("mask", "deg", "y", "train_w", "test_w")
            if self.cfg.protocol != "sync":
                keys += ("bmask",)
            lay = self.playout
            self._global = {}
            for key in keys:
                # on one rank the engine's own rows are every row (the
                # edge-cut ring's mask is per source block: upload the
                # global one)
                if self.k == 1 and key in self._consts \
                        and key not in lay.squeeze_keys:
                    self._global[key] = self._consts[key]
                else:
                    self._global[key] = torch.from_numpy(
                        getattr(lay, key)).to(self.device)
            self._global["y"] = self._global["y"].long()
        return self._global

    def _global_features(self) -> torch.Tensor:
        """The whole feature plane [Vp, D] on the device, live: on one rank
        the store's own table; on more, the store's host copy uploaded."""
        if self.k == 1:
            return self.store.device_table()
        return torch.from_numpy(self.store.flat()).to(self.device)

    def _make_reference_layer(self):
        """Single-device reference layer over the whole padded [Vp] space,
        run by every rank with no collective: a plain slot-by-slot gather of
        the global ELL table and its slot-by-slot scatter-add gradient
        (`_SlotGather`, written apart from the kernels, their plain versions
        and the transpose plan, so it checks all three).  gat: the edge
        logits through `_sddmm` (the SDDMM kernel and its slot-transpose
        gradient, as the reference calls its Pallas SDDMM), the softmax, and
        the plain slot-by-slot attention gather `_SlotAttend` (so it checks
        the forward, transpose and dw kernels).

        Replica families: the same gathers over the flattened replica
        space give each replica's partial; `reference_combine` scatter-adds
        them into the global vertex space and gathers back (gat: the local
        maxima floored at 0 and combined by `reference_combine_max`, then
        [attend | sum of the weights] combined in one pass)."""
        c = self.cfg
        k, nb, Vp = self.k, self.nb, self.Vp
        ids_g = torch.from_numpy(self.ids_global).to(self.device)
        ids_g32 = ids_g.int()
        gl = self._global_consts()
        mask, deg = gl["mask"], gl["deg"]
        # the SDDMM gradient's transpose plan: on one rank, where the
        # engine's own ELL table is the global one (broadcast, and every
        # replica layout), the engine's; otherwise `sddmm_ell` builds its
        # own
        plan = (self._consts["plan"] if self.k == 1 and (
            c.execution == "broadcast" or c.partition_family != "edge_cut")
            else None)
        replicas = self.playout.ref_vert_ids is not None
        if replicas:
            vids = torch.from_numpy(self.playout.ref_vert_ids).to(self.device)
            V = self.g.num_vertices

            def combine(x, op=reference_combine):
                return op(x.view(k, nb, -1), vids, V).reshape(Vp, -1)

        def gat_layer_ref(p_l, H, last):
            Hw = H @ p_l["w"]
            table = torch.cat([Hw, Hw.new_zeros((1, Hw.shape[1]))], 0)
            e = self._sddmm(ids_g32, mask, table, p_l["a_src"], p_l["a_dst"],
                            plan)
            if replicas:
                M = combine(torch.clamp(torch.amax(e, dim=1, keepdim=True),
                                        min=0.0).detach(),
                            reference_combine_max)
                pw = torch.exp(e - M) * (e > -1e29)
                comb = combine(torch.cat([
                    _SlotAttend.apply(ids_g, mask, pw, table),
                    pw.sum(1, keepdim=True)], 1))
                num, den = comb[:, :-1], comb[:, -1:]
            else:
                pw, den = self._gat_softmax(e)
                num = _SlotAttend.apply(ids_g, mask, pw, table)
            z = torch.where(den > 0, num / torch.clamp(den, min=1e-30), Hw)
            return z if last else torch.relu(z)

        def layer_ref(p_l, H, last):
            if c.model == "gat":
                return gat_layer_ref(p_l, H, last)
            table = torch.cat([H, H.new_zeros((1, H.shape[1]))], 0)
            gathered = _SlotGather.apply(ids_g, mask, table)
            if replicas:
                gathered = combine(gathered)
            return self._combine(c.model, p_l, gathered / deg, H, last=last)

        return layer_ref

    # ------------------------------------------------------------------
    # state and the distributed training step
    # ------------------------------------------------------------------

    def init_state(self, params: Optional[Dict] = None, *,
                   reference: bool = False) -> Dict:
        """The training state: ``{params, step}``, and under a
        historical-embedding protocol the all-zero history ``hist`` (one
        tensor a layer, of the layer's output width) and the ages ``age``
        (int32).  The distributed step's state holds this rank's rows: hist
        [nb, d] a layer and age [L], this rank's ages.  ``reference=True``
        gives the state `make_reference_step` reads: every row, hist [Vp, d]
        a layer and age [L, k], block b's ages in column b.  Under sync
        there is no history (at the gcn-paper width it would be 2.4 GB of
        zeros that nothing reads).  Without ``params``, draws them with
        `init_gnn_params` from a generator seeded with ``cfg.seed``; with
        them, starts from those weights (a carry-over).  With trainable
        features the state also holds the embedding table and its row-sparse
        AdamW moments (`_embed_state`): this rank's rows, every row with
        ``reference``."""
        if params is None:
            params = init_gnn_params(
                self.cfg.model, self.dims,
                torch.Generator().manual_seed(self.cfg.seed), self.device)
        state = dict(params=params, step=0)
        if self.cfg.trainable_features:
            state.update(self._embed_state(reference))
        if self.cfg.protocol != "sync":
            rows = self.Vp if reference else self.nb
            L = len(self.dims) - 1
            state["hist"] = tuple(
                torch.zeros((rows, d), dtype=torch.float32, device=self.device)
                for d in self.dims[1:])
            state["age"] = torch.zeros((L, self.k) if reference else (L,),
                                       dtype=torch.int32, device=self.device)
        return state

    def _embed_state(self, reference: bool = False) -> Dict:
        """The trainable embedding table and its row-sparse AdamW state: a
        COPY of this rank's store rows (every row with ``reference``; never
        an alias, so training leaves the store as it is until
        `publish_embeddings`), zero moments ``emb_m``, ``emb_v`` and zero
        int32 per-row update counts ``emb_t``."""
        X = (self._global_features() if reference
             else self.store.device_table())
        embed = X.clone()
        return dict(embed=embed, emb_m=torch.zeros_like(embed),
                    emb_v=torch.zeros_like(embed),
                    emb_t=torch.zeros(embed.shape[0], dtype=torch.int32,
                                      device=embed.device))

    def _embed_hparams(self) -> Dict:
        c = self.cfg
        return dict(lr=c.embed_lr, b1=c.embed_b1, b2=c.embed_b2,
                    eps=c.embed_eps, weight_decay=c.embed_weight_decay)

    def _embed_update_full(self, state, g_emb) -> Dict:
        """The full-graph row-sparse AdamW update of this rank's rows:
        masked-dense over the static touched set (every real row; the
        master slots under the replica families), which leaves the pad rows
        and the non-masters bitwise unchanged.  Under a replica family
        ``g_emb`` holds each replica's PARTIAL gradient: the backend's
        `combine_rows` sums it into the vertex's gradient, the update
        applies at the masters (whose moments are the vertex's), and the
        masters' deltas go back to every replica through the same combine,
        a sum with one nonzero term, so every replica adds the same delta
        bit for bit and the copies never drift."""
        cl, backend = self._consts, self.backend
        emb, touched = state["embed"], cl["emb_touched"]
        g_emb = backend.combine_rows(g_emb, cl)
        emb2, m2, v2, t2 = row_adamw_update(
            emb, g_emb, state["emb_m"], state["emb_v"], state["emb_t"],
            touched, **self._embed_hparams())
        if backend.has_replicas:
            delta = (emb2 - emb) * touched[:, None]
            emb2 = emb + backend.combine_rows(delta, cl)
        return dict(embed=emb2, emb_m=m2, emb_v=v2, emb_t=t2)

    def make_step(self):
        """The training step: state -> (state, {"loss", "rows_pushed"},
        this rank's logits rows [nb, C]).  The rank's loss numerator
        sum((lse - ll) * w) is differentiated locally (each all_gather's
        backward reduce-scatters the other ranks' share of the tables'
        gradient to this rank); the numerator, the boundary rows this rank
        pushed into its history (0 under sync) and every gradient are then
        summed over the ranks in one flat all_reduce, in `PARAM_KEYS` order,
        and divided by den = max(sum of every rank's w, 1) outside the
        gradient, as in the reference.  Without a process group the sums
        are the local values.  SGD writes new tensors, so a state can be
        stepped twice.

        With trainable features the layer-0 rows are the state's ``embed``
        and the numerator is differentiated with respect to them too: their
        gradient arrives already summed over every rank that read a row
        (the exchange's reverse: the reduce-scatter, the reverse all_to_all
        or rotation, and the transpose kernel over each gather's plan), so
        it takes no all_reduce; divided by den it feeds
        `_embed_update_full`."""
        if self._step is not None:
            return self._step
        cl = self._consts
        lr = self.cfg.lr
        den = self._den
        keys = PARAM_KEYS[self.cfg.model]
        trainable = self.cfg.trainable_features

        def step(state):
            leaves = [p.detach().requires_grad_() for p in
                      _leaves(state["params"], keys)]
            X = (state["embed"].detach().requires_grad_() if trainable
                 else self.store.device_table())
            with torch.enable_grad():
                logits, hist, age, pushed = self._forward(
                    _from_leaves(leaves, keys), X,
                    state.get("hist"), state.get("age"), state["step"])
                lse = torch.logsumexp(logits, dim=-1)
                ll = torch.gather(logits, -1, cl["y"][:, None])[:, 0]
                num = ((lse - ll) * cl["train_w"]).sum()
                grads = list(torch.autograd.grad(
                    num, leaves + [X] if trainable else leaves))
            g_X = grads.pop() if trainable else None
            with torch.no_grad():
                if collectives.group_active():
                    num, pushed, *grads = collectives.all_reduce_flat(
                        [num.detach(), pushed, *grads])
                loss = num / den
                params2 = _from_leaves([p - lr * (g / den)
                                        for p, g in zip(leaves, grads)], keys)
                state2 = dict(params=params2, step=state["step"] + 1)
                if trainable:
                    state2.update(self._embed_update_full(state, g_X / den))
            if hist is not None:
                state2.update(hist=hist, age=age)
            return (state2, dict(loss=loss, rows_pushed=pushed),
                    logits.detach())

        self._step = step
        return step

    def make_reference_step(self):
        """The same loss and SGD on one device over the reference layer
        (`_make_reference_layer`) and the whole graph, differentiated by
        autograd through the plain gather: independent of the kernels,
        their plan and the collectives.  Under a historical-embedding
        protocol every layer's output passes through the same
        `block_refresh`, block by block over the whole history (the
        reference's vmap over the k blocks): its state is
        ``init_state(reference=True)``'s, hist [Vp, d] a layer and age
        [L, k] (`train(reference=True)` starts from one).  Returns the
        logits of every vertex, [Vp, C].  With trainable features the
        layer-0 rows are the state's whole [Vp, D] ``embed``, differentiated
        with the params; under a replica family their gradient and the
        masters' delta pass through `reference_combine`
        (`_ref_combine_rows`) before and after the row AdamW."""
        if self._ref_step is not None:
            return self._ref_step
        cl = self._global_consts()
        lr = self.cfg.lr
        layer_ref = self._make_reference_layer()
        L = len(self.dims) - 1
        keys = PARAM_KEYS[self.cfg.model]
        k, nb = self.k, self.nb
        hist_kept = self.cfg.protocol != "sync"
        trainable = self.cfg.trainable_features
        if trainable:
            touched = torch.from_numpy(self.emb_touched).to(self.device)
            combine = (self._ref_combine_rows() if self.backend.has_replicas
                       else None)

        def embed_update(state, g_X):
            emb = state["embed"]
            if combine is not None:
                g_X = combine(g_X)
            emb2, m2, v2, t2 = row_adamw_update(
                emb, g_X, state["emb_m"], state["emb_v"], state["emb_t"],
                touched, **self._embed_hparams())
            if combine is not None:
                emb2 = emb + combine((emb2 - emb) * touched[:, None])
            return dict(embed=emb2, emb_m=m2, emb_v=v2, emb_t=t2)

        def refresh(H, hist_l, age_l, step_i):
            """block_refresh over each of the k blocks of H [Vp, d]."""
            outs = [block_refresh(
                self.cfg.protocol, hist_l[b * nb:(b + 1) * nb],
                H[b * nb:(b + 1) * nb], age_l[b], step_i,
                cl["bmask"][b * nb:(b + 1) * nb], b,
                **self._protocol_kwargs()) for b in range(k)]
            h_used, h2, a2, rows = zip(*outs)
            return (torch.cat(h_used, 0), torch.cat(h2, 0).detach(),
                    torch.stack(a2), sum(r.to(torch.float32) for r in rows))

        def ref_step(state):
            leaves = [p.detach().requires_grad_() for p in
                      _leaves(state["params"], keys)]
            new_hist, new_age = [], []
            pushed = torch.zeros((), dtype=torch.float32, device=self.device)
            with torch.enable_grad():
                H = X = (state["embed"].detach().requires_grad_() if trainable
                         else self._global_features())
                for l, p_l in enumerate(_from_leaves(leaves, keys)["layers"]):
                    H = layer_ref(p_l, H, last=(l == L - 1))
                    if hist_kept:
                        H, h2, a2, rows = refresh(
                            H, state["hist"][l], state["age"][l],
                            state["step"])
                        new_hist.append(h2)
                        new_age.append(a2)
                        pushed = pushed + rows
                loss = softmax_xent(H, cl["y"], cl["train_w"])
                grads = list(torch.autograd.grad(
                    loss, leaves + [X] if trainable else leaves))
            g_X = grads.pop() if trainable else None
            with torch.no_grad():
                params2 = _from_leaves([p - lr * g
                                        for p, g in zip(leaves, grads)], keys)
                state2 = dict(params=params2, step=state["step"] + 1)
                if trainable:
                    state2.update(embed_update(state, g_X))
            if hist_kept:
                state2.update(hist=tuple(new_hist), age=torch.stack(new_age))
            return (state2, dict(loss=loss.detach(), rows_pushed=pushed),
                    H.detach())

        self._ref_step = ref_step
        return ref_step

    def _ref_combine_rows(self):
        """The oracle's replica combine of per-slot rows [Vp, D] in the
        flattened replica space (`reference_combine`): the counterpart of
        `ReplicaSyncBackend.combine_rows` in `_embed_update_full`."""
        k, nb, Vp = self.k, self.nb, self.Vp
        vids = torch.from_numpy(self.playout.ref_vert_ids).to(self.device)
        V = self.g.num_vertices

        def combine(rows):
            return reference_combine(rows.reshape(k, nb, -1), vids,
                                     V).reshape(Vp, -1)
        return combine

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

        @torch.no_grad()
        def istep(params, X):
            return self._forward(params, X)[0]

        self._infer_step = istep
        return istep

    def _layer0_table(self, state=None, whole: bool = False
                      ) -> torch.Tensor:
        """The layer-0 rows inference reads: with trainable features the
        ``embed`` table of the train ``state``, else a live read of the
        FeatureStore (rows written by `store.update_rows` or
        `publish_embeddings` show in the next sweep).  This rank's rows, or
        with ``whole`` every row (the reference sweep; a distributed state's
        rows are then gathered from every rank)."""
        if not self.cfg.trainable_features:
            return (self._global_features() if whole
                    else self.store.device_table())
        if state is None or "embed" not in state:
            raise ValueError(
                "trainable_features: inference reads the layer-0 rows from "
                "the train state's embed table: pass state=")
        emb = state["embed"]
        if whole and emb.shape[0] != self.Vp:
            return self.gather_rows(emb)
        if not whole and emb.shape[0] != self.nb:
            return emb[self.rank * self.nb:(self.rank + 1) * self.nb]
        return emb

    def infer_full_graph(self, state=None, *, params: Optional[Dict] = None,
                         reference: bool = False) -> torch.Tensor:
        """Owner-partitioned final-layer embeddings for EVERY vertex, [Vp, C]
        on the engine's device, on every rank (`global_embeddings` maps them
        back to the original vertex ids).  One call = one O(L) layer-wise
        sweep over this rank's rows, then one all_gather of the last layer's
        rows (`gather_rows`, not counted as sweep traffic, as in the
        reference); the sweep's wire bytes accrue into
        CommStats.inference_bytes.  ``params`` default to the ``state``'s;
        with trainable features the layer-0 rows are the state's ``embed``
        (`_layer0_table`), so a state is needed.

        `reference=True` runs the independent single-device oracle instead
        (no bytes accrue)."""
        if params is None:
            if state is None or "params" not in state:
                raise ValueError("infer_full_graph needs params= or a train "
                                 "state with a 'params' entry")
            params = state["params"]
        X = self._layer0_table(state, whole=reference)
        if reference:
            layer_ref = self._make_reference_layer()
            L = len(self.dims) - 1
            with torch.no_grad():
                H = X
                for l, p_l in enumerate(params["layers"]):
                    H = layer_ref(p_l, H, last=(l == L - 1))
            return H
        with self.telemetry.span("infer_sweep"):
            out = self.make_infer_step()(params, X)
            with self._account_exchange("inference", None, None):
                self.comm_stats.inference_bytes += \
                    self.inference_bytes_per_sweep()
        return self.gather_rows(out)

    def publish_embeddings(self, state) -> None:
        """The serving handoff of trainable features: write the trained
        layer-0 rows (every rank's, gathered) into the FeatureStore and
        refresh an attached overlay snapshot, so an engine or a serving tier
        on this store, a frozen one too, reads the TRAINED table.  Host
        side, outside the step: training itself never writes the store."""
        emb = self._layer0_table(state, whole=True).detach().cpu().numpy()
        if emb.shape != (self.store.num_rows, self.store.dim):
            raise ValueError(f"embed table {emb.shape} != store "
                             f"{(self.store.num_rows, self.store.dim)}")
        self.store.update_rows(np.arange(self.store.num_rows), emb)
        if self.store._overlay_ids is not None:
            self.store.refresh_overlay()
            cache = torch.from_numpy(self.store.overlay_table()[self.rank])
            self._cache_table = torch.cat(
                [cache, zero_pad_row(cache)], 0).to(self.device)

    def gather_rows(self, H: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a per-vertex table, [Vp, D] on every rank,
        from this rank's [nb, D]: one all_gather over the process group
        (without one, the rank's rows are all of them)."""
        if not collectives.group_active():
            return H
        with torch.no_grad():
            return collectives.all_gather_rows(H.contiguous())()

    # ------------------------------------------------------------------
    # the sampled mini-batch path (§5 batch generation)
    # ------------------------------------------------------------------

    def _build_minibatch_plan(self):
        """Static mini-batch plan: the frontier caps of the sampler config
        (every batch's shapes), the p2p frontier halo cap and its
        installments, and the per-rank resident feature cache (remote hot
        rows a cache policy picks; exact, never stale, while the input
        features are frozen), then the host batch builder.  With trainable
        features a snapshot would go stale: the step re-gathers the overlay
        rows from the live owner shards through the static plan of
        `overlay_refresh_plan` (`_overlay_rows_live`), and the builder
        lists each batch's touched rows, at most ``tcap`` an owner."""
        c, g, k = self.cfg, self.g, self.k
        L = c.num_layers
        part, new_of_old = self.playout.part, self.playout.new_of_old
        self.caps = frontier_caps(
            c.batching, L, c.batch_size, fanouts=c.fanouts,
            layer_sizes=c.layer_sizes, walk_length=c.walk_length,
            num_vertices=g.num_vertices)
        # p2p halo slots per (dst, src) pair: bounded by the measured halo,
        # the largest single-owner share of any destination's hops-hop
        # in-neighborhood, not by the worst case caps[0]; row t of a pair's
        # need list lands in installment t // w at offset t % w, so the
        # installments' shapes never change across batches
        self.fcap, self.fcap_widths = self.caps[0], None
        if c.execution == "p2p":
            hops = c.walk_length if c.batching == "subgraph" else c.num_layers
            self.fcap = p2p_frontier_halo_cap(g, part, hops, self.caps[0])
            self.fcap_widths = bucketed_cap_widths(self.fcap, c.p2p_buckets)
        self.Ccap = Ccap = max(int(c.cache_capacity), 1)
        cache_ids = [device_cache_ids(g, part.assignment, d, c.cache_policy,
                                      c.cache_capacity) for d in range(k)]
        cache_slots = [{int(v): j for j, v in enumerate(ids_d)}
                       for ids_d in cache_ids]
        cache_sets = [frozenset(int(v) for v in ids_d) for ids_d in cache_ids]
        # the cache is a hot-row overlay on the feature store: a snapshot
        # of each rank's pinned remote rows; this rank keeps its own
        # [Ccap, D] table and a zero row (the misses' and pads' slot)
        overlay_sids = [new_of_old[ids_d].astype(np.int64)
                        for ids_d in cache_ids]
        self.store.attach_overlay(overlay_sids, Ccap)
        cache = torch.from_numpy(self.store.overlay_table()[self.rank])
        self._cache_table = torch.cat(
            [cache, zero_pad_row(cache)], 0).to(self.device)
        self._has_overlay = any(len(a) for a in overlay_sids)
        self.tcap = 0
        if c.trainable_features:
            if self._has_overlay:
                self._build_overlay_refresh(overlay_sids)
            # the touched rows of an owner: at most all of them, and at
            # most one per frontier slot of every rank
            self.tcap = min(self.nb, k * self.caps[0])
        self.host_builder = HostBatchBuilder(
            batching=c.batching, execution=c.execution, seed=c.seed,
            batch_size=c.batch_size, fanouts=tuple(c.fanouts),
            layer_sizes=tuple(c.layer_sizes), walk_length=c.walk_length,
            num_layers=L, k=k, nb=self.nb,
            caps=tuple(int(x) for x in self.caps), fcap=int(self.fcap),
            fcap_widths=(None if self.fcap_widths is None
                         else tuple(int(x) for x in self.fcap_widths)),
            Ccap=Ccap, feature_dim=g.features.shape[1],
            assignment=part.assignment, new_of_old=new_of_old,
            labels=np.asarray(g.labels),
            train_mask=(None if g.train_mask is None
                        else np.asarray(g.train_mask)),
            cache_slots=cache_slots, cache_sets=cache_sets, graph=g,
            trainable_features=c.trainable_features, tcap=int(self.tcap),
            overlay_rows=tuple(len(a) for a in cache_ids))

    def _build_overlay_refresh(self, overlay_sids) -> None:
        """The live overlay's device constants (trainable features): this
        rank's send installments of `overlay_refresh_plan` as K = 1 ELLs
        over its nb rows (pad entries masked: they ship zeros), and its
        overlay slots' ids into [own rows | received rows] as a K = 1 ELL
        (`single_slot`: the pads read 0), each with its transpose plan."""
        k, nb, r = self.k, self.nb, self.rank
        send, tab, widths = overlay_refresh_plan(
            overlay_sids, k, nb, self.Ccap, buckets=self.cfg.p2p_buckets)
        counts = np.zeros((k, k), np.int64)  # [owner, rank reading it]
        for d, a in enumerate(overlay_sids):
            counts[:, d] = np.bincount(a // nb, minlength=k)
        mask = bucketed_send_mask(counts, widths)
        self._ov_send = send_installments(self._upload(send[r]),
                                          self._upload(mask[r]), nb)
        rows = nb + len(widths) * k * widths[0]
        self._ov_tab = single_slot(self._upload(tab[r]), rows, rows)

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------

    def enable_telemetry(self, telemetry: Optional[Telemetry] = None
                         ) -> Telemetry:
        """Attach an ENABLED `core.telemetry.Telemetry` (or the one passed
        in) and return it.  Spans wrap the host-side stage boundaries only,
        nothing inside the step changes, and every CommStats change from
        here on is mirrored into labeled ``comm.*`` counters plus instant
        ``exchange`` spans carrying the wire-byte delta (their sum equals
        ``CommStats.total()`` exactly for a fresh run).  Also seeds the
        imbalance report with the layout's static per-device gauges and
        hands the instance to the FeatureStore's overlay counters.  A
        sampling-process pool built before keeps the telemetry it was
        built with."""
        tel = telemetry if telemetry is not None else Telemetry()
        self.telemetry = tel
        self.store.telemetry = tel
        if tel.enabled:
            self.playout.telemetry_gauges(tel)
        return tel

    @contextlib.contextmanager
    def _account_exchange(self, stage: str, step, device):
        """Mirror the CommStats deltas accrued inside this block into
        labeled ``comm.<field>`` counters and one instant ``exchange`` span
        whose ``bytes`` label is the WIRE delta (cache hits excluded): the
        invariant the trace contract asserts, summed exchange-span bytes ==
        ``CommStats.total()``."""
        tel = self.telemetry
        if not tel.enabled:
            yield
            return
        s = self.comm_stats
        before = dataclasses.asdict(s)
        wire0 = s.total()
        yield
        labels = {} if device is None else {"device": device}
        for name, v0 in before.items():
            dv = getattr(s, name) - v0
            if dv:
                tel.counter("comm." + name, **labels).add(dv)
        mark = dict(stage=stage, bytes=s.total() - wire0, **labels)
        if step is not None:
            mark["step"] = step
        tel.instant("exchange", **mark)

    def _sample_host(self, step_idx: int):
        """Host sampling stage (`HostBatchBuilder.sample`): every rank's
        MiniBatch, deterministic in (seed, step, rank), each rank's under a
        ``sample_device`` span."""
        return self.host_builder.sample(step_idx,
                                        span_factory=self.telemetry.span)

    def _make_batch(self, mbs, step=None) -> Dict:
        """Extract stage: the builder pads, relabels and builds the fetch
        plan in numpy; `_finish_batch` takes the result in (``step``
        labels its exchange spans)."""
        return self._finish_batch(*self.host_builder.extract(mbs), step=step)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _upload_block(self, arrays, b: int) -> Dict:
        """Block b of a host batch on the engine's device: the frontier
        (new ids, pad Vp), the loss labels and weights, the dense blocks
        and self indices, the cache slots."""
        L = self.cfg.num_layers
        return dict(
            frontier=self._upload(arrays["frontier"][b]).long(),
            y=self._upload(arrays["y"][b]).long(),
            w=self._upload(arrays["w"][b]),
            adj=tuple(self._upload(arrays[f"adj{l}"][b]) for l in range(L)),
            self_idx=tuple(self._upload(arrays[f"self_idx{l}"][b]).long()
                           for l in range(L)),
            cache_ids=self._upload(arrays["cache_ids"][b]).long())

    def _finish_batch(self, arrays, meta, step=None) -> Dict:
        """Take one extracted batch in: every rank's CommStats byte deltas
        are applied inside `_account_exchange`, labeled with that rank, with
        its frontier occupancy and overlay hits and misses (so every rank's
        counters equal the reference's single-host ones), and this rank's
        slice goes to the device, with
        its fetch plan (broadcast: the ids into the gathered table; ring:
        the ids into each owner's block; p2p: the send installments as
        K = 1 ELLs, whose pad entries ship row 0 as the reference's do,
        and the ids into [own rows | halo rows | zero row]).  The host
        arrays stay in the batch: the reference step reads every rank's
        block."""
        tel = self.telemetry
        for d, dd in enumerate(meta["per_device"]):
            with self._account_exchange("extract", step, d):
                for name, dv in dd["stats"].items():
                    setattr(self.comm_stats, name,
                            getattr(self.comm_stats, name) + dv)
            if tel.enabled:
                tel.gauge("frontier_occupancy", device=d).set(dd["occupancy"])
                self.store.count_overlay(
                    d, hits=dd["cache_hits"],
                    misses=dd["remote"] - dd["cache_hits"])
        r = self.rank
        batch = self._upload_block(arrays, r)
        ex = self.cfg.execution
        if ex == "broadcast":
            batch["bc_ids"] = self._upload(arrays["bc_ids"][r]).long()
        elif ex == "ring":
            batch["ring_ids"] = self._upload(arrays["ring_ids"][r]).long()
        else:
            send = []
            for ids in arrays["send_rows"][r]:  # [k, w] an installment
                ids = self._upload(ids.reshape(-1, 1))
                send.append((ids, torch.ones(ids.shape, dtype=torch.float32,
                                             device=self.device), None))
            batch["send"] = send
            batch["tab_ids"] = self._upload(arrays["tab_ids"][r]).long()
        if self.cfg.trainable_features:
            self._live_fetch_plans(batch, arrays)
        batch["arrays"] = arrays
        return batch

    def _live_fetch_plans(self, batch, arrays) -> None:
        """A trainable batch's fetch gathers as K = 1 ELLs, each with the
        transpose plan its backward reads, built here once per batch (by the
        pipelined producer lane when it uploads) and never inside the step:
        the cache slots over the live overlay rows (``cache``), broadcast's
        ids over the gathered table (``bc``), the ring's over each owner's
        block (``ring``), p2p's over [own rows | halo rows] (``tab``) and
        its send installments; pads are masked (`single_slot`).  Adds this
        rank's touched rows ``emb_ids``."""
        k, nb, ex = self.k, self.nb, self.cfg.execution
        if self._has_overlay:
            batch["cache"] = single_slot(batch["cache_ids"], self.Ccap,
                                         self.Ccap)
        if ex == "broadcast":
            batch["bc"] = single_slot(batch["bc_ids"], self.Vp, self.Vp)
        elif ex == "ring":
            batch["ring"] = single_slot(batch["ring_ids"], nb, nb)
        else:
            rows = nb + len(self.fcap_widths) * k * self.fcap_widths[0]
            batch["tab"] = single_slot(batch["tab_ids"], rows, rows)
            batch["send"] = [(ids, mask, ell_transpose_plan(ids, mask, nb))
                             for ids, mask, _ in batch["send"]]
        batch["emb_ids"] = self._upload(arrays["emb_ids"][self.rank]).long()

    def sample_minibatch(self, step_idx: int) -> Dict:
        """sample + extract: one static-shape batch for `step_idx`, this
        rank's slice on the device."""
        tel = self.telemetry
        with tel.span("sample", step=step_idx):
            mbs = self._sample_host(step_idx)
        with tel.span("extract", step=step_idx):
            return self._make_batch(mbs, step=step_idx)

    def _check_minibatch_runnable(self):
        """Validate the config once at epoch entry: a config mutated after
        construction would otherwise fail deep inside the step."""
        c = self.cfg
        if c.batching == "full_graph":
            raise ValueError(
                "batching='full_graph' has no mini-batch epoch; use train() "
                "/ make_step(), or rebuild the engine with a sampled "
                "batching mode (node_wise | layer_wise | subgraph)")
        if c.protocol != "sync":
            raise ValueError(
                f"mini-batch training supports protocol='sync' only, but "
                f"this engine's config now has protocol={c.protocol!r} "
                f"(changed after construction?); rebuild the engine with "
                f"protocol='sync', or use batching='full_graph' to train "
                f"with {c.protocol!r}.")

    def init_minibatch_state(self, params: Optional[Dict] = None, *,
                             reference: bool = False) -> Dict:
        """The mini-batch training state ``{params, step}``: ``params``
        drawn with `init_gnn_params` from a generator seeded with
        ``cfg.seed`` unless given (a carry-over).  With trainable features
        also the embedding table and its row-sparse AdamW state
        (`_embed_state`): this rank's rows, every row with ``reference``
        (the state `make_reference_minibatch_step` reads)."""
        if params is None:
            params = init_gnn_params(
                self.cfg.model, self.dims,
                torch.Generator().manual_seed(self.cfg.seed), self.device)
        state = dict(params=params, step=0)
        if self.cfg.trainable_features:
            state.update(self._embed_state(reference))
        return state

    def _overlay_rows_live(self, X_l: torch.Tensor) -> torch.Tensor:
        """This rank's overlay rows [Ccap, D] re-gathered from the LIVE
        owner shards (trainable features): one more set of all_to_all
        installments a step, whose reverse routes the cache hits' gradients
        back to the owners' rows."""
        ids, mask, plan = self._ov_tab
        X_l = X_l.contiguous()
        recv = bucketed_all_to_all(X_l, self._ov_send)()
        return self._ell(ids, mask, torch.cat([X_l, recv], 0), plan)

    def _fetch_live(self, X_l: torch.Tensor, cache_rows, bl: Dict
                    ) -> torch.Tensor:
        """The frontier fetch of trainable features, inside the gradient:
        `_fetch_frontier`'s dataflow with every gather a K = 1 ELL over the
        batch's plans (`_live_fetch_plans`), so the backward of each is the
        transpose kernel, and the collectives' reverses (the
        reduce-scatter, the reverse all_to_all or rotation) carry each
        frontier row's gradient back to its owner's rows.  ``cache_rows``
        is the live overlay or None without one (the cache slots then read
        nothing)."""
        c = self.cfg
        if cache_rows is None:
            F = X_l.new_zeros((bl["cache_ids"].shape[0], X_l.shape[1]))
        else:
            ids, mask, plan = bl["cache"]
            F = self._ell(ids, mask, cache_rows, plan)
        if c.execution == "ring":
            ids, mask, plans = bl["ring"]
            for owner, blk in ring_blocks(X_l.contiguous(), self.k,
                                          self.rank):
                F = F + self._ell(ids[owner], mask[owner], blk, plans[owner])
            return F
        if c.execution == "broadcast":
            ids, mask, plan = bl["bc"]
            if collectives.group_active():
                def exchange(hc):
                    return collectives.all_gather_rows(hc.contiguous())
            else:
                def exchange(hc):
                    return lambda: hc
        else:
            (ids, mask, plan), send = bl["tab"], bl["send"]

            def exchange(hc):
                hc = hc.contiguous()
                recv = bucketed_all_to_all(hc, send)
                return lambda: torch.cat([hc, recv()], 0)
        return F + chunked_overlap(
            X_l, c.exchange_chunks, exchange,
            lambda tab: self._ell(ids, mask, tab, plan))

    def _fetch_frontier(self, X_local: torch.Tensor, bl: Dict) -> torch.Tensor:
        """The input features of this rank's frontier, [cap0, D], outside
        the gradient (the features are frozen): the resident cache's rows
        plus the misses through the execution model.  Every valid frontier
        slot is covered by exactly one of the two (the other reads a zero
        row), so the sum is exact.  broadcast and p2p are feature-chunked
        (chunk c+1's collective issued before chunk c is gathered); the
        ring rotates this rank's rows (and their zero row) exactly k - 1
        times, round r gathering owner (rank + r) % k's rows.  Every gather
        is an `index_select`: nothing here has a backward."""
        c = self.cfg
        with torch.no_grad():
            F = torch.index_select(self._cache_table, 0, bl["cache_ids"])
            if c.execution == "ring":
                tab0 = torch.cat([X_local, zero_pad_row(X_local)], 0)
                for owner, blk in ring_blocks(tab0, self.k, self.rank):
                    F = F + torch.index_select(blk, 0, bl["ring_ids"][owner])
                return F
            if c.execution == "broadcast":
                ids = bl["bc_ids"]
                if collectives.group_active():
                    def exchange(hc):
                        gathered = collectives.all_gather_rows(hc.contiguous())
                        return lambda: torch.cat(
                            [gathered(), zero_pad_row(hc)], 0)
                else:
                    def exchange(hc):
                        return lambda: torch.cat([hc, zero_pad_row(hc)], 0)
            else:
                ids, send = bl["tab_ids"], bl["send"]

                def exchange(hc):
                    hc = hc.contiguous()
                    recv = bucketed_all_to_all(hc, send)
                    return lambda: torch.cat([hc, recv(), zero_pad_row(hc)],
                                             0)
            return F + chunked_overlap(
                X_local, c.exchange_chunks, exchange,
                lambda tab: torch.index_select(tab, 0, ids))

    def _numerator(self, params, bl, F):
        """The block's forward and its loss numerator sum((lse - ll) * w);
        returns (numerator, logits [cap_L, C])."""
        logits = padded_minibatch_forward(
            params, bl["adj"], F, model=self.cfg.model,
            self_idx=bl["self_idx"])
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, bl["y"][:, None])[:, 0]
        return ((lse - ll) * bl["w"]).sum(), logits

    def make_minibatch_step(self):
        """The mini-batch step: (state, batch) -> (state, {"loss"}, this
        rank's target logits [1, cap_L, C]).  The frontier fetch runs
        outside the gradient; the forward over the dense blocks runs under
        autograd on this rank's loss numerator; the numerator, the sum of
        the loss weights and every gradient (`PARAM_KEYS` order) are then
        summed over the ranks in one flat all_reduce and divided by
        den = max(sum of the weights, 1), as in the reference, before SGD.
        Without a process group the sums are the local values.

        With trainable features the fetch moves INSIDE the gradient
        (`_fetch_live`, after the live overlay refresh): the rows' gradient
        arrives summed over every rank that read them, takes no
        all_reduce, and `sparse_adamw_ids` updates this rank's touched rows
        ``emb_ids`` (sentinel nb) with it, divided by den."""
        if self._mb_step is not None:
            return self._mb_step
        if self.cfg.batching == "full_graph":
            raise ValueError("batching='full_graph' has no mini-batch step; "
                             "use make_step()")
        lr = self.cfg.lr
        keys = PARAM_KEYS[self.cfg.model]
        trainable, nb = self.cfg.trainable_features, self.nb

        def step(state, batch):
            if trainable:
                X = state["embed"].detach().requires_grad_()
            else:
                F = self._fetch_frontier(self.store.device_table(), batch)
            leaves = [p.detach().requires_grad_() for p in
                      _leaves(state["params"], keys)]
            with torch.enable_grad():
                if trainable:
                    F = self._fetch_live(
                        X, self._overlay_rows_live(X) if self._has_overlay
                        else None, batch)
                num, logits = self._numerator(_from_leaves(leaves, keys),
                                              batch, F)
                grads = list(torch.autograd.grad(
                    num, leaves + [X] if trainable else leaves))
            g_X = grads.pop() if trainable else None
            with torch.no_grad():
                w_sum = batch["w"].sum()
                num = num.detach()
                if collectives.group_active():
                    num, w_sum, *grads = collectives.all_reduce_flat(
                        [num, w_sum, *grads])
                den = torch.clamp(w_sum, min=1.0)
                loss = num / den
                params2 = _from_leaves([p - lr * (g / den)
                                        for p, g in zip(leaves, grads)], keys)
                state2 = dict(params=params2, step=state["step"] + 1)
                if trainable:
                    ids = batch["emb_ids"]
                    valid = ids < nb
                    g_rows = g_X.index_select(
                        0, torch.where(valid, ids, 0)) / den
                    state2.update(zip(EMBED_KEYS, sparse_adamw_ids(
                        state["embed"], state["emb_m"], state["emb_v"],
                        state["emb_t"], ids, g_rows, valid=valid,
                        **self._embed_hparams())))
            return state2, dict(loss=loss), logits.detach()[None]

        self._mb_step = step
        return step

    def make_reference_minibatch_step(self):
        """The single-device oracle of the mini-batch step: the same batch,
        every rank's block in turn (uploaded from the batch's host arrays;
        this rank's is already on the device), features read straight from
        the global table by frontier id (pads read its zero row), the loss
        over all k blocks, SGD; no collective.  Returns the target logits
        of every block, [k, cap_L, C].  With trainable features the table
        is the state's whole [Vp, D] ``embed``
        (``init_minibatch_state(reference=True)``), read inside the
        gradient by the plain slot gather, and `sparse_adamw_ids` updates
        the batch's touched rows of every owner (row (s, j) of ``emb_ids``
        is the flat row s*nb + j)."""
        if self._mb_ref_step is not None:
            return self._mb_ref_step
        lr = self.cfg.lr
        keys = PARAM_KEYS[self.cfg.model]
        trainable, k, nb, Vp = (self.cfg.trainable_features, self.k,
                                self.nb, self.Vp)
        if trainable:
            offsets = (torch.arange(k, device=self.device) * nb)[:, None]
        else:
            X = self._global_features()
            table0 = torch.cat([X, zero_pad_row(X)], 0)

        def ref_step(state, batch):
            blocks = [batch if b == self.rank
                      else self._upload_block(batch["arrays"], b)
                      for b in range(self.k)]
            leaves = [p.detach().requires_grad_() for p in
                      _leaves(state["params"], keys)]
            with torch.enable_grad():
                params = _from_leaves(leaves, keys)
                if trainable:
                    emb = state["embed"].detach().requires_grad_()
                    table = torch.cat([emb, zero_pad_row(emb)], 0)
                    fetched = [_SlotGather.apply(
                        bl["frontier"][:, None],
                        (bl["frontier"] < Vp).to(torch.float32)[:, None],
                        table) for bl in blocks]
                else:
                    fetched = [torch.index_select(table0, 0, bl["frontier"])
                               for bl in blocks]
                nums, logits = zip(*[self._numerator(params, bl, F)
                                     for bl, F in zip(blocks, fetched)])
                w_sum = sum(bl["w"].sum() for bl in blocks)
                loss = sum(nums) / torch.clamp(w_sum, min=1.0)
                grads = list(torch.autograd.grad(
                    loss, leaves + [emb] if trainable else leaves))
            g_E = grads.pop() if trainable else None
            with torch.no_grad():
                params2 = _from_leaves([p - lr * g
                                        for p, g in zip(leaves, grads)], keys)
                state2 = dict(params=params2, step=state["step"] + 1)
                if trainable:
                    emb_ids = torch.from_numpy(batch["arrays"]["emb_ids"]).to(
                        self.device).long()
                    valid = (emb_ids < nb).reshape(-1)
                    ids = (offsets + emb_ids).reshape(-1)
                    g_rows = g_E.index_select(0, torch.where(valid, ids, 0))
                    state2.update(zip(EMBED_KEYS, sparse_adamw_ids(
                        state["embed"], state["emb_m"], state["emb_v"],
                        state["emb_t"], ids, g_rows, valid=valid,
                        **self._embed_hparams())))
            return (state2, dict(loss=loss.detach()),
                    torch.stack([t.detach() for t in logits]))

        self._mb_ref_step = ref_step
        return ref_step

    def _ensure_proc_pool(self, depth: int) -> ProcPrefetchPool:
        """The engine's persistent sampling-process pool (prefetch_mode
        "process"), built at first use and reused across epochs: the
        graph's CSR arrays and labels go to shared memory once, each worker
        runs an unpickled copy of `host_builder` whose ``graph`` is the
        shared handle (attached read-only at first use), and finished
        batches come back through the shared-memory ring.  Rebuilt when
        the depth or cfg.num_sample_workers changes.  A graph or a ring
        the shared-memory mount cannot hold is refused with its sizes
        (`proc_prefetch.require_shm`), and what was shared is unlinked."""
        key = (int(depth), int(self.cfg.num_sample_workers))
        pool = self._proc_pool
        if pool is not None and pool.alive and self._proc_pool_key == key:
            return pool
        self.close_prefetch_pool()
        hb = self.host_builder
        shared, arena = share_graph(hb._g())
        try:
            builder = dataclasses.replace(hb, graph=shared)
            self._proc_pool = ProcPrefetchPool(
                builder.produce, hb.array_layout(), depth=key[0],
                num_workers=key[1], telemetry=self.telemetry,
                shared_inputs=(arena,))
        except BaseException:
            arena.close()
            raise
        self._proc_pool_key = key
        return self._proc_pool

    def close_prefetch_pool(self) -> None:
        """Stop the sampling processes and unlink their shared memory.
        Idempotent; safe to call with no pool built."""
        if self._proc_pool is not None:
            self._proc_pool.close()
            self._proc_pool = None

    def _finalize(self) -> None:
        """The pipelined epoch's one synchronize: the card's queued steps
        finish inside the timed window."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_epoch_minibatch(self, num_batches: int,
                            schedule: str = "conventional", state=None,
                            reference: bool = False,
                            prefetch_depth: Optional[int] = None,
                            prefetch_mode: Optional[str] = None):
        """Drive the §6.1 mini-batch schedules (conventional, factored,
        operator_parallel, pipelined) with the engine's real stages: host
        sampling, padded-batch extraction (the fetch plan and this rank's
        upload) and the training step.  Returns (state, losses,
        StageTimes).  Batches are deterministic in (seed, step, rank), so
        every schedule gives the same losses, params and CommStats, bit for
        bit.  A fresh run (state=None) resets CommStats, as `train` does; a
        state passed in continues accumulating.

        ``schedule="pipelined"`` runs the producer lane for real, bounded
        ``prefetch_depth`` batches ahead (default cfg.prefetch_depth), while
        the trainer lane dispatches step i without waiting for the card:
        the losses stay tensors until the epoch's one synchronize
        (`_finalize`).  ``prefetch_mode`` (default cfg.prefetch_mode) picks
        the producer: "thread", a `PrefetchWorker` in this process, which
        also uploads each batch (on the default stream, ahead of the steps
        that read it); "process", the persistent `ProcPrefetchPool` of
        cfg.num_sample_workers processes (`_ensure_proc_pool`), whose
        batches this thread takes in (`_finish_batch`: CommStats, upload).
        Call `close_prefetch_pool()` when done (GC also reclaims it).

        With telemetry enabled each schedule records its stage spans, and
        each step a `log_step` record (its CommStats total read when the
        trainer dispatched it)."""
        self._check_minibatch_runnable()
        if schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {tuple(SCHEDULES)}; "
                             f"got {schedule!r}")
        pipelined = schedule == "pipelined"
        if pipelined:
            depth = (self.cfg.prefetch_depth if prefetch_depth is None
                     else prefetch_depth)
            mode = (self.cfg.prefetch_mode if prefetch_mode is None
                    else prefetch_mode)
            if mode not in PREFETCH_MODES:
                raise ValueError("prefetch_mode must be 'thread' or "
                                 f"'process'; got {mode!r}")
        step = (self.make_reference_minibatch_step() if reference
                else self.make_minibatch_step())
        if state is None:
            self.comm_stats.reset()
        holder = dict(state=state if state is not None
                      else self.init_minibatch_state(reference=reference))
        losses: List = []
        tel = self.telemetry

        def train_fn(mbs, batch):
            holder["state"], metrics, _ = step(holder["state"], batch)
            # pipelined lane: no float() here, which would wait for the card
            losses.append(metrics["loss"] if pipelined
                          else float(metrics["loss"]))
            tel.log_step(step=len(losses) - 1, schedule=schedule,
                         comm_total_bytes=self.comm_stats.total())

        batch_ids = list(range(num_batches))
        # items carry their step, so the extract stage labels its exchange
        # spans (train_fn never looks inside them)
        def sample_fn(i):
            return i, self._sample_host(i)

        def extract_fn(item):
            return self._make_batch(item[1], step=item[0])

        if not pipelined:
            times = SCHEDULES[schedule](batch_ids, sample_fn, extract_fn,
                                        train_fn, telemetry=tel)
            return holder["state"], losses, times
        if mode == "process":
            def train_fn_proc(item, arrays, meta):
                train_fn(None, self._finish_batch(arrays, meta, step=item))

            times = run_pipelined_process(
                batch_ids, self._ensure_proc_pool(depth), train_fn_proc,
                finalize_fn=self._finalize, telemetry=tel)
        else:
            times = run_pipelined(batch_ids, sample_fn, extract_fn, train_fn,
                                  prefetch_depth=depth,
                                  finalize_fn=self._finalize, telemetry=tel)
        return holder["state"], [float(x) for x in losses], times

    def minibatch_accuracy(self, logits: torch.Tensor, batch) -> float:
        """Accuracy over the batch's weighted (owned train) targets of
        every rank.  ``logits`` [1, cap_L, C], this rank's (the step's):
        the counts are summed over the ranks in one all_reduce; or
        [k, cap_L, C], every rank's (`train`, the reference step), against
        the batch's host labels and weights."""
        if logits.shape[0] == 1:
            y, w = batch["y"][None], batch["w"][None]
        else:
            arrays = batch["arrays"]
            y = torch.from_numpy(arrays["y"]).to(logits.device).long()
            w = torch.from_numpy(arrays["w"]).to(logits.device)
        correct = (torch.argmax(logits, -1) == y).float()
        num, den = (correct * w).sum(), w.sum()
        if logits.shape[0] == 1 and collectives.group_active():
            num, den = collectives.all_reduce_flat([num, den])
        return float(num / torch.clamp(den, min=1.0))

    # ------------------------------------------------------------------
    # training loop
    # ------------------------------------------------------------------

    def account_step(self, step=None) -> None:
        """Accrue one distributed training step's wire bytes into
        CommStats, field by field, as the reference's `train` does (with
        trainable features the layer-0 gradients' bytes too), mirrored into
        the telemetry as a ``full_graph`` exchange of step ``step``."""
        with self._account_exchange("full_graph", step, None):
            for name, b in self._wire_fields.items():
                setattr(self.comm_stats, name,
                        getattr(self.comm_stats, name) + b)
            if self.cfg.trainable_features:
                self.comm_stats.embed_grad_bytes += self._emb_bytes_per_step

    def train(self, epochs: int, reference: bool = False
              ) -> Tuple[List[float], torch.Tensor]:
        """Run `epochs` steps from `init_state()`; returns (losses, final
        logits [Vp, C] on every rank).  The distributed run resets CommStats
        and accrues each step's wire bytes; the reference run accrues
        none.  Mini-batch modes: `epochs` steps from `init_minibatch_state()`
        over `sample_minibatch(i)`, CommStats reset and accruing the
        feature fetch bytes; the final logits are every rank's targets,
        [k, cap_L, C] (one all_gather after the run).  With telemetry
        enabled each step runs in a ``train`` span (a mini-batch step's
        sample and extract in theirs) and appends a `log_step` record."""
        tel = self.telemetry
        if self.cfg.batching != "full_graph":
            self._check_minibatch_runnable()
            step = (self.make_reference_minibatch_step() if reference
                    else self.make_minibatch_step())
            state = self.init_minibatch_state(reference=reference)
            self.comm_stats.reset()
            losses, logits = [], None
            for i in range(epochs):
                batch = self.sample_minibatch(i)
                with tel.span("train", step=i):
                    state, metrics, logits = step(state, batch)
                    losses.append(float(metrics["loss"]))
                tel.log_step(step=i, loss=losses[-1],
                             comm_total_bytes=self.comm_stats.total())
            if not reference and logits is not None:
                logits = self.gather_rows(logits[0]).view(
                    self.k, *logits.shape[1:])
            return losses, logits
        step = self.make_reference_step() if reference else self.make_step()
        state = self.init_state(reference=reference)
        if not reference:
            self.comm_stats.reset()
        losses, logits = [], None
        for i in range(epochs):
            with tel.span("train", step=i):
                state, metrics, logits = step(state)
                losses.append(float(metrics["loss"]))
            if not reference:
                self.account_step(i)
                tel.log_step(step=i, loss=losses[-1],
                             comm_total_bytes=self.comm_stats.total())
        return losses, (logits if reference else self.gather_rows(logits))

    def accuracy(self, logits: torch.Tensor, split: str = "test") -> float:
        """Share of the split's vertices, over every rank, whose argmax
        logit is the label; ``logits`` [Vp, C] (`train`, `gather_rows`)."""
        gl = self._global_consts()
        w = gl["test_w" if split == "test" else "train_w"]
        return float(accuracy(logits, gl["y"], w))

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
