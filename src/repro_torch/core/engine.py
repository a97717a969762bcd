"""DistGNNEngine (the port's counterpart of `repro/core/engine.py`): the
synchronous full-graph training step and the layer-wise full-graph inference
sweep, one process per rank over `torch.distributed`.

The engine builds the partition family's layout (`partition/layout_api.py`)
whole on the host, identically on every rank, moves this rank's block of the
ELL constants and of the feature plane onto its device once, and runs each
layer through the family's ExchangeBackend (`execution/exchange_api.py`).
gcn, sage, gin: exchange (chunked; an all_gather over the process group),
masked ELL multiply through the hand-written CUDA kernel, degree
normalization, then the model's dense combine with the rank's own rows.
gat: the fused [a_src.Hw | Hw] exchange, the masked segment-softmax and the
attention-weighted ELL sum (`ell_attend`).  The training step (`make_step`)
runs the same forward under autograd, so every gather's backward is a CUDA
kernel over a CSR transpose plan built once here (the transpose,
ell_attend's dw, the slot transpose) and every all_gather's backward a
reduce-scatter; the loss numerator and the gradients are then summed over
the ranks in one all_reduce.  `make_reference_step` and
`infer_full_graph(reference=True)` run an independent plain-PyTorch gather
over the whole padded space on every rank, with no collective (gat's edge
logits through the SDDMM kernel, as the reference's do): the oracle every
step and sweep is held to.

Ported: models gcn, sage, gat and gin, partition family edge_cut (hash and
range), execution broadcast, batching full_graph, protocol sync, on any
number of ranks.  The ranks are the process group's (`execution/
collectives.py`); without one the engine runs on one rank.  Everything else
raises NotImplementedError naming the slice it waits for.  The async
protocols and telemetry arrive with their own slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.execution import collectives
from repro_torch.core.execution.exchange_api import make_backend
from repro_torch.core.graph import Graph
from repro_torch.core.models.gnn import (
    PARAM_KEYS,
    accuracy,
    init_gnn_params,
    softmax_xent,
)
from repro_torch.core.partition.edge_cut import Partition
from repro_torch.core.partition.layout_api import get_layout_builder
from repro_torch.core.sampling.distributed import CommStats
from repro_torch.kernels.ops import (
    ell_attend,
    ell_spmm,
    ell_transpose_plan,
    sddmm_ell,
)

EXECUTION_MODELS = ("broadcast", "ring", "p2p")
GNN_MODELS = ("gcn", "sage", "gat", "gin")
PROTOCOLS = ("sync", "epoch_fixed", "epoch_adaptive", "variation")
BATCHING_MODES = ("full_graph", "node_wise", "layer_wise", "subgraph")
PARTITION_FAMILIES = ("edge_cut", "vertex_cut", "hybrid")

# layout attributes the engine mirrors, so callers keep reading eng.<attr>
ENGINE_MIRROR_ATTRS = ("nb", "Vp", "K", "ids_global", "store", "y",
                       "train_w", "test_w")


@dataclasses.dataclass
class EngineConfig:
    execution: str = "broadcast"  # broadcast | ring | p2p
    protocol: str = "sync"  # sync | epoch_fixed | epoch_adaptive | variation
    model: str = "gcn"  # gcn | sage | gat | gin — the GNN layer program
    partition_family: str = "edge_cut"  # edge_cut | vertex_cut | hybrid
    partitioner: str = "hash"  # edge_cut: any key of PARTITIONERS (hash and
    #   range are ported)
    batching: str = "full_graph"  # full_graph | node_wise | layer_wise | subgraph
    exchange_chunks: int = 1  # feature-dim chunks of the exchange
    hidden: int = 32
    num_layers: int = 2
    lr: float = 0.5  # SGD step of the training step
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
        if cfg.exchange_chunks < 1:
            raise ValueError("exchange_chunks must be >= 1")
        if cfg.protocol != "sync":
            raise NotImplementedError(
                f"protocol={cfg.protocol!r}: only sync is ported; the "
                "historical-embedding protocols arrive with their own slice "
                "(the async_hist slice, ROADMAP queue 1 item 6)")
        if cfg.batching != "full_graph":
            raise NotImplementedError(
                f"batching={cfg.batching!r}: only full_graph is ported; the "
                "sampled mini-batch path arrives with its own slice")
        self.k = collectives.world_size()
        if partition is not None and partition.num_parts != self.k:
            raise ValueError(
                f"the partition has {partition.num_parts} parts and the "
                f"process group {self.k} rank(s): they must be equal")
        self.rank = collectives.rank()
        if cfg.execution != "broadcast":
            raise NotImplementedError(
                f"execution={cfg.execution!r}: only broadcast is ported; ring "
                "arrives with the ring slice (ROADMAP queue 1 item 4), p2p "
                "with the p2p slice (item 5)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DistGNNEngine runs on the card (device='cuda') and CUDA is "
                "not available; pass device='cpu' to run on the CPU")
        # the step and the sweep are held to the fp32 reference: no TF32 in
        # the matmuls
        torch.backends.cuda.matmul.allow_tf32 = False
        self.g = g
        builder = get_layout_builder(cfg.partition_family)
        lay = self.playout = builder(g, self.k, cfg, partition=partition,
                                     device=self.device, rank=self.rank)
        for name in ENGINE_MIRROR_ATTRS:
            setattr(self, name, getattr(lay, name))
        consts = lay.exchange_consts()
        # this rank's rows of every per-vertex table; the ids still index
        # the whole [k*nb + 1] gather table
        own = slice(self.rank * self.nb, (self.rank + 1) * self.nb)

        def upload(a):
            return torch.from_numpy(np.ascontiguousarray(a[own])).to(
                self.device)
        ids, mask = upload(consts["ids"]), upload(consts["mask"])
        # the CSR transpose of the ELL table over the gather table's rows
        # (every rank's block + the zero pad row): built once, read by
        # every backward of a gather over it (every layer, chunk and step)
        plan = ell_transpose_plan(ids, mask, self.k * self.nb + 1)
        self._consts = dict(
            ids=ids, mask=mask, plan=plan, deg=upload(lay.deg),
            y=upload(lay.y).long(), train_w=upload(lay.train_w),
            test_w=upload(lay.test_w))
        # the loss's denominator, max(sum of every rank's weights, 1)
        w_sum = self._consts["train_w"].sum()
        if collectives.group_active():
            (w_sum,) = collectives.all_reduce_flat([w_sum])
        self._den = torch.clamp(w_sum, min=1.0)
        self._global = None  # the whole layout's tables: `_global_consts`
        self.backend = make_backend(self)
        num_classes = int(g.labels.max()) + 1
        self.dims = ([g.features.shape[1]]
                     + [cfg.hidden] * (cfg.num_layers - 1) + [num_classes])
        self._wire_fields = lay.wire_fields_per_step(cfg.model, self.dims)
        self._infer_step = None
        self._step = None
        self._ref_step = None
        self.comm_stats = CommStats()

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

    def _forward(self, params, X):
        """The distributed forward: every layer through `_layer`; returns
        the logits."""
        cl = self._consts
        L = len(self.dims) - 1
        H = X
        for l, p_l in enumerate(params["layers"]):
            H = self._layer(p_l, H, cl, last=(l == L - 1))
        return H

    def _global_consts(self) -> Dict:
        """The whole layout's per-vertex tables on the device, which the
        single-device oracle and `accuracy` read: on one rank the engine's
        own; on more, uploaded from the host layout at the first call."""
        if self._global is None:
            keys = ("mask", "deg", "y", "train_w", "test_w")
            if self.k == 1:
                self._global = {key: self._consts[key] for key in keys}
            else:
                lay = self.playout
                self._global = {key: torch.from_numpy(getattr(lay, key)).to(
                    self.device) for key in keys}
                self._global["y"] = self._global["y"].long()
        return self._global

    def _global_features(self) -> torch.Tensor:
        """The whole feature plane [Vp, D] on the device, live: on one rank
        the store's own table; on more, the store's host copy uploaded."""
        if self.k == 1:
            return self.store.device_table()
        return torch.from_numpy(self.store.host_table()).to(self.device)

    def _make_reference_layer(self):
        """Single-device reference layer over the whole padded [Vp] space,
        run by every rank with no collective: a plain slot-by-slot gather of
        the global ELL table and its slot-by-slot scatter-add gradient
        (`_SlotGather`, written apart from the kernels, their plain versions
        and the transpose plan, so it checks all three).  gat: the edge
        logits through `_sddmm` (the SDDMM kernel and its slot-transpose
        gradient, as the reference calls its Pallas SDDMM), the softmax, and
        the plain slot-by-slot attention gather `_SlotAttend` (so it checks
        the forward, transpose and dw kernels)."""
        c = self.cfg
        ids_g = torch.from_numpy(self.ids_global).to(self.device)
        ids_g32 = ids_g.int()
        gl = self._global_consts()
        mask, deg = gl["mask"], gl["deg"]
        # the SDDMM gradient's transpose plan: on one rank the engine's own
        # ELL table is the global one; on more `sddmm_ell` builds its own
        plan = self._consts["plan"] if self.k == 1 else None

        def gat_layer_ref(p_l, H, last):
            Hw = H @ p_l["w"]
            table = torch.cat([Hw, Hw.new_zeros((1, Hw.shape[1]))], 0)
            e = self._sddmm(ids_g32, mask, table, p_l["a_src"], p_l["a_dst"],
                            plan)
            pw, den = self._gat_softmax(e)
            num = _SlotAttend.apply(ids_g, mask, pw, table)
            z = torch.where(den > 0, num / torch.clamp(den, min=1e-30), Hw)
            return z if last else torch.relu(z)

        def layer_ref(p_l, H, last):
            if c.model == "gat":
                return gat_layer_ref(p_l, H, last)
            table = torch.cat([H, H.new_zeros((1, H.shape[1]))], 0)
            gathered = _SlotGather.apply(ids_g, mask, table)
            return self._combine(c.model, p_l, gathered / deg, H, last=last)

        return layer_ref

    # ------------------------------------------------------------------
    # state and the distributed training step
    # ------------------------------------------------------------------

    def init_state(self, params: Optional[Dict] = None) -> Dict:
        """The training state under sync: ``{params, step}``.  Without
        ``params``, draws them with `init_gnn_params` from a generator
        seeded with ``cfg.seed``; with them, starts from those weights (a
        carry-over).  The reference's all-zero historical embeddings and
        ages serve only the async protocols and arrive with them."""
        if params is None:
            params = init_gnn_params(
                self.cfg.model, self.dims,
                torch.Generator().manual_seed(self.cfg.seed), self.device)
        return dict(params=params, step=0)

    def make_step(self):
        """The training step: state -> (state, {"loss"}, this rank's logits
        rows [nb, C]).  The rank's loss numerator sum((lse - ll) * w) is
        differentiated locally (each all_gather's backward reduce-scatters
        the other ranks' share of the tables' gradient to this rank); the
        numerator and every gradient are then summed over the ranks in one
        flat all_reduce, in `PARAM_KEYS` order, and divided by den =
        max(sum of every rank's w, 1) outside the gradient, as in the
        reference.  Without a process group the sums are the local values.
        SGD writes new tensors, so a state can be stepped twice."""
        if self._step is not None:
            return self._step
        cl = self._consts
        lr = self.cfg.lr
        den = self._den
        keys = PARAM_KEYS[self.cfg.model]

        def step(state):
            leaves = [p.detach().requires_grad_() for p in
                      _leaves(state["params"], keys)]
            with torch.enable_grad():
                logits = self._forward(_from_leaves(leaves, keys),
                                       self.store.device_table())
                lse = torch.logsumexp(logits, dim=-1)
                ll = torch.gather(logits, -1, cl["y"][:, None])[:, 0]
                num = ((lse - ll) * cl["train_w"]).sum()
                grads = torch.autograd.grad(num, leaves)
            with torch.no_grad():
                if collectives.group_active():
                    num, *grads = collectives.all_reduce_flat(
                        [num.detach(), *grads])
                loss = num / den
                params2 = _from_leaves([p - lr * (g / den)
                                        for p, g in zip(leaves, grads)], keys)
            return (dict(params=params2, step=state["step"] + 1),
                    dict(loss=loss), logits.detach())

        self._step = step
        return step

    def make_reference_step(self):
        """The same loss and SGD on one device over the reference layer
        (`_make_reference_layer`) and the whole graph, differentiated by
        autograd through the plain gather: independent of the kernels,
        their plan and the collectives.  Returns the logits of every vertex,
        [Vp, C]."""
        if self._ref_step is not None:
            return self._ref_step
        cl = self._global_consts()
        lr = self.cfg.lr
        layer_ref = self._make_reference_layer()
        L = len(self.dims) - 1
        keys = PARAM_KEYS[self.cfg.model]

        def ref_step(state):
            leaves = [p.detach().requires_grad_() for p in
                      _leaves(state["params"], keys)]
            with torch.enable_grad():
                H = self._global_features()
                for l, p_l in enumerate(_from_leaves(leaves, keys)["layers"]):
                    H = layer_ref(p_l, H, last=(l == L - 1))
                loss = softmax_xent(H, cl["y"], cl["train_w"])
                grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                params2 = _from_leaves([p - lr * g
                                        for p, g in zip(leaves, grads)], keys)
            return (dict(params=params2, step=state["step"] + 1),
                    dict(loss=loss.detach()), H.detach())

        self._ref_step = ref_step
        return ref_step

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
            return self._forward(params, X)

        self._infer_step = istep
        return istep

    def infer_full_graph(self, *, params: Dict, reference: bool = False
                         ) -> torch.Tensor:
        """Owner-partitioned final-layer embeddings for EVERY vertex, [Vp, C]
        on the engine's device, on every rank (`global_embeddings` maps them
        back to the original vertex ids).  One call = one O(L) layer-wise
        sweep over this rank's rows, then one all_gather of the last layer's
        rows (`gather_rows`, not counted as sweep traffic, as in the
        reference); the sweep's wire bytes accrue into
        CommStats.inference_bytes.

        `reference=True` runs the independent single-device oracle instead
        (no bytes accrue)."""
        if reference:
            layer_ref = self._make_reference_layer()
            L = len(self.dims) - 1
            with torch.no_grad():
                H = self._global_features()
                for l, p_l in enumerate(params["layers"]):
                    H = layer_ref(p_l, H, last=(l == L - 1))
            return H
        out = self.make_infer_step()(params, self.store.device_table())
        self.comm_stats.inference_bytes += self.inference_bytes_per_sweep()
        return self.gather_rows(out)

    def gather_rows(self, H: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a per-vertex table, [Vp, D] on every rank,
        from this rank's [nb, D]: one all_gather over the process group
        (without one, the rank's rows are all of them)."""
        if not collectives.group_active():
            return H
        with torch.no_grad():
            return collectives.all_gather_rows(H.contiguous())()

    # ------------------------------------------------------------------
    # training loop
    # ------------------------------------------------------------------

    def account_step(self) -> None:
        """Accrue one distributed training step's wire bytes into
        CommStats, field by field, as the reference's `train` does."""
        for name, b in self._wire_fields.items():
            setattr(self.comm_stats, name, getattr(self.comm_stats, name) + b)

    def train(self, epochs: int, reference: bool = False
              ) -> Tuple[List[float], torch.Tensor]:
        """Run `epochs` steps from `init_state()`; returns (losses, final
        logits [Vp, C] on every rank).  The distributed run resets CommStats
        and accrues each step's wire bytes; the reference run accrues
        none."""
        step = self.make_reference_step() if reference else self.make_step()
        state = self.init_state()
        if not reference:
            self.comm_stats.reset()
        losses, logits = [], None
        for _ in range(epochs):
            state, metrics, logits = step(state)
            losses.append(float(metrics["loss"]))
            if not reference:
                self.account_step()
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
