"""End-to-end single-device GNN training (the port's copy of
`repro/core/training.py`, the survey's Fig. 2 pipeline):

  full_graph_train   — full-graph training under a protocol: sync, the
                       async historical embeddings under any staleness
                       model (epoch_fixed, epoch_adaptive, variation), or
                       PipeGCN (stale embeddings and stale gradients).
  minibatch_train    — node-wise sampled training with a static cache.
  llcg_train         — partition-based batches and periodic global
                       correction (LLCG; PSGD-PA without it).

Each step is eager autograd plus plain SGD where the reference jits; the
protocol state (historical embeddings, PipeGCN's histories) is carried
between steps and never carries a gradient.  The products are the dense
fp32 ``A @ H`` of `models/gnn.py`, TF32 off.  Every entry point takes
``device`` ("cuda" by default, which raises without a card) and draws its
initial weights from ``torch.Generator().manual_seed(seed)`` (the
reference draws them from ``jax.random.PRNGKey(seed)``: the tests carry
those over).  The accuracies come from the last step's logits, computed
before that step's update, as the reference's do.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.graph import Graph
from repro_torch.core.models.gnn import (
    accuracy,
    full_graph_forward,
    gnn_layer,
    init_gnn_params,
    minibatch_forward,
    softmax_xent,
)
from repro_torch.core.partition.edge_cut import PARTITIONERS, Partition
from repro_torch.core.partition.vertex_cut import edge_endpoints
from repro_torch.core.protocols.async_hist import (
    STALENESS_MODELS,
    HistoricalState,
    pipegcn_mix,
)
from repro_torch.core.sampling.cache import static_degree_cache
from repro_torch.core.sampling.partition_batch import (
    expanded_partition_minibatch,
    partition_minibatch,
)
from repro_torch.core.sampling.samplers import MiniBatch, node_wise_sample


# ---------------------------------------------------------------------------
# shared bits
# ---------------------------------------------------------------------------


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the trainers run on the card (device='cuda') and CUDA is not "
            "available; pass device='cpu' to run on the CPU")
    # held to the fp32 reference: no TF32 in the matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    return device


def _leaves(params: Dict) -> List[torch.Tensor]:
    return [t for p in params["layers"] for t in p.values()]


def _value_and_grad(params: Dict, loss_fn: Callable,
                    extra: Sequence[torch.Tensor] = ()):
    """``loss_fn(params, extra) -> (loss, aux)`` and the gradients of the loss
    with respect to every parameter and to each tensor of ``extra``
    (zeros where the loss does not read it, as ``jax.grad`` gives).
    Returns (loss, aux, param grads, extra grads)."""
    live = {"layers": [{key: t.detach().requires_grad_()
                        for key, t in p.items()} for p in params["layers"]]}
    extra = [t.detach().requires_grad_() for t in extra]
    loss, aux = loss_fn(live, extra)
    wrt = _leaves(live) + extra
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(wrt, grads)]
    n = len(grads) - len(extra)
    return loss.detach(), aux, grads[:n], grads[n:]


def _sgd(params: Dict, grads: Sequence[torch.Tensor], lr: float) -> Dict:
    it = iter(grads)
    return {"layers": [{key: (t - lr * next(it)).detach()
                        for key, t in p.items()} for p in params["layers"]]}


def _init(model: str, dims: Sequence[int], seed: int, device) -> Dict:
    return init_gnn_params(model, dims, torch.Generator().manual_seed(seed),
                           device)


def dense_adj(g: Graph, device) -> torch.Tensor:
    """``g.to_dense_adj()`` built on ``device``: [V, V] fp32, row v holding
    v's in-neighbors, with self loops, D^-1/2 (A + I) D^-1/2, in the
    reference's order of operations, so the result equals the host array
    bit for bit (row sums of 0/1 entries are exact; D^-1/2 is the host's
    numpy).  Built on the device because the host build's 1 GiB passes at
    2**14 vertices cost seconds a trainer call (`chip_smoke.py` times
    both)."""
    V = g.num_vertices
    src, dst = edge_endpoints(g)
    A = torch.zeros((V, V), dtype=torch.float32, device=device)
    A[torch.as_tensor(dst, device=device),
      torch.as_tensor(src, device=device)] = 1.0
    A.diagonal().add_(1.0)
    d = A.sum(1).cpu().numpy()
    dinv = torch.as_tensor(1.0 / np.sqrt(np.maximum(d, np.float32(1.0))),
                           device=device)
    return A.mul_(dinv[:, None]).mul_(dinv[None, :])


def _graph_tensors(g: Graph, device):
    """(X, y, train mask, test mask) on the device."""
    return (torch.as_tensor(g.features, device=device),
            torch.as_tensor(g.labels.astype(np.int64), device=device),
            torch.as_tensor(g.train_mask.astype(np.float32), device=device),
            torch.as_tensor(g.test_mask.astype(np.float32), device=device))


def boundary_mask_for(g: Graph, part: Partition) -> np.ndarray:
    """Vertices read by at least one remote partition (their embeddings
    cross the wire during GA: the only rows that can ever be stale), over
    the CSR at once (the reference loops over every vertex)."""
    a = part.assignment
    src, dst = edge_endpoints(g)
    mask = np.zeros(g.num_vertices, bool)
    mask[src[a[src] != a[dst]]] = True
    return mask


# ---------------------------------------------------------------------------
# Full-graph training
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FullGraphResult:
    losses: List[float]
    train_acc: float
    test_acc: float
    bytes_pushed: float = 0.0  # async protocols: rows refreshed * D * 4


def full_graph_train(g: Graph, *, model: str = "gcn", hidden: int = 32,
                     epochs: int = 60, lr: float = 0.5,
                     protocol: str = "sync",
                     staleness: int = 2, eps_v: float = 0.05,
                     partition: Optional[Partition] = None,
                     num_parts: int = 4, seed: int = 0,
                     device="cuda") -> FullGraphResult:
    """protocol: 'sync' | 'epoch_fixed' | 'epoch_adaptive' | 'variation' |
    'pipegcn'.

    The async protocols reproduce the survey's §7.2 semantics: the GA
    stage of every layer reads historical embeddings for boundary
    vertices, refreshed per the staleness model (bounded staleness); sync
    reads fresh embeddings."""
    device = _device(device)
    if protocol == "pipegcn":
        return _pipegcn_train(g, model=model, hidden=hidden, epochs=epochs,
                              lr=lr, partition=partition, num_parts=num_parts,
                              seed=seed, device=device)
    A = dense_adj(g, device)
    X, y, train_m, test_m = _graph_tensors(g, device)
    num_classes = int(g.labels.max()) + 1
    dims = [g.features.shape[1], hidden, num_classes]
    params = _init(model, dims, seed, device)
    L = len(dims) - 1

    if protocol == "sync":
        def loss_fn(p, _):
            logits = full_graph_forward(model, p, A, X)
            return softmax_xent(logits, y, train_m), logits

        losses, logits = [], None
        for _ in range(epochs):
            loss, logits, grads, _ = _value_and_grad(params, loss_fn)
            params = _sgd(params, grads, lr)
            losses.append(float(loss))
        return FullGraphResult(losses, float(accuracy(logits, y, train_m)),
                               float(accuracy(logits, y, test_m)))

    # --- async with historical embeddings ---
    part = partition or PARTITIONERS["metis_like"](g, num_parts, seed=seed)
    assignment = torch.as_tensor(part.assignment.astype(np.int64),
                                 device=device)
    bmask = torch.as_tensor(boundary_mask_for(g, part), device=device)
    refresh_fn = STALENESS_MODELS[protocol]
    kw = {"staleness": staleness} if protocol != "variation" else {"eps": eps_v}
    states = [HistoricalState.create(g.num_vertices, d, part.num_parts,
                                     device=device) for d in dims[1:]]

    losses, logits = [], None
    for e in range(epochs):
        def loss_fn(p, _):
            H, new_states = X, []
            for l, pl in enumerate(p["layers"]):
                H = gnn_layer(model, pl, A, H, last=(l == L - 1))
                H, st2 = refresh_fn(states[l], H, e, assignment, bmask, **kw)
                new_states.append(st2)
            return softmax_xent(H, y, train_m), (H, new_states)

        loss, (logits, new_states), grads, _ = _value_and_grad(params, loss_fn)
        params = _sgd(params, grads, lr)
        # the histories are state: no gradient flows through them
        states = [HistoricalState(st.hist.detach(), st.age,
                                  st.bytes_pushed.detach())
                  for st in new_states]
        logits = logits.detach()
        losses.append(float(loss))
    return FullGraphResult(losses, float(accuracy(logits, y, train_m)),
                           float(accuracy(logits, y, test_m)),
                           bytes_pushed=float(states[-1].bytes_pushed))


# ---------------------------------------------------------------------------
# Mini-batch training
# ---------------------------------------------------------------------------


def _pad_pow2(n: int, lo: int = 8) -> int:
    m = lo
    while m < n:
        m *= 2
    return m


def _device_batch(mb: MiniBatch, device) -> Tuple:
    """The batch on the device, every frontier padded to a power of two
    (at least 8) as the reference pads it for its jit: zero rows and
    columns in the blocks, self index 0, feature rows zero, labels 0 and
    loss weights 0 on the padded targets."""
    adjs, self_idx = [], []
    lv = mb.layer_vertices
    for l, A in enumerate(mb.layer_adj):
        rows, cols = lv[l + 1], lv[l]
        nr, nc = _pad_pow2(len(rows)), _pad_pow2(len(cols))
        Ap = np.zeros((nr, nc), np.float32)
        Ap[: A.shape[0], : A.shape[1]] = A
        adjs.append(torch.as_tensor(Ap, device=device))
        si = np.clip(np.searchsorted(cols, rows), 0, len(cols) - 1)
        sip = np.zeros(nr, np.int64)
        sip[: len(si)] = si
        self_idx.append(torch.as_tensor(sip, device=device))
    n_in = _pad_pow2(mb.input_features.shape[0])
    X = np.zeros((n_in, mb.input_features.shape[1]), np.float32)
    X[: mb.input_features.shape[0]] = mb.input_features
    nt = _pad_pow2(len(mb.targets))
    yb = np.zeros(nt, np.int64)
    yb[: len(mb.targets)] = mb.labels
    wb = np.zeros(nt, np.float32)
    wb[: len(mb.targets)] = 1.0
    return (adjs, self_idx, torch.as_tensor(X, device=device),
            torch.as_tensor(yb, device=device),
            torch.as_tensor(wb, device=device))


@dataclasses.dataclass
class MiniBatchResult:
    losses: List[float]
    test_acc: float
    cache_hit_ratio: float


def minibatch_train(g: Graph, *, model: str = "sage", hidden: int = 32,
                    fanouts=(5, 5), batch_size: int = 32, epochs: int = 3,
                    lr: float = 0.1, cache_capacity: int = 0,
                    seed: int = 0, device="cuda") -> MiniBatchResult:
    """Node-wise sampled training: each epoch a permutation of the train
    vertices in batches of ``batch_size`` (the last partial batch
    dropped), drawn from ``np.random.default_rng(seed)``; the cache hit
    ratio counts each batch's input frontier against the static-degree
    cache of ``cache_capacity`` rows; the test accuracy is a full-graph
    forward of the trained params."""
    device = _device(device)
    rng = np.random.default_rng(seed)
    num_classes = int(g.labels.max()) + 1
    dims = [g.features.shape[1]] + [hidden] * (len(fanouts) - 1) + [num_classes]
    params = _init(model, dims, seed, device)
    train = np.where(g.train_mask)[0]
    cached = (static_degree_cache(g, cache_capacity) if cache_capacity
              else np.zeros(0, np.int64))
    hits = total = 0

    losses = []
    for _ in range(epochs):
        perm = rng.permutation(train)
        for i in range(0, len(perm) - batch_size + 1, batch_size):
            mb = node_wise_sample(g, perm[i: i + batch_size], fanouts, rng)
            hits += int(np.isin(mb.layer_vertices[0], cached).sum())
            total += len(mb.layer_vertices[0])
            adjs, self_idx, X, yb, wb = _device_batch(mb, device)

            def loss_fn(p, _):
                logits = minibatch_forward(model, p, adjs, self_idx, X)
                return softmax_xent(logits, yb, wb), None

            loss, _, grads, _ = _value_and_grad(params, loss_fn)
            params = _sgd(params, grads, lr)
            losses.append(float(loss))
    # full-graph eval
    A = dense_adj(g, device)
    X, y, _, test_m = _graph_tensors(g, device)
    with torch.no_grad():
        logits = full_graph_forward(model, params, A, X)
    return MiniBatchResult(losses, float(accuracy(logits, y, test_m)),
                           hits / max(total, 1))


# ---------------------------------------------------------------------------
# LLCG (partition-based batches + global correction)
# ---------------------------------------------------------------------------


def llcg_train(g: Graph, *, model: str = "gcn", hidden: int = 32,
               num_parts: int = 4, rounds: int = 10, local_steps: int = 5,
               server_correct: bool = True, expand_hops: int = 0,
               lr: float = 0.5, seed: int = 0,
               device="cuda") -> FullGraphResult:
    """Learn-Locally-Correct-Globally: workers train on their partition
    batch (optionally expanded by ``expand_hops`` rings); their gradients
    are summed in worker order and averaged into one SGD step; the server
    then takes one full-graph step a round.  server_correct=False is plain
    PSGD-PA (the accuracy-loss baseline of §5.2)."""
    device = _device(device)
    part = PARTITIONERS["metis_like"](g, num_parts, seed=seed)
    num_classes = int(g.labels.max()) + 1
    dims = [g.features.shape[1], hidden, num_classes]
    params = _init(model, dims, seed, device)
    make_mb = (functools.partial(expanded_partition_minibatch, hops=expand_hops)
               if expand_hops else partition_minibatch)
    local_batches = []
    for w in range(num_parts):
        mb = make_mb(g, part, w)
        owned_local = np.searchsorted(mb.layer_vertices[0], mb.targets)
        local_batches.append((
            torch.as_tensor(mb.layer_adj[0], device=device),
            torch.as_tensor(mb.input_features, device=device),
            torch.as_tensor(mb.labels.astype(np.int64), device=device),
            torch.as_tensor(owned_local.astype(np.int64), device=device)))
    A = dense_adj(g, device)
    X, y, train_m, test_m = _graph_tensors(g, device)

    def global_loss(p, _):
        logits = full_graph_forward(model, p, A, X)
        return softmax_xent(logits, y, train_m), logits

    losses, logits = [], None
    for _ in range(rounds):
        for _ in range(local_steps):
            grad_acc, loss_sum = None, 0.0
            for A_l, X_l, y_l, owned in local_batches:
                def local_loss(p, _):
                    logits_l = full_graph_forward(model, p, A_l, X_l)
                    return softmax_xent(logits_l[owned], y_l), None

                loss, _, grads, _ = _value_and_grad(params, local_loss)
                loss_sum += float(loss)
                grad_acc = grads if grad_acc is None else [
                    a + b for a, b in zip(grad_acc, grads)]
            params = _sgd(params, [a / num_parts for a in grad_acc], lr)
            losses.append(loss_sum / num_parts)
        if server_correct:
            loss, logits, grads, _ = _value_and_grad(params, global_loss)
            params = _sgd(params, grads, lr)
            logits = logits.detach()
            losses.append(float(loss))
    if logits is None:
        with torch.no_grad():
            logits = full_graph_forward(model, params, A, X)
    return FullGraphResult(losses, float(accuracy(logits, y, train_m)),
                           float(accuracy(logits, y, test_m)))


def _pipegcn_train(g: Graph, *, model: str, hidden: int, epochs: int,
                   lr: float, partition: Optional[Partition], num_parts: int,
                   seed: int, device) -> FullGraphResult:
    """PipeGCN (survey Table 3): staleness-1 boundary embeddings in GA AND
    staleness-1 boundary gradients in grad-GA, through `pipegcn_mix`.  The
    first epoch runs with a zero mask (the warm-up that fills both
    histories); each epoch's fresh boundary cotangent (the gradient of the
    loss with respect to ``hist_g``, zero for the last layer, which the mix
    does not touch) is the next epoch's ``hist_g``.  Communication: every
    epoch pushes the boundary rows of the embeddings and the gradients
    once."""
    A = dense_adj(g, device)
    X, y, train_m, test_m = _graph_tensors(g, device)
    num_classes = int(g.labels.max()) + 1
    dims = [g.features.shape[1], hidden, num_classes]
    L = len(dims) - 1
    params = _init(model, dims, seed, device)
    part = partition or PARTITIONERS["metis_like"](g, num_parts, seed=seed)
    bmask_f = torch.as_tensor(boundary_mask_for(g, part).astype(np.float32),
                              device=device)
    V = g.num_vertices
    hist_h = [torch.zeros((V, d), dtype=torch.float32, device=device)
              for d in dims[1:]]
    hist_g = [torch.zeros((V, d), dtype=torch.float32, device=device)
              for d in dims[1:]]
    zero_mask = torch.zeros_like(bmask_f)

    losses, logits = [], None
    for e in range(epochs):
        # the warm-up epoch runs sync (no staleness) to fill the histories
        mask_f = zero_mask if e == 0 else bmask_f

        def loss_fn(p, hg):
            H, outs = X, []
            for l, pl in enumerate(p["layers"]):
                H = gnn_layer(model, pl, A, H, last=(l == L - 1))
                if l < L - 1:  # only embeddings the NEXT aggregation reads
                    H = pipegcn_mix(H, hist_h[l], hg[l], mask_f)
                outs.append(H)
            return softmax_xent(H, y, train_m), outs

        loss, outs, grads, fresh_g = _value_and_grad(params, loss_fn, hist_g)
        params = _sgd(params, grads, lr)
        hist_h = [o.detach() for o in outs]
        hist_g = fresh_g
        logits = hist_h[-1]
        losses.append(float(loss))
    rows = float(bmask_f.sum())
    bytes_pushed = epochs * rows * sum(dims[1:]) * 4.0 * 2  # h and g per epoch
    return FullGraphResult(losses, float(accuracy(logits, y, train_m)),
                           float(accuracy(logits, y, test_m)),
                           bytes_pushed=bytes_pushed)
