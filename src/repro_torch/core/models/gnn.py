"""GNN parameters (the port's counterpart of `repro/core/models/gnn.py`).

Parameters are a plain dict of tensors keyed like the JAX tree,
``{"layers": [{key: tensor, ...}, ...]}`` with the keys of `PARAM_KEYS`:
gcn ``{"w": [d_in, d_out], "b": [d_out]}``, sage ``{"w_self", "w_nbr":
[d_in, d_out], "b": [d_out]}``, gat ``{"w": [d_in, d_out], "a_src": [d_out],
"a_dst": [d_out]}``, gin ``{"w1": [d_in, d_out], "w2": [d_out, d_out],
"eps": []}``.  Two ways in: `init_gnn_params` draws fresh weights from a
`torch.Generator` (the JAX scheme's distribution, not its bits), and
`params_from_numpy` carries the reference's own weights over after
``jax.tree.map(np.asarray, params)``.  The loss and the accuracy are copies
of the reference's `softmax_xent` and `accuracy`.

`gnn_layer`, `full_graph_forward`, `minibatch_forward` and
`padded_minibatch_forward` are the reference's models over dense normalized
blocks, the single-device trainers' and the sampled mini-batch step's
forward: plain fp32 products (`A @ H`), as the reference computes them
outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


# each model's per-layer parameter keys, in a fixed order (the order the
# training step flattens and all-reduces them in)
PARAM_KEYS = {"gcn": ("w", "b"), "sage": ("w_self", "w_nbr", "b"),
              "gat": ("w", "a_src", "a_dst"), "gin": ("w1", "w2", "eps")}


def init_gnn_params(model: str, dims: Sequence[int], generator: torch.Generator,
                    device) -> Dict:
    """dims = [in, hidden, ..., out]; one layer per consecutive pair, as the
    reference draws them: every matrix ~ normal / sqrt(fan_in); gcn's and
    sage's b = 0; gat's a_src, a_dst ~ normal / sqrt(d_out) of shape
    [d_out], no bias; gin's w2 [d_out, d_out] and eps a 0-d zero.  Drawn on
    the CPU generator, so the same seed gives the same weights on every
    device and every rank."""
    if model not in PARAM_KEYS:
        raise ValueError(f"model must be one of {tuple(PARAM_KEYS)}; got "
                         f"{model!r}")

    def dense(di, do):
        return torch.randn((di, do), generator=generator) / math.sqrt(di)

    layers = []
    for di, do in zip(dims[:-1], dims[1:]):
        if model == "gcn":
            p = {"w": dense(di, do), "b": torch.zeros(do)}
        elif model == "sage":
            p = {"w_self": dense(di, do), "w_nbr": dense(di, do),
                 "b": torch.zeros(do)}
        elif model == "gat":
            p = {"w": dense(di, do), "a_src": dense(do, 1)[:, 0],
                 "a_dst": dense(do, 1)[:, 0]}
        else:
            p = {"w1": dense(di, do), "w2": dense(do, do),
                 "eps": torch.zeros(())}
        layers.append({key: t.to(device) for key, t in p.items()})
    return {"layers": layers}


def params_from_numpy(tree: Dict, device) -> Dict:
    """The weight carry-over: a params tree of numpy arrays (the JAX params
    after ``jax.tree.map(np.asarray, ...)``), any model's keys, as float32
    tensors of the same shapes (gin's 0-d eps stays 0-d)."""
    return {"layers": [
        {key: torch.from_numpy(np.array(a, np.float32)).to(device)
         for key, a in p.items()}
        for p in tree["layers"]]}


def gnn_layer(model: str, p: Dict, A: torch.Tensor, H_src: torch.Tensor,
              self_idx: Optional[torch.Tensor] = None, *, last: bool = False,
              aggregate: Optional[Callable] = None) -> torch.Tensor:
    """One layer.  A [n_dst, n_src] (normalized); H_src [n_src, d_in];
    self_idx maps dst rows into src rows (the self features of sage, gin
    and gat; gcn reads none: its self loop is folded into A).  The self rows are an `index_select`: its backward adds each
    row's cotangent into the row it read, and the real rows read distinct
    rows (pad rows all read row 0 with a zero cotangent), so no two
    non-zero terms meet in one row.  gat: a dense masked softmax over the
    block; rows with no real neighbor fall back to their own Hw row."""
    agg = aggregate if aggregate is not None else (lambda A_, H_: A_ @ H_)
    H_self = (H_src if self_idx is None or model == "gcn"
              else torch.index_select(H_src, 0, self_idx))
    if model == "gcn":
        z = agg(A, H_src) @ p["w"] + p["b"]
    elif model == "sage":
        z = H_self @ p["w_self"] + agg(A, H_src) @ p["w_nbr"] + p["b"]
    elif model == "gat":
        Hw_src = H_src @ p["w"]
        Hw_dst = H_self @ p["w"]
        e = (Hw_dst @ p["a_dst"])[:, None] + (Hw_src @ p["a_src"])[None, :]
        e = torch.nn.functional.leaky_relu(e, 0.2)
        mask = A > 0
        off = ~mask
        e = e.masked_fill(off, -1e30)
        att = torch.softmax(e, dim=1).masked_fill(off, 0.0)
        del off
        # rows whose slots are ALL masked (isolated vertices, padded rows)
        # fall back to the self row Hw_dst instead of emitting zeros: the
        # padded-engine contract, and what the full-graph gat computes
        has_nbr = mask.any(dim=1, keepdim=True)
        z = torch.where(has_nbr, att @ Hw_src, Hw_dst)
    elif model == "gin":
        z = (1 + p["eps"]) * H_self + agg(A, H_src)
        z = torch.relu(z @ p["w1"]) @ p["w2"]
    else:
        raise ValueError(model)
    return z if last else torch.relu(z)


def full_graph_forward(model: str, params: Dict, A: torch.Tensor,
                       X: torch.Tensor,
                       aggregate: Optional[Callable] = None) -> torch.Tensor:
    """The model over the whole graph's dense normalized adjacency A
    [V, V] (the single-device trainers' forward); ``aggregate`` replaces
    the ``A @ H`` product (`core/execution/chunk.py`)."""
    H = X
    L = len(params["layers"])
    for l, p in enumerate(params["layers"]):
        H = gnn_layer(model, p, A, H, self_idx=None, last=(l == L - 1),
                      aggregate=aggregate)
    return H


def minibatch_forward(model: str, params: Dict, layer_adj: List[torch.Tensor],
                      self_indices: List[torch.Tensor],
                      X: torch.Tensor) -> torch.Tensor:
    H = X
    L = len(params["layers"])
    for l, p in enumerate(params["layers"]):
        H = gnn_layer(model, p, layer_adj[l], H, self_idx=self_indices[l],
                      last=(l == L - 1))
    return H


def padded_minibatch_forward(params: Dict, layer_adj: Sequence[torch.Tensor],
                             X: torch.Tensor, *, model: str = "gcn",
                             self_idx: Optional[Sequence[torch.Tensor]] = None
                             ) -> torch.Tensor:
    """The model over statically PADDED dense sampled blocks (the engine's
    mini-batch contract), each layer by `gnn_layer`: self loops are folded
    into the row-normalized blocks, so gcn is H <- A_l @ H @ W + b; sage,
    gin and gat read their resident self features through ``self_idx``
    (self_idx[l] maps layer-(l+1) rows into layer-l rows; pad rows point at
    slot 0, inert: pad rows and columns of A_l are zero).  Required for
    every model but gcn."""
    if model != "gcn" and self_idx is None:
        raise ValueError(f"model={model!r} needs self_idx (resident self "
                         "features); only gcn folds self into the blocks")
    H = X
    L = len(params["layers"])
    for l, p in enumerate(params["layers"]):
        si = None if self_idx is None else self_idx[l]
        H = gnn_layer(model, p, layer_adj[l], H, self_idx=si,
                      last=(l == L - 1))
    return H


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    loss = lse - ll
    if mask is not None:
        return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss.mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    correct = (torch.argmax(logits, -1) == labels).float()
    if mask is not None:
        return (correct * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return correct.mean()
