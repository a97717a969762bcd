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
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

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
