"""GNN parameters (the port's counterpart of `repro/core/models/gnn.py`).

Parameters are a plain dict of tensors keyed like the JAX tree,
``{"layers": [{"w": [d_in, d_out], "b": [d_out]}, ...]}``.  Two ways in:
`init_gnn_params` draws fresh weights from a `torch.Generator` (the JAX
scheme's distribution, not its bits), and `params_from_numpy` carries the
reference's own weights over after ``jax.tree.map(np.asarray, params)``.
GCN only: the other models arrive with the model-axis slice.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch


def _require_gcn(model: str) -> None:
    if model != "gcn":
        raise NotImplementedError(
            f"model={model!r}: only gcn is ported; sage/gat/gin arrive with "
            "the model-axis slice")


def init_gnn_params(model: str, dims: Sequence[int], generator: torch.Generator,
                    device) -> Dict:
    """dims = [in, hidden, ..., out]; one layer per consecutive pair:
    w ~ normal / sqrt(fan_in), b = 0.  Drawn on the CPU generator, so the
    same seed gives the same weights on every device."""
    _require_gcn(model)
    layers = []
    for di, do in zip(dims[:-1], dims[1:]):
        w = torch.randn((di, do), generator=generator) / math.sqrt(di)
        layers.append({"w": w.to(device), "b": torch.zeros(do, device=device)})
    return {"layers": layers}


def params_from_numpy(tree: Dict, device) -> Dict:
    """The weight carry-over: a GCN params tree of numpy arrays (the JAX
    params after ``jax.tree.map(np.asarray, ...)``) as float32 tensors."""
    return {"layers": [
        {key: torch.from_numpy(np.array(p[key], np.float32)).to(device)
         for key in ("w", "b")}
        for p in tree["layers"]]}
