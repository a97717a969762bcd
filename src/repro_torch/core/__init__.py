"""The port's distributed GNN engine and its host layer (the counterpart of
`repro/core`): graphs, partitioning, batch generation, execution models,
communication protocols, GNN models and the training loops.

Exports resolve LAZILY (PEP 562): `repro_torch.core.training` imports
torch, but the process-pool sampling workers import numpy-only submodules
of this package and must not import torch just for touching
``repro_torch.core``.
"""
from typing import TYPE_CHECKING

_EXPORTS = {
    "Graph": "repro_torch.core.graph",
    "er_graph": "repro_torch.core.graph",
    "from_edges": "repro_torch.core.graph",
    "powerlaw_graph": "repro_torch.core.graph",
    "sbm_graph": "repro_torch.core.graph",
    "FullGraphResult": "repro_torch.core.training",
    "MiniBatchResult": "repro_torch.core.training",
    "full_graph_train": "repro_torch.core.training",
    "llcg_train": "repro_torch.core.training",
    "minibatch_train": "repro_torch.core.training",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


if TYPE_CHECKING:  # static analyzers see the eager imports
    from repro_torch.core.graph import (  # noqa: F401
        Graph,
        er_graph,
        from_edges,
        powerlaw_graph,
        sbm_graph,
    )
    from repro_torch.core.training import (  # noqa: F401
        FullGraphResult,
        MiniBatchResult,
        full_graph_train,
        llcg_train,
        minibatch_train,
    )
