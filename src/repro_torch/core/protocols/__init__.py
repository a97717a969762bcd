"""Communication protocols (survey §7): the synchronous protocols' cost
model (`sync`) and the asynchronous historical-embedding protocols
(`async_hist`).

Exports resolve LAZILY (PEP 562), as the rest of ``repro_torch.core``'s:
`async_hist` imports torch, `sync` does not.
"""
from typing import TYPE_CHECKING

_EXPORTS = {
    "STALENESS_MODELS": "repro_torch.core.protocols.async_hist",
    "HistoricalState": "repro_torch.core.protocols.async_hist",
    "PipeGCNState": "repro_torch.core.protocols.async_hist",
    "block_refresh": "repro_torch.core.protocols.async_hist",
    "epoch_adaptive_refresh": "repro_torch.core.protocols.async_hist",
    "epoch_fixed_refresh": "repro_torch.core.protocols.async_hist",
    "pipegcn_mix": "repro_torch.core.protocols.async_hist",
    "variation_refresh": "repro_torch.core.protocols.async_hist",
    "FEAT_BYTES": "repro_torch.core.protocols.sync",
    "PROTOCOL_COSTS": "repro_torch.core.protocols.sync",
    "ProtocolCost": "repro_torch.core.protocols.sync",
    "broadcast_cost": "repro_torch.core.protocols.sync",
    "p2p_cost": "repro_torch.core.protocols.sync",
    "pipeline_cost": "repro_torch.core.protocols.sync",
    "remote_partial_aggregation_cost": "repro_torch.core.protocols.sync",
    "shared_memory_cost": "repro_torch.core.protocols.sync",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


if TYPE_CHECKING:  # static analyzers see the eager imports
    from repro_torch.core.protocols.async_hist import (  # noqa: F401
        STALENESS_MODELS,
        HistoricalState,
        PipeGCNState,
        block_refresh,
        epoch_adaptive_refresh,
        epoch_fixed_refresh,
        pipegcn_mix,
        variation_refresh,
    )
    from repro_torch.core.protocols.sync import (  # noqa: F401
        FEAT_BYTES,
        PROTOCOL_COSTS,
        ProtocolCost,
        broadcast_cost,
        p2p_cost,
        pipeline_cost,
        remote_partial_aggregation_cost,
        shared_memory_cost,
    )
