from repro_torch.core.protocols.async_hist import (
    STALENESS_MODELS,
    HistoricalState,
    PipeGCNState,
    block_refresh,
    epoch_adaptive_refresh,
    epoch_fixed_refresh,
    pipegcn_mix,
    variation_refresh,
)

__all__ = ["STALENESS_MODELS", "HistoricalState", "PipeGCNState",
           "block_refresh", "epoch_adaptive_refresh", "epoch_fixed_refresh",
           "pipegcn_mix", "variation_refresh"]
