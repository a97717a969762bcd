"""Optimizers over trees of tensors (the port's `repro/optim`)."""
from repro_torch.optim.optimizers import (
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    clip_by_global_norm_,
    cosine_schedule,
    global_norm,
    make_optimizer,
    sgdm,
)
from repro_torch.optim.sparse_optim import (
    row_adamw_update,
    sparse_adamw,
    sparse_adamw_ids,
)

__all__ = [
    "Optimizer",
    "adafactor",
    "adamw",
    "clip_by_global_norm",
    "clip_by_global_norm_",
    "cosine_schedule",
    "global_norm",
    "make_optimizer",
    "row_adamw_update",
    "sgdm",
    "sparse_adamw",
    "sparse_adamw_ids",
]
