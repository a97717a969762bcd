"""Communication cost models (the port's copy of the edge-cut part of
`repro/core/partition/cost_models.py`): the standalone models the engine's
CommStats accounting is cross-checked against."""
from __future__ import annotations

from typing import Sequence

FEAT_BYTES = 4


def model_exchange_widths(model: str, dims: Sequence[int],
                          family: str = "edge_cut") -> list:
    """Per-layer floats per exchanged row: gcn/sage/gin ship the layer's
    INPUT rows (width dims[l]); gat ships the transformed rows plus one
    attention-coefficient column (two under vertex_cut)."""
    L = len(dims) - 1
    if model == "gat":
        extra = 2 if family == "vertex_cut" else 1
        return [int(dims[l + 1]) + extra for l in range(L)]
    return [int(d) for d in dims[:-1]]


def inference_bytes_per_sweep(execution: str, dims: Sequence[int], *,
                              model: str = "gcn", k: int, nb: int,
                              feat_bytes: int = FEAT_BYTES) -> int:
    """Wire bytes of ONE layer-wise full-graph inference sweep under the
    edge-cut family: every layer runs its exchange once at that layer's
    model-dependent width.  broadcast/ring: every device gathers the other
    k-1 padded blocks per layer, k*(k-1)*nb rows.  (The p2p branch needs the
    halo need sets and arrives with the multi-rank slice.)"""
    if execution not in ("broadcast", "ring"):
        raise NotImplementedError(
            f"inference_bytes_per_sweep({execution!r}): only broadcast/ring "
            "are ported; p2p arrives with the multi-rank slice")
    widths = model_exchange_widths(model, dims, "edge_cut")
    rows = k * (k - 1) * int(nb)
    return rows * int(sum(widths)) * feat_bytes
