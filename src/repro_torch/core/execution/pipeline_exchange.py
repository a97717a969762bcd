"""Feature-chunked exchange (the port's copy of the chunking part of
`repro/core/execution/pipeline_exchange.py`).

The feature dimension is split into C static chunks; each chunk is
exchanged (table assembly) and then consumed (the ELL multiply).  Feature
columns are independent in every consumer, so the chunked result equals the
monolithic one column by column, and the gathered table held at once shrinks
to one chunk's width.  The reference issues chunk c+1's collective while
chunk c is consumed; with one rank nothing crosses a wire, so here the
chunks simply run in order.  The pad, the slices and the concatenation are
differentiable, so the training step's backward runs through the chunks too.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.utils import cdiv


def feature_chunks(D: int, num_chunks: int) -> int:
    """Effective static chunk count: clipped to [1, D]."""
    return max(1, min(int(num_chunks), int(D)))


def chunk_width(D: int, num_chunks: int) -> int:
    """Per-chunk feature width (ceil division)."""
    return cdiv(int(D), feature_chunks(D, num_chunks))


def zero_pad_row(h: torch.Tensor) -> torch.Tensor:
    """The one-row zero pad every gather table appends so pad/absent ids
    read zeros."""
    return h.new_zeros((1, h.shape[1]))


def chunked_overlap(h: torch.Tensor, num_chunks: int,
                    exchange_fn: Callable, consume_fn: Callable) -> torch.Tensor:
    """Per-feature-chunk exchange + consume: ``exchange_fn(h_chunk [rows,
    Dc])`` assembles one chunk's gather table and ``consume_fn(table) ->
    [out_rows, Dc]`` consumes it.  With C == 1 this is the monolithic
    exchange.  Uneven widths zero-pad the last chunk, as the reference."""
    rows, D = h.shape
    C = feature_chunks(D, num_chunks)
    if C <= 1:
        return consume_fn(exchange_fn(h))
    Dc = chunk_width(D, C)
    if C * Dc != D:
        h = torch.nn.functional.pad(h, (0, C * Dc - D))
    outs = [consume_fn(exchange_fn(h[:, c * Dc:(c + 1) * Dc].contiguous()))
            for c in range(C)]
    out = torch.cat(outs, dim=1)
    return out[:, :D] if C * Dc != D else out
