"""Feature-chunked exchange (the port's copy of the chunking part of
`repro/core/execution/pipeline_exchange.py`).

The feature dimension is split into C static chunks; each chunk is
exchanged (table assembly) and then consumed (the ELL multiply).  Feature
columns are independent in every consumer, so the chunked result equals the
monolithic one column by column, and the gathered table held at once shrinks
to one chunk's width.  As in the reference, chunk c+1's collective is
issued before chunk c is consumed and waited on just before its own
consume reads it, so at most two chunk tables are in flight (without a
process group the "collective" is the table assembly itself and the chunks
simply run in order).  The pad, the slices and the concatenation are
differentiable, so the training step's backward runs through the chunks
too; each chunk's collective carries its own gradient.
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
    """Per-feature-chunk exchange + consume, double-buffered:
    ``exchange_fn(h_chunk [rows, Dc])`` issues one chunk's exchange and
    returns ``finish``, a call that waits on it and returns the chunk's
    gather table; ``consume_fn(table) -> [out_rows, Dc]`` consumes it.
    Chunk c+1 is issued before chunk c is finished and consumed.  With
    C == 1 this is the monolithic exchange.  Uneven widths zero-pad the
    last chunk, as the reference."""
    rows, D = h.shape
    C = feature_chunks(D, num_chunks)
    if C <= 1:
        return consume_fn(exchange_fn(h)())
    Dc = chunk_width(D, C)
    if C * Dc != D:
        h = torch.nn.functional.pad(h, (0, C * Dc - D))

    def issue(c):
        return exchange_fn(h[:, c * Dc:(c + 1) * Dc].contiguous())

    outs, pending = [], issue(0)
    for c in range(C):
        finish, pending = pending, issue(c + 1) if c + 1 < C else None
        outs.append(consume_fn(finish()))
    out = torch.cat(outs, dim=1)
    return out[:, :D] if C * Dc != D else out
