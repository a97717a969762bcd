"""Feature-chunked exchange and the bucketed p2p installments (the port's
copy of `repro/core/execution/pipeline_exchange.py`).

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

from typing import Callable, List, Sequence, Tuple

import torch

from repro_torch.core.execution.collectives import (
    all_to_all_rows,
    group_active,
    ring_rotate,
)
from repro_torch.kernels.ops import ell_spmm, ell_transpose_plan
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


def send_installments(send_rows: torch.Tensor, send_mask: torch.Tensor,
                      rows: int) -> List[Tuple]:
    """This rank's p2p send table ([B, k, w] rows and mask, on the device)
    as one K = 1 ELL per installment, the ``send`` argument of
    `bucketed_all_to_all`: ids [k*w, 1] (destination d's rows at
    [d*w, (d+1)*w)), the mask that zeroes the pad entries, and the transpose
    plan over the ``rows`` source rows that its gather's backward reads."""
    send = []
    for ids, mask in zip(send_rows, send_mask):
        ids = ids.reshape(-1, 1).contiguous()
        mask = mask.reshape(-1, 1).contiguous()
        send.append((ids, mask, ell_transpose_plan(ids, mask, rows)))
    return send


def single_slot(ids: torch.Tensor, pad: int, rows: int) -> Tuple:
    """A row gather table[ids] whose pad entries (``ids == pad``) read 0, as
    a K = 1 ELL: (ids int32 [..., n, 1] with the pads at row 0, mask
    [..., n, 1] zero on the pads, the transpose plan over ``rows`` table
    rows, or one per leading index for a [k, n] table).  Written as the ELL
    forward, the gather's backward is the transpose kernel over its plan;
    autograd's own rule for ``table[ids]`` would add every pad entry into
    one row with atomics."""
    real = ids != pad
    ids = torch.where(real, ids, 0).to(torch.int32)[..., None].contiguous()
    mask = real.to(torch.float32)[..., None].contiguous()
    if ids.dim() == 2:
        return ids, mask, ell_transpose_plan(ids, mask, rows)
    return ids, mask, [ell_transpose_plan(i, m, rows)
                       for i, m in zip(ids, mask)]


def bucketed_all_to_all(h: torch.Tensor, send: Sequence[Tuple]
                        ) -> Callable[[], torch.Tensor]:
    """Issue the installment all_to_alls of this rank's rows h [nb, D] and
    return ``finish``, a call that waits on them and returns the received
    halo rows [B*k*w, D] in installment-major order (matching
    `bucketing.halo_slot`).  ``send`` holds, per installment b, the ELL
    (ids int32 [k*w, 1], mask [k*w, 1], transpose plan over h's rows) of
    the rows this rank ships: destination d's w rows at [d*w, (d+1)*w).

    Each installment gathers its send rows (the ELL kernel at K = 1) and
    issues one all_to_all of them before the next installment is gathered.
    A pad entry has mask 0 and ships a zero row where the reference ships
    h[0]; no id of the receiving table reads it.  Written as an ELL, the
    gather's backward is the transpose kernel over the installment's own
    plan, which sums a row sent to several ranks in a fixed order (an
    index_add_ would add them with atomics, in a different order each run).
    Without a process group one rank sends only to itself, and the exchange
    is the gather alone."""
    pending = []
    for ids, mask, plan in send:
        rows = ell_spmm(ids, mask, h, normalize=False, plan=plan)
        pending.append(all_to_all_rows(rows) if group_active()
                       else (lambda rows=rows: rows))

    def finish() -> torch.Tensor:
        recv = [fin() for fin in pending]
        return recv[0] if len(recv) == 1 else torch.cat(recv, 0)
    return finish


def ring_blocks(h, k: int, me: int):
    """The ring's rounds over this rank's rows h [nb, D]: yields (owner,
    block) for r = 0 .. k-1, round r holding owner (me + r) % k's block.
    Round 0 is h itself; each later block is the previous one rotated
    (`collectives.ring_rotate`), and rotation r + 1 is issued before round
    r is yielded, so it flies while the caller consumes round r.  Exactly
    k - 1 rotations: at k = 1 none (the reference's gcn scan issues a k-th
    whose output is never read; the wire bytes are analytic and do not
    change)."""
    pending = ring_rotate(h) if k > 1 else None
    for r in range(k):
        if r:
            h = pending()
            pending = ring_rotate(h) if r + 1 < k else None
        yield (me + r) % k, h
