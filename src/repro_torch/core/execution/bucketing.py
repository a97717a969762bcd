"""Power-of-two bucketed p2p installment layout (the port's copy of
`repro/core/execution/bucketing.py`, numpy only).

The first three helpers define the STATIC slot layout of the bucketed p2p halo
exchange: the installment widths, the gather-table slot of a halo row, and
the matching [k, B, k, w] send table.  The collective that reads them is
`pipeline_exchange.bucketed_all_to_all`.  `bucketed_send_mask` (the
port's own) marks the send entries that carry a need row: the port's send
gather ships zeros on the rest.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def bucketed_cap_widths(cap: int, buckets: int) -> List[int]:
    """Split a max-pairwise p2p cap into equal power-of-two installment
    widths whose sum covers ``cap``.

    ``buckets`` bounds the number of installments (collective rounds); the
    width is the smallest power of two with ``width * buckets >= cap``, so
    each round's all_to_all operand shrinks about ``buckets``-fold while at
    most ``buckets`` rounds ship the same rows.  With ``buckets <= 1`` (or a
    cap too small to split) the plan is unchanged: ``[cap]``.
    """
    cap, buckets = int(cap), int(buckets)
    if buckets <= 1 or cap <= 1:
        return [max(cap, 1)]
    w = 1
    while w * buckets < cap:
        w *= 2
    n = -(-cap // w)
    if n <= 1:
        return [cap]
    return [w] * n


def halo_slot(t, s, width: int, k: int, base: int):
    """Gather-table slot of halo row ``t`` (position in a pair's need list)
    from source ``s`` under the bucketed installment layout: the receive
    table is ``concat(recv_round_0 [k*w], recv_round_1 [k*w], ...)`` appended
    after ``base`` local rows.  Vectorizes over numpy arrays ``t``/``s``;
    with a single installment (w == cap) this is the classic
    ``base + s*cap + t`` layout."""
    b = t // width
    return base + b * (k * width) + s * width + (t % width)


def bucketed_send_table(need: Sequence[Sequence[np.ndarray]], k: int,
                        widths: List[int]) -> np.ndarray:
    """[k, B, k, w] send table from per-(src, dst) need lists under the
    power-of-two installment layout: pair (s, d)'s rows t land in installment
    t // w at offset t % w, the write side matching `halo_slot`'s read side.
    ``need[s][d]`` lists the local row ids source s ships to destination d."""
    B, w = len(widths), widths[0]
    send = np.zeros((k, k, B * w), np.int32)
    for s in range(k):
        for d in range(k):
            send[s, d, : len(need[s][d])] = need[s][d]
    return send.reshape(k, k, B, w).transpose(0, 2, 1, 3).copy()


def bucketed_send_mask(counts: np.ndarray, widths: List[int]) -> np.ndarray:
    """[k, B, k, w] float32 mask of `bucketed_send_table`'s layout: 1 on the
    entries that carry one of pair (s, d)'s ``counts[s, d]`` need rows, 0 on
    the pad entries."""
    k = counts.shape[0]
    B, w = len(widths), widths[0]
    fill = np.arange(B * w)[None, None, :] < counts[:, :, None]
    return fill.astype(np.float32).reshape(k, k, B, w).transpose(
        0, 2, 1, 3).copy()
