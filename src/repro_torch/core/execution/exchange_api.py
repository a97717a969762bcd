"""ExchangeBackend: the execution side of the partition-family interface (the
port's copy of the edge-cut broadcast part of
`repro/core/execution/exchange_api.py`).

`partition/layout_api.py` owns the static tables; a backend owns the
per-layer dataflow that assembles the gather table and runs the masked ELL
multiply.  A backend reads eng.{_ell, cfg, k} and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.core.execution.pipeline_exchange import (
    chunked_overlap,
    zero_pad_row,
)


class ExchangeBackend:
    def __init__(self, eng):
        self.eng = eng

    def aggregate(self, h_local, cl):
        """One layer's neighbor exchange + masked aggregation, normalized by
        the (global) degree: h_local [nb, D] -> agg [nb, D]."""
        raise NotImplementedError


class EdgeCutBackend(ExchangeBackend):
    """Halo exchange, feature-chunked.  Broadcast only: the table is every
    rank's block followed by one zero pad row.  With one rank the all_gather
    is the local block itself; the multi-rank slice adds the collective."""

    def exchange_fn(self, cl):
        """hc [nb, Dc] -> gather table [k*nb + 1, Dc]."""
        if self.eng.k != 1:
            raise NotImplementedError(
                "the broadcast all_gather arrives with the multi-rank slice")

        def exchange(hc):
            return torch.cat([hc, zero_pad_row(hc)], 0)
        return exchange

    def aggregate(self, h_local, cl):
        eng = self.eng
        ids, mask, deg = cl["ids"], cl["mask"], cl["deg"]
        agg = chunked_overlap(h_local, eng.cfg.exchange_chunks,
                              self.exchange_fn(cl),
                              lambda table: eng._ell(ids, mask, table))
        return agg / deg


BACKENDS = {
    "edge_cut": EdgeCutBackend,
}


def make_backend(eng) -> ExchangeBackend:
    return BACKENDS[eng.playout.family](eng)
