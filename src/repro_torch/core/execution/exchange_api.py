"""ExchangeBackend: the execution side of the partition-family interface (the
port's copy of the edge-cut broadcast part of
`repro/core/execution/exchange_api.py`, over `torch.distributed`).

`partition/layout_api.py` owns the static tables; a backend owns the
per-layer dataflow that assembles the gather table and runs the masked ELL
multiply (gcn, sage, gin) or the attention program (gat).  A backend reads
eng.{_ell, _ell_attend, _gat_softmax, cfg} and nothing else.  Every step
of it is differentiable: the training step runs it under autograd, and the
backward of every gather over the ELL table reads the transpose plan in
``cl["plan"]``.
"""
from __future__ import annotations

import torch

from repro_torch.core.execution.collectives import (
    all_gather_rows,
    group_active,
)
from repro_torch.core.execution.pipeline_exchange import (
    chunk_width,
    chunked_overlap,
    feature_chunks,
    zero_pad_row,
)
from repro_torch.kernels.ops import ell_slot_gather


class ExchangeBackend:
    def __init__(self, eng):
        self.eng = eng

    def aggregate(self, h_local, cl):
        """One layer's neighbor exchange + masked aggregation, normalized by
        the (global) degree: h_local [nb, D] -> agg [nb, D]."""
        raise NotImplementedError

    def gat_layer(self, p_l, H, cl, last: bool):
        """One GAT layer: per-edge logits, masked segment-softmax and the
        attention-weighted gather-sum; H [nb, d_in] -> [nb, d_out]."""
        raise NotImplementedError


class EdgeCutBackend(ExchangeBackend):
    """Halo exchange, feature-chunked.  Broadcast only: the table is every
    rank's block, all-gathered over the process group, followed by one zero
    pad row.  Without a process group (one rank) the local block is the
    whole table."""

    def exchange_fn(self, cl):
        """hc [nb, Dc] -> ``finish``, which returns the gather table
        [k*nb + 1, Dc]: the all_gather is issued at once and waited on in
        ``finish`` (`collectives.all_gather_rows`)."""
        if not group_active():
            def exchange(hc):
                return lambda: torch.cat([hc, zero_pad_row(hc)], 0)
            return exchange

        def exchange(hc):
            gathered = all_gather_rows(hc.contiguous())
            return lambda: torch.cat([gathered(), zero_pad_row(hc)], 0)
        return exchange

    def aggregate(self, h_local, cl):
        eng = self.eng
        ids, mask, deg, plan = cl["ids"], cl["mask"], cl["deg"], cl["plan"]
        agg = chunked_overlap(h_local, eng.cfg.exchange_chunks,
                              self.exchange_fn(cl),
                              lambda table: eng._ell(ids, mask, table, plan))
        return agg / deg

    def gat_layer(self, p_l, H, cl, last: bool):
        """Edge-cut GAT, broadcast (the reference's branch, exactly): ONE
        fused exchange of F = [a_src.Hw | Hw] (width d_out + 1), the
        attention column riding as column 0 of chunk 0; the softmax weights
        come from chunk 0's table, once it has arrived and before any
        attend, every chunk is attended whole, and the Hw columns are sliced
        back out.  Pad slots stay inert and degree-0 rows fall back to their
        own Hw row.  The gather of the attention column differentiates
        through the slot transpose over the plan, not autograd's rule for
        ``col[ids]``."""
        eng = self.eng
        ids, mask, plan = cl["ids"], cl["mask"], cl["plan"]
        exchange = self.exchange_fn(cl)
        Hw = H @ p_l["w"]
        s_dst = (Hw @ p_l["a_dst"])[:, None]
        F = torch.cat([(Hw @ p_l["a_src"])[:, None], Hw], 1)
        Dtot = F.shape[1]  # d_out + 1
        C = feature_chunks(Dtot, eng.cfg.exchange_chunks)
        softmax = []  # (pw, den), from chunk 0's table

        def softmax_from(tab0):
            s_nbr = ell_slot_gather(tab0[:, 0], ids, mask, plan=plan)
            e = torch.where(mask > 0, torch.nn.functional.leaky_relu(
                s_dst + s_nbr, 0.2), -1e30)
            softmax.extend(eng._gat_softmax(e))

        if C <= 1:
            tab = exchange(F)()
            softmax_from(tab)
            num = eng._ell_attend(ids, softmax[0], tab[:, 1:].contiguous(),
                                  plan)
        else:
            def attend(table):
                if not softmax:
                    softmax_from(table)
                return eng._ell_attend(ids, softmax[0], table, plan)

            # pad F to whole chunks here, so the one slice below cuts both
            # the s-column's attend (column 0, unused) and the pad columns
            # (which attend to zero)
            Dc = chunk_width(Dtot, C)
            if C * Dc != Dtot:
                F = torch.nn.functional.pad(F, (0, C * Dc - Dtot))
            num = chunked_overlap(F, C, exchange, attend)[:, 1:Dtot]
        den = softmax[1]
        z = torch.where(den > 0, num / torch.clamp(den, min=1e-30), Hw)
        return z if last else torch.relu(z)


BACKENDS = {
    "edge_cut": EdgeCutBackend,
}


def make_backend(eng) -> ExchangeBackend:
    return BACKENDS[eng.playout.family](eng)
