"""ExchangeBackend: the execution side of the partition-family interface (the
port's copy of the edge-cut part of `repro/core/execution/exchange_api.py`:
broadcast, ring and p2p, over `torch.distributed`).

`partition/layout_api.py` owns the static tables; a backend owns the
per-layer dataflow that assembles the gather table and runs the masked ELL
multiply (gcn, sage, gin) or the attention program (gat).  A backend reads
eng.{_ell, _ell_attend, _gat_softmax, cfg, k, rank} and nothing else.
Every step of it is differentiable: the training step runs it under
autograd, and the backward of every gather over the ELL table reads the
transpose plan in ``cl["plan"]`` (the ring: ``cl["plans"]``, one per source
block).
"""
from __future__ import annotations

import torch

from repro_torch.core.execution.collectives import (
    all_gather_rows,
    group_active,
    ring_rotate,
)
from repro_torch.core.execution.pipeline_exchange import (
    bucketed_all_to_all,
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


class EdgeCutBackend(ExchangeBackend):
    """Halo exchange.  broadcast: the table is every rank's block,
    all-gathered over the process group, followed by one zero pad row;
    without a process group (one rank) the local block is the whole table.
    p2p: the table is the rank's own block, the halo rows the other ranks
    ship it through the bucketed all_to_all installments, and the zero pad
    row.  Both are feature-chunked.  ring: the k blocks rotate past every
    rank in turn, and each round aggregates over the block it holds (the
    ring ignores exchange_chunks, as the reference's does)."""

    def exchange_fn(self, cl):
        """hc [nb, Dc] -> ``finish``, which returns the gather table
        ([k*nb + 1, Dc] broadcast, [nb + B*k*w + 1, Dc] p2p): the
        collectives are issued at once and waited on in ``finish``
        (`collectives.all_gather_rows`, `pipeline_exchange.
        bucketed_all_to_all`)."""
        if self.eng.cfg.execution == "p2p":
            send = cl["send"]

            def exchange(hc):
                hc = hc.contiguous()
                recv = bucketed_all_to_all(hc, send)
                return lambda: torch.cat([hc, recv(), zero_pad_row(hc)], 0)
            return exchange
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
        if eng.cfg.execution == "ring":
            return self._ring_aggregate(h_local, cl)
        ids, mask, deg, plan = cl["ids"], cl["mask"], cl["deg"], cl["plan"]
        agg = chunked_overlap(h_local, eng.cfg.exchange_chunks,
                              self.exchange_fn(cl),
                              lambda table: eng._ell(ids, mask, table, plan))
        return agg / deg

    def _ring_aggregate(self, h_local, cl):
        """The ring: per round the masked ELL multiply over the block it
        holds with that owner's ids and mask (pad slots id 0, mask 0: no
        zero row), its backward the transpose kernel over that owner's
        plan; summed in round order and normalized once after the last
        round (deg is the same in every round)."""
        eng = self.eng
        ids, mask, plans = cl["ids"], cl["mask"], cl["plans"]
        acc = None
        for owner, blk in ring_blocks(h_local.contiguous(), eng.k, eng.rank):
            part = eng._ell(ids[owner], mask[owner], blk, plans[owner])
            acc = part if acc is None else acc + part
        return acc / cl["deg"]

    def _gat_ring(self, p_l, Hw, cl):
        """Edge-cut ring GAT (the reference's `_gat_ring`): one pass of
        online softmax over the k rotating blocks [Hw | a_src.Hw], a running
        max (detached, as the reference's stop_gradient) and a rescale of
        the numerator and denominator each round: the exact masked softmax
        without a second max round.  Round 0 is the rank's own block with
        no rotation, then exactly k - 1 rotations.  The s-column gather
        differentiates through the slot transpose over the owner's plan;
        the attend reads a contiguous copy of the block's Hw columns.
        Round 0 starts num and den from its own terms (the reference's
        rescale of zeros by exp(-1e30 - m) adds nothing)."""
        eng = self.eng
        ids, mask, plans = cl["ids"], cl["mask"], cl["plans"]
        s_dst = (Hw @ p_l["a_dst"])[:, None]
        blk0 = torch.cat([Hw, (Hw @ p_l["a_src"])[:, None]], 1)
        m = num = den = None
        for owner, blk in ring_blocks(blk0, eng.k, eng.rank):
            ids_r, mask_r, plan_r = ids[owner], mask[owner], plans[owner]
            s_nbr = ell_slot_gather(blk[:, -1], ids_r, mask_r, plan=plan_r)
            e = torch.where(mask_r > 0, torch.nn.functional.leaky_relu(
                s_dst + s_nbr, 0.2), -1e30)
            m_round = torch.amax(e, dim=1, keepdim=True)
            m_new = (m_round if m is None
                     else torch.maximum(m, m_round)).detach()
            pw = torch.exp(e - m_new) * (e > -1e29)
            part = eng._ell_attend(ids_r, pw, blk[:, :-1].contiguous(), plan_r)
            if m is None:
                num, den = part, pw.sum(1, keepdim=True)
            else:
                sc = torch.exp(m - m_new)
                num = num * sc + part
                den = den * sc + pw.sum(1, keepdim=True)
            m = m_new
        return num, den

    def gat_layer(self, p_l, H, cl, last: bool):
        """Edge-cut GAT (the reference's branches, exactly); the ring runs
        `_gat_ring`.  broadcast or p2p:
        ONE fused exchange of F = [a_src.Hw | Hw] (width d_out + 1), the
        attention column riding as column 0 of chunk 0; the softmax weights
        come from chunk 0's table, once it has arrived and before any
        attend, every chunk is attended whole, and the Hw columns are sliced
        back out.  Pad slots stay inert and degree-0 rows fall back to their
        own Hw row.  The gather of the attention column differentiates
        through the slot transpose over the plan, not autograd's rule for
        ``col[ids]``."""
        eng = self.eng
        Hw = H @ p_l["w"]
        if eng.cfg.execution == "ring":
            num, den = self._gat_ring(p_l, Hw, cl)
            z = torch.where(den > 0, num / torch.clamp(den, min=1e-30), Hw)
            return z if last else torch.relu(z)
        ids, mask, plan = cl["ids"], cl["mask"], cl["plan"]
        exchange = self.exchange_fn(cl)
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
