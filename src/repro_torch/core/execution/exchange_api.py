"""ExchangeBackend: the execution side of the partition-family interface (the
port's copy of `repro/core/execution/exchange_api.py`: broadcast, ring and
p2p over `torch.distributed`, for the edge-cut family and for the replica
families).

`partition/layout_api.py` owns the static tables; a backend owns the
per-layer dataflow that assembles the gather table and runs the masked ELL
multiply (gcn, sage, gin) or the attention program (gat), and turns its
rank's uploaded tables into the device constants that dataflow reads
(`device_consts`: the transpose plans and the single-slot gather tables,
built once per engine).  A backend reads eng.{_ell, _ell_attend, _sddmm,
_gat_softmax, cfg, k, rank, nb, playout} and nothing else.  Every step of
it is differentiable: the training step runs it under autograd, and the
backward of every gather reads a transpose plan built in `device_consts`.

  EdgeCutBackend      halo exchange: neighbor rows cross the wire, then ONE
                      masked ELL multiply over the gathered table.
  ReplicaSyncBackend  partial aggregation over OWNED edges in replica-slot
                      space, then the replica-sync combine
                      (`execution/replica_sync.py`).  Two layout flags let
                      one backend serve both replica families:
                      ``sync_active`` (replicas exist) and ``halo_active``
                      (hybrid: the owned-edge ELL reads remote low-degree
                      rows through a halo table after the local block).

`combine_rows` sums per-slot rows across the replicas of each vertex (the
identity without replicas): the trainable embeddings' gradient and the
masters' delta take it.
"""
from __future__ import annotations

import torch

from repro_torch.core.execution.collectives import (
    all_gather_rows,
    group_active,
)
from repro_torch.core.execution.pipeline_exchange import (
    bucketed_all_to_all,
    chunk_width,
    chunked_overlap,
    feature_chunks,
    ring_blocks,
    send_installments,
    single_slot,
    zero_pad_row,
)
from repro_torch.core.execution.replica_sync import (
    replica_combine,
    replica_combine_max,
)
from repro_torch.kernels.ops import ell_slot_gather, ell_transpose_plan


class ExchangeBackend:
    has_replicas = False  # a vertex's rows live on several ranks

    def __init__(self, eng):
        self.eng = eng

    def device_consts(self, cl) -> dict:
        """The device constants the dataflow reads, built once from this
        rank's uploaded tables ``cl`` (the layout's `exchange_consts`)."""
        raise NotImplementedError

    def aggregate(self, h_local, cl):
        """One layer's neighbor exchange + masked aggregation, normalized by
        the (global) degree: h_local [nb, D] -> agg [nb, D]."""
        raise NotImplementedError

    def gat_layer(self, p_l, H, cl, last: bool):
        """One GAT layer: per-edge logits, masked segment-softmax and the
        attention-weighted gather-sum; H [nb, d_in] -> [nb, d_out]."""
        raise NotImplementedError

    def combine_rows(self, rows, cl):
        """Sum per-slot rows [nb, D] across the replicas of each vertex: the
        trainable embeddings' gradient and delta path.  The identity for a
        family without replicas."""
        return rows


class EdgeCutBackend(ExchangeBackend):
    """Halo exchange.  broadcast: the table is every rank's block,
    all-gathered over the process group, followed by one zero pad row;
    without a process group (one rank) the local block is the whole table.
    p2p: the table is the rank's own block, the halo rows the other ranks
    ship it through the bucketed all_to_all installments, and the zero pad
    row.  Both are feature-chunked.  ring: the k blocks rotate past every
    rank in turn, and each round aggregates over the block it holds (the
    ring ignores exchange_chunks, as the reference's does)."""

    def device_consts(self, cl) -> dict:
        """The CSR transpose of the ELL table over the gather table's rows
        (the ring: of each source block's ELL over its nb rows), read by
        every backward of a gather over it (every layer, chunk, round and
        step); p2p adds the send installments (`send_installments`)."""
        eng = self.eng
        rows = eng.playout.table_rows
        if eng.cfg.execution == "ring":
            return dict(plans=[ell_transpose_plan(i, m, rows)
                               for i, m in zip(cl["ids"], cl["mask"])])
        out = dict(plan=ell_transpose_plan(cl["ids"], cl["mask"], rows))
        if eng.cfg.execution == "p2p":
            out["send"] = send_installments(cl["send_rows"], cl["send_mask"],
                                            eng.nb)
        return out

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


class ReplicaSyncBackend(ExchangeBackend):
    """Owned-edge partial aggregation + replica-sync combine, with an
    optional halo table for hybrid layouts whose owned edges read remote
    (low-degree, never-replicated) source rows."""

    def __init__(self, eng):
        super().__init__(eng)
        lay = eng.playout
        self.sync_active = lay.sync_active
        self.halo_active = lay.halo_active
        self.has_replicas = self.sync_active

    def device_consts(self, cl) -> dict:
        """``plan``: the owned-edge ELL's transpose plan over its table
        [own slots | halo | zero row].  ``sync``: the combine's constants
        (`replica_sync` module docstring): broadcast ``rep`` = (rep_ids,
        rep_mask, plan over the k*nv + 1 gathered rows); ring ``ring`` =
        ring_ids as single-slot gathers, one plan per owner block; p2p the
        two send installments, ``gather`` = (gather_ids, gather_mask, plan
        over [own | received | zero]) and ``scatter`` = scatter_ids as a
        single-slot gather over [aggregate | received back].  ``halo``
        (hybrid): halo_src as a single-slot gather over the k*nv gathered
        rows, halo_ring as one per owner block over nv rows, or the
        halo_send installments."""
        eng = self.eng
        k, nv, ex = eng.k, eng.nb, eng.cfg.execution
        out = dict(plan=ell_transpose_plan(cl["ids"], cl["mask"],
                                           eng.playout.table_rows))
        if self.sync_active:
            if ex == "broadcast":
                sync = dict(rep=(cl["rep_ids"], cl["rep_mask"],
                                 ell_transpose_plan(cl["rep_ids"],
                                                    cl["rep_mask"],
                                                    k * nv + 1)))
            elif ex == "ring":
                sync = dict(ring=single_slot(cl["ring_ids"], nv, nv))
            else:
                rows1 = nv + cl["send1"].numel() + 1
                rows2 = nv + cl["send2"].numel()
                sync = dict(
                    send1=send_installments(cl["send1"], cl["send1_mask"], nv),
                    send2=send_installments(cl["send2"], cl["send2_mask"], nv),
                    gather=(cl["gather_ids"], cl["gather_mask"],
                            ell_transpose_plan(cl["gather_ids"],
                                               cl["gather_mask"], rows1)),
                    scatter=single_slot(cl["scatter_ids"], rows2, rows2))
            out["sync"] = sync
        if self.halo_active:
            if ex == "broadcast":
                out["halo"] = single_slot(cl["halo_src"], k * nv, k * nv)
            elif ex == "ring":
                out["halo"] = single_slot(cl["halo_ring"], nv, nv)
            else:
                out["halo"] = send_installments(cl["halo_send"],
                                                cl["halo_send_mask"], nv)
        return out

    def _halo_table(self, hc, cl):
        """Issue one feature chunk's gather table and return ``finish``:
        [local block (nv rows) | halo rows (canonical installment-major
        slots) | one zero row].  Without a halo the table is the vertex-cut
        [h | zero] form.  Each canonical halo slot has exactly ONE real
        source; under broadcast and the ring every other read is masked.
        The ring issues k - 1 rotations (the reference's scan issues k)."""
        eng = self.eng
        hc = hc.contiguous()
        if not self.halo_active:
            return lambda: torch.cat([hc, zero_pad_row(hc)], 0)
        execution = eng.cfg.execution
        if execution == "broadcast":
            ids, mask, plan = cl["halo"]
            gathered = all_gather_rows(hc)
            return lambda: torch.cat([hc, eng._ell(ids, mask, gathered(),
                                                   plan), zero_pad_row(hc)], 0)
        if execution == "ring":
            ids, mask, plans = cl["halo"]
            halo = None
            for owner, blk in ring_blocks(hc, eng.k, eng.rank):
                part = eng._ell(ids[owner], mask[owner], blk, plans[owner])
                halo = part if halo is None else halo + part
            return lambda: torch.cat([hc, halo, zero_pad_row(hc)], 0)
        recv = bucketed_all_to_all(hc, cl["halo"])
        return lambda: torch.cat([hc, recv(), zero_pad_row(hc)], 0)

    def _combine(self, part, cl):
        eng, c = self.eng, self.eng.cfg
        return replica_combine(c.execution, part, cl["sync"], k=eng.k,
                               rank=eng.rank, ell_fn=eng._ell,
                               num_chunks=c.exchange_chunks)

    def combine_rows(self, rows, cl):
        """The replica combine (`replica_combine`, chunked like a layer's)
        of per-slot rows, or the identity without replicas."""
        if not self.sync_active:
            return rows
        return self._combine(rows, cl)

    def aggregate(self, h_local, cl):
        """The owned-edge partial ELL over the gather table (chunked with
        the halo exchange when there is one), the replica combine (chunked),
        then / deg, the GLOBAL in-degree."""
        eng = self.eng
        ids, mask, plan = cl["ids"], cl["mask"], cl["plan"]

        def partial_of(table):
            return eng._ell(ids, mask, table, plan)

        if self.halo_active:
            partial = chunked_overlap(
                h_local, eng.cfg.exchange_chunks,
                lambda hc: self._halo_table(hc, cl), partial_of)
        else:
            partial = partial_of(self._halo_table(h_local, cl)())
        if self.sync_active:
            partial = self._combine(partial, cl)
        return partial / cl["deg"]

    def gat_layer(self, p_l, H, cl, last: bool):
        """GAT over owned edges: SDDMM logits over the gather table, the
        local max floored at 0 (any upper bound is a valid softmax shift,
        and the max combine needs values >= 0), the max combine across
        replicas (detached), exp(e - M) on the real slots, [ell_attend |
        sum of the weights] combined across replicas in one pass, then
        num / den, a row without real slots falling back to its own Hw.
        Without replicas (hybrid at threshold inf) both combines are the
        identity."""
        eng = self.eng
        c = eng.cfg
        ids, mask, plan = cl["ids"], cl["mask"], cl["plan"]
        Hw = H @ p_l["w"]
        table = self._halo_table(Hw, cl)()
        e = eng._sddmm(ids, mask, table, p_l["a_src"], p_l["a_dst"], plan)
        M = torch.clamp(torch.amax(e, dim=1, keepdim=True), min=0.0).detach()
        if self.sync_active:
            M = replica_combine_max(c.execution, M, cl["sync"], k=eng.k,
                                    rank=eng.rank)
        pw = torch.exp(e - M) * (e > -1e29)
        part = torch.cat([eng._ell_attend(ids, pw, table, plan),
                          pw.sum(1, keepdim=True)], 1)
        if self.sync_active:
            part = self._combine(part, cl)
        num, den = part[:, :-1], part[:, -1:]
        z = torch.where(den > 0, num / torch.clamp(den, min=1e-30), Hw)
        return z if last else torch.relu(z)


BACKENDS = {
    "edge_cut": EdgeCutBackend,
    "vertex_cut": ReplicaSyncBackend,
    "hybrid": ReplicaSyncBackend,
}


def make_backend(eng) -> ExchangeBackend:
    return BACKENDS[eng.playout.family](eng)
