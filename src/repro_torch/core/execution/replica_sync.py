"""Replica-sync exchange for the replica families (the port's copy of
`repro/core/execution/replica_sync.py`): the Gather-ApplyEdge-Scatter
dataflow over replicated vertices.

Each rank computes PARTIAL aggregations over its owned edges (a local ELL
multiply in replica-slot space); this module combines those partials across
every replica of a vertex so all replicas see the full neighbor sum.  Three
collective families mirror the edge-cut exchange:

  broadcast  all_gather every rank's partial block; each rank sums its
             slots' replicas out of the gathered table (the ELL forward
             over ``rep_ids``, K = Rm).
  ring       rotate the partial blocks around the ring (k - 1 rotations);
             each rank adds the visiting block's row of each of its slots.
  p2p        master-based two-phase GAS: replicas ship partials to each
             vertex's MASTER (all_to_all installments), the master combines
             (the ELL forward over ``gather_ids``), then ships the finished
             aggregate back to the replicas (a second set of installments)
             and each slot reads its row of that table.

The plan half (`build_replica_sync_plan`) is numpy, built once from a
`VertexCutLayout`, and equal to the reference's array for array.  The
device half runs under autograd: every gather that feeds a gradient is the
ELL forward kernel (a single-slot row gather is the ELL at K = 1 with its
pad entries masked), whose backward is the transpose kernel over a plan
the engine builds once, never autograd's ``index_select`` rule, which would
pile every pad entry onto one zero row with atomics.  The all_gather's
backward is a reduce-scatter, the all_to_all's the reverse all_to_all and
the rotation's the reverse rotation (`collectives.py`).  The max combine
(GAT's softmax stabilizer) carries no gradient and runs on detached
tensors.

The device half reads ``cons``, this rank's device constants (see
`ReplicaSyncBackend`): ``rep`` (ids, mask, plan) under broadcast, ``ring``
(ids [k, nv, 1], mask, plans) under the ring, and under p2p ``send1`` and
``send2`` (`pipeline_exchange.bucketed_all_to_all` installments),
``gather`` (ids, mask, plan) and ``scatter`` (ids [nv, 1], mask, plan).
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core.execution.bucketing import (
    bucketed_cap_widths,
    bucketed_send_mask,
    bucketed_send_table,
    halo_slot,
)
from repro_torch.core.execution.collectives import (
    all_gather_rows,
    group_active,
)
from repro_torch.core.execution.pipeline_exchange import (
    bucketed_all_to_all,
    chunked_overlap,
    ring_blocks,
    zero_pad_row,
)
from repro_torch.core.partition.vertex_layout import VertexCutLayout

REPLICA_EXECUTIONS = ("broadcast", "ring", "p2p")


def _vertex_replica_tables(lay: VertexCutLayout):
    """Per-vertex replica tables: rep_flat[v, r] = flat slot (d*nv + slot) of
    v's r-th replica (pad k*nv), rep_part[v, r] = its rank (pad -1).
    Replicas are ordered by rank."""
    k, nv = lay.k, lay.nv
    V = lay.slot_of.shape[1]
    parts, verts = np.nonzero(lay.slot_of >= 0)
    order = np.argsort(verts, kind="stable")
    v_s, p_s = verts[order], parts[order]
    flat = p_s * nv + lay.slot_of[p_s, v_s]
    newv = np.r_[0, (np.diff(v_s) != 0).astype(np.int64)]
    first = np.r_[0, np.flatnonzero(np.diff(v_s)) + 1]
    pos = np.arange(len(v_s)) - first[np.cumsum(newv)]
    rep_flat = np.full((V, lay.Rm), k * nv, np.int64)
    rep_part = np.full((V, lay.Rm), -1, np.int64)
    rep_flat[v_s, pos] = flat
    rep_part[v_s, pos] = p_s
    return rep_flat, rep_part


def _need_lists(src_rank: np.ndarray, dst_rank: np.ndarray, key: np.ndarray,
                rows: np.ndarray, k: int, V: int):
    """Per-(src, dst) send lists: entry i ships local row ``rows[i]`` of
    rank ``src_rank[i]`` to ``dst_rank[i]``; each list is ordered by
    ``key`` (a vertex id or a slot).  Returns (need[s][d], counts [k, k],
    the position of each entry in its list)."""
    pair = src_rank * k + dst_rank
    order = np.lexsort((key, pair))
    ps = pair[order]
    counts = np.bincount(ps, minlength=k * k).reshape(k, k)
    starts = np.r_[0, np.cumsum(counts.reshape(-1))[:-1]]
    pos = np.empty(len(pair), np.int64)
    pos[order] = np.arange(len(ps)) - starts[ps]
    split = np.split(rows[order], np.cumsum(counts.reshape(-1))[:-1])
    need = [[split[s * k + d] for d in range(k)] for s in range(k)]
    return need, counts, pos


def build_replica_sync_plan(lay: VertexCutLayout, masters: np.ndarray,
                            execution: str, buckets: int = 1) -> Dict:
    """Static exchange plan for one collective family.  Every returned dict
    carries ``rows_per_layer``: the TRUE number of replica rows that cross
    the wire per GNN layer (padding excluded), which the engine's CommStats
    accounting and the standalone cost model both reproduce.

    ``buckets`` > 1 splits the p2p send caps (c1/c2, the max pairwise need)
    into power-of-two installments; the wire rows are unchanged.  The
    reference builds the p2p lists with loops over every rank pair; here one
    lexsort orders every (rank, master) entry at once, with the same lists.
    p2p also returns ``send1_mask`` and ``send2_mask`` (1 on the entries
    that carry a need row, `bucketing.bucketed_send_mask`)."""
    if execution not in REPLICA_EXECUTIONS:
        raise ValueError(f"execution must be one of {REPLICA_EXECUTIONS}")
    k, nv, Rm = lay.k, lay.nv, lay.Rm
    V = lay.slot_of.shape[1]
    vert_ids = lay.vert_ids
    rep_flat, rep_part = _vertex_replica_tables(lay)
    if execution == "broadcast":
        pad_row = np.full((1, Rm), k * nv, np.int64)
        rep_ids = np.concatenate([rep_flat, pad_row], 0)[vert_ids]
        return dict(execution=execution,
                    rep_ids=rep_ids.astype(np.int32),
                    rep_mask=(rep_ids < k * nv).astype(np.float32),
                    rows_per_layer=k * (k - 1) * nv)
    if execution == "ring":
        slot_ext = np.concatenate(
            [lay.slot_of, np.full((k, 1), -1, np.int64)], 1)  # col V = pad
        tmp = slot_ext[:, vert_ids.reshape(-1)].reshape(k, k, nv)
        ring_ids = np.where(tmp < 0, nv, tmp).transpose(1, 0, 2)
        return dict(execution=execution,
                    ring_ids=ring_ids.astype(np.int32),
                    rows_per_layer=k * (k - 1) * nv)
    # p2p: master-based two-phase GAS over every present (rank, slot)
    m_of = masters.astype(np.int64)
    d_all, slot_all = np.nonzero(vert_ids < V)  # rank-major, slots ascending
    v_all = vert_ids[d_all, slot_all]
    m_all = m_of[v_all]
    rem = m_all != d_all
    # phase 1 (gather): rank s ships the partial rows of its non-master
    # replicas to each vertex's master, in slot order; pos1[s, v] is v's
    # position in need1[s][m(v)]
    need1, counts1, p1 = _need_lists(d_all[rem], m_all[rem], slot_all[rem],
                                     slot_all[rem], k, V)
    pos1 = np.full((k, V), -1, np.int64)
    pos1[d_all[rem], v_all[rem]] = p1
    rows1 = int(rem.sum())
    c1 = max(1, int(counts1.max(initial=0)))
    w1 = bucketed_cap_widths(c1, buckets)
    send1 = bucketed_send_table(need1, k, w1)
    pad1 = nv + len(w1) * k * w1[0]
    gather_ids = np.full((k, nv, Rm), pad1, np.int32)
    gather_mask = np.zeros((k, nv, Rm), np.float32)
    own = ~rem
    md, msl, mv = d_all[own], slot_all[own], v_all[own]  # master slots
    for r in range(Rm):
        s = rep_part[mv, r]
        valid = s >= 0
        ssafe = np.clip(s, 0, k - 1)
        idx = np.where(s == md, msl,
                       halo_slot(pos1[ssafe, mv], ssafe, w1[0], k, nv))
        gather_ids[md[valid], msl[valid], r] = idx[valid]
        gather_mask[md[valid], msl[valid], r] = 1.0
    # phase 2 (scatter): each master ships the finished aggregate back to
    # the other replicas, ordered by its own slot; pos2[dst, v] is v's
    # position in need2[m(v)][dst]
    reps = rep_part[mv]  # [masters, Rm]
    back = (reps >= 0) & (reps != md[:, None])
    src2 = np.broadcast_to(md[:, None], reps.shape)[back]
    slot2 = np.broadcast_to(msl[:, None], reps.shape)[back]
    v2 = np.broadcast_to(mv[:, None], reps.shape)[back]
    dst2 = reps[back]
    need2, counts2, p2 = _need_lists(src2, dst2, slot2, slot2, k, V)
    pos2 = np.full((k, V), -1, np.int64)
    pos2[dst2, v2] = p2
    rows2 = len(dst2)
    c2 = max(1, int(counts2.max(initial=0)))
    w2 = bucketed_cap_widths(c2, buckets)
    send2 = bucketed_send_table(need2, k, w2)
    pad2 = nv + len(w2) * k * w2[0]
    scatter_ids = np.full((k, nv), pad2, np.int32)
    scatter_ids[md, msl] = msl
    rd, rsl, rv = d_all[rem], slot_all[rem], v_all[rem]
    scatter_ids[rd, rsl] = halo_slot(pos2[rd, rv], m_of[rv], w2[0], k,
                                     nv).astype(np.int32)
    return dict(execution=execution, send1=send1, gather_ids=gather_ids,
                gather_mask=gather_mask, send2=send2,
                scatter_ids=scatter_ids, rows_per_layer=rows1 + rows2,
                caps=(c1, c2),  # pre-bucketing max pairwise needs
                send1_mask=bucketed_send_mask(counts1, w1),
                send2_mask=bucketed_send_mask(counts2, w2))


# ---------------------------------------------------------------------------
# the device half
# ---------------------------------------------------------------------------


def _gather_table(pc: torch.Tensor) -> Callable[[], torch.Tensor]:
    """Issue the broadcast table of one chunk and return ``finish``: every
    rank's rows all-gathered (one rank: its own), then one zero row."""
    if not group_active():
        return lambda: torch.cat([pc, zero_pad_row(pc)], 0)
    gathered = all_gather_rows(pc.contiguous())
    return lambda: torch.cat([gathered(), zero_pad_row(pc)], 0)


def _ring_combine(partial: torch.Tensor, ring, k: int, rank: int,
                  combine_op: Callable, gather: Callable) -> torch.Tensor:
    """The ring combine (shared by the sum and the max pass): round r reads
    owner (rank + r) % k's block through that owner's single-slot table
    ``ring`` = (ids [k, nv, 1], mask, plans), pad entries masked; exactly
    k - 1 rotations (`pipeline_exchange.ring_blocks`), rotation r + 1 in
    flight while round r is read.  Accumulation order: own block, then
    rotations 1 .. k-1, as the reference's."""
    ids, mask, plans = ring
    acc = None
    for owner, blk in ring_blocks(partial.contiguous(), k, rank):
        part = gather(ids[owner], mask[owner], blk, plans[owner])
        acc = part if acc is None else combine_op(acc, part)
    return acc


def replica_combine(execution: str, partial: torch.Tensor, cons: Dict, *,
                    k: int, rank: int, ell_fn: Callable,
                    num_chunks: int = 1) -> torch.Tensor:
    """partial [nv, D] -> the full per-slot neighbor sums [nv, D].
    ``ell_fn(ids, mask, table, plan)`` is the masked ELL gather-sum (the
    engine's CUDA kernel, its backward the transpose kernel over ``plan``).

    ``num_chunks`` > 1 feature-chunks the broadcast and p2p exchange
    (`pipeline_exchange.chunked_overlap`): chunk c+1's collective is issued
    before chunk c is combined.  p2p's phase 2 rides inside the consumer
    (it depends on the combined aggregate).  The ring ignores chunks, as
    the reference's does."""
    if execution == "broadcast":
        ids, mask, plan = cons["rep"]
        return chunked_overlap(partial, num_chunks, _gather_table,
                               lambda table: ell_fn(ids, mask, table, plan))
    if execution == "ring":
        return _ring_combine(partial, cons["ring"], k, rank,
                             lambda a, b: a + b, ell_fn)
    gather_ids, gather_mask, gather_plan = cons["gather"]
    scatter_ids, scatter_mask, scatter_plan = cons["scatter"]

    def exchange(pc):
        pc = pc.contiguous()
        recv = bucketed_all_to_all(pc, cons["send1"])
        return lambda: (pc, recv())

    def consume(carry):
        pc, recv = carry
        table = torch.cat([pc, recv, zero_pad_row(pc)], 0)
        agg_m = ell_fn(gather_ids, gather_mask, table, gather_plan)
        recv_b = bucketed_all_to_all(agg_m, cons["send2"])()
        # the scatter's pad entries are masked: no zero row
        table2 = torch.cat([agg_m, recv_b], 0)
        return ell_fn(scatter_ids, scatter_mask, table2, scatter_plan)

    return chunked_overlap(partial, num_chunks, exchange, consume)


def _masked_rows(table: torch.Tensor, ids: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """table[ids] with the masked entries 0, ids and mask [n, R] ->
    [n, R, D] (the max pass: no gradient)."""
    vals = table.index_select(0, ids.reshape(-1)).view(
        *ids.shape, table.shape[1])
    return torch.where(mask[..., None] > 0, vals, 0.0)


@torch.no_grad()
def replica_combine_max(execution: str, partial: torch.Tensor, cons: Dict, *,
                        k: int, rank: int) -> torch.Tensor:
    """Max-combine across replicas: the first pass of the distributed GAT
    segment-softmax, so all replicas share ONE exact stabilizer.  Reuses the
    sum combine's tables with one invariant pushed onto the caller: all real
    values must be >= 0 (the engine floors its local maxima at 0), so the
    masked entries' zeros fold into the max as identities.  It runs on
    detached tensors and returns one with no autograd history (the
    reference's stop_gradient); its gathers are plain."""
    partial = partial.detach()
    if execution == "broadcast":
        ids, mask, _ = cons["rep"]
        table = _gather_table(partial)()
        return _masked_rows(table, ids, mask).amax(1)
    if execution == "ring":
        return _ring_combine(
            partial, cons["ring"], k, rank, torch.maximum,
            lambda ids, mask, blk, _: _masked_rows(blk, ids, mask)[:, 0])
    recv = bucketed_all_to_all(partial, cons["send1"])()
    table = torch.cat([partial, recv, zero_pad_row(partial)], 0)
    gather_ids, gather_mask, _ = cons["gather"]
    agg_m = _masked_rows(table, gather_ids, gather_mask).amax(1)
    recv2 = bucketed_all_to_all(agg_m, cons["send2"])()
    scatter_ids, scatter_mask, _ = cons["scatter"]
    return _masked_rows(torch.cat([agg_m, recv2], 0), scatter_ids,
                        scatter_mask)[:, 0]


def reference_combine(partial: torch.Tensor, vert_ids: torch.Tensor,
                      num_vertices: int) -> torch.Tensor:
    """Single-device oracle combine: scatter-add every replica's partial
    into the global vertex space and gather back per slot, the same sum any
    of the three collectives computes, without a wire.  partial [k, nv, D],
    vert_ids [k, nv] int64 (pad = V)."""
    D = partial.shape[-1]
    flat = vert_ids.reshape(-1)
    G = partial.new_zeros((num_vertices + 1, D)).index_add(
        0, flat, partial.reshape(-1, D))
    return G[flat].view(partial.shape)  # pad slots read G[V] = 0


def reference_combine_max(partial: torch.Tensor, vert_ids: torch.Tensor,
                          num_vertices: int) -> torch.Tensor:
    """Single-device oracle for `replica_combine_max`: scatter-MAX into the
    global vertex space and gather back.  Same >= 0 invariant: the zero
    init of the global table plays the role of the plans' zero rows."""
    D = partial.shape[-1]
    flat = vert_ids.reshape(-1)
    G = partial.new_zeros((num_vertices + 1, D)).scatter_reduce(
        0, flat[:, None].expand(-1, D), partial.reshape(-1, D), "amax")
    return G[flat].view(partial.shape)
