"""Distributed SpMM execution models (the port's copy of
`repro/core/execution/spmm_models.py`, survey §6.2.2, Table 2) over
`torch.distributed`, one process per rank.

The survey's taxonomy {replicated, 1D, 1.5D, 2D} x {A-, H-, P-stationary}
collapses to three execution shapes:
  C   (computation-only)              : spmm_replicated
  CC  (communication-computation)     : spmm_1d_broadcast (CAGNET 1D),
                                        spmm_1d_ring (chunk-based/pipelined,
                                        SAR/ParallelGCN), spmm_1d_p2p
                                        (selective boundary exchange)
  CCR (communication-computation-     : spmm_2d_summa (CAGNET 2D),
       reduction)                       spmm_15d

Every function computes this rank's block of Y = A @ H for a dense
(normalized) adjacency A and features H.  Where the reference runs a
`shard_map` over a mesh, each function here takes a `ProcessGrid` (the
mesh: `process_grid((k,))` or `process_grid((r, c))`, rank i*c + j at grid
place (i, j)) and this rank's blocks, laid out as the reference's
``in_specs`` (`local_blocks` cuts them from the whole arrays), and returns
this rank's block of Y, laid out as its ``out_specs`` (`output_block`
names it).  The collectives are `core/execution/collectives.py`'s, each
call counted.  The products are plain fp32 ``A @ H``, as the reference
computes them outside any Pallas kernel.  `whole_product` is the
reference's global view, the form `launch/train_gnn.run_legacy` trains
through: every rank holds the whole A and H and gets the whole Y, with
exact gradients on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.execution import collectives


@dataclasses.dataclass(frozen=True)
class ProcessGrid:
    """The ranks as a 1-D or 2-D grid.  ``shape`` (k,) or (r, c);
    ``coords`` this rank's place, (rank,) or (i, j) with rank = i*c + j;
    ``groups[a]`` the process group of the ranks that differ from this one
    only along axis a (None: the world, the 1-D grid's one axis).  On a
    2-D grid ``groups[0]`` holds the ranks of this grid column (same j, in
    i order: the reference's collectives over its first mesh axis) and
    ``groups[1]`` those of this grid row (same i, in j order: over its
    second)."""
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Tuple[Optional[object], ...]


def process_grid(shape: Tuple[int, ...]) -> ProcessGrid:
    """This rank's place on a grid of the given shape over the process
    group, whose size must be the grid's.  A 2-D grid makes one subgroup
    for every grid row and column (`torch.distributed.new_group`, which
    every rank calls for every group, in one order)."""
    shape = tuple(int(n) for n in shape)
    k, me = collectives.world_size(), collectives.rank()
    if len(shape) not in (1, 2) or math.prod(shape) != k:
        raise ValueError(f"a grid of shape {shape} over {k} rank(s): it "
                         "must be 1-D or 2-D with as many places as ranks")
    if len(shape) == 1:
        return ProcessGrid(shape, (me,), (None,))
    r, c = shape
    i, j = divmod(me, c)
    col_group = row_group = None
    for b in range(c):  # the grid's columns: the ranks (*, b)
        grp = dist.new_group([a * c + b for a in range(r)])
        if b == j:
            col_group = grp
    for a in range(r):  # the grid's rows: the ranks (a, *)
        grp = dist.new_group([a * c + b for b in range(c)])
        if a == i:
            row_group = grp
    return ProcessGrid(shape, (i, j), (col_group, row_group))


def _axis1(grid: ProcessGrid):
    if len(grid.shape) != 1:
        raise ValueError(f"a 1-D model needs a 1-D grid, not {grid.shape}")
    return grid.groups[0]


def _axes2(grid: ProcessGrid):
    if len(grid.shape) != 2:
        raise ValueError(f"a 2-D model needs a 2-D grid, not {grid.shape}")
    return grid.groups


def spmm_replicated(grid: ProcessGrid, A: torch.Tensor,
                    H_cols: torch.Tensor) -> torch.Tensor:
    """Computation-only (C): A replicated, H column-partitioned."""
    _axis1(grid)
    return A @ H_cols  # no communication at all


def spmm_1d_broadcast(grid: ProcessGrid, A_rows: torch.Tensor,
                      H_rows: torch.Tensor) -> torch.Tensor:
    """1D P-stationary (CC), broadcast protocol (CAGNET 1D): every rank owns
    a row block of A and H; H is all-gathered, Y's row block stays local."""
    group = _axis1(grid)
    H_full = collectives.all_gather_rows(H_rows.contiguous(), group)()
    return A_rows @ H_full


def spmm_1d_ring(grid: ProcessGrid, A_rows: torch.Tensor,
                 H_rows: torch.Tensor) -> torch.Tensor:
    """1D CC with sequential chunk-based execution (survey §6.2.1) and the
    pipeline protocol (§7.1.3): H row blocks rotate around the ring, each
    round accumulating one chunk's partial aggregation while the next
    rotation is in flight.  Rank r sends to r - 1, so after round t it
    holds the block of rank (r + t) % k; k - 1 rotations (none at k = 1:
    the reference's last rotation is never read)."""
    group = _axis1(grid)
    k, me = collectives.world_size(group), collectives.rank(group)
    nb = H_rows.shape[0]
    acc = H_rows.new_zeros((A_rows.shape[0], H_rows.shape[1]))
    H_cur = H_rows.contiguous()
    for t in range(k):
        pending = collectives.ring_rotate(H_cur, group) if t + 1 < k else None
        owner = (me + t) % k  # whose block H_cur is
        acc = acc + A_rows[:, owner * nb:(owner + 1) * nb] @ H_cur
        if pending is not None:
            H_cur = pending()
    return acc


def p2p_plan(A_np: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Selective-P2P plan from block sparsity: which rows of H block j does
    rank i actually need (the nonzero columns of A[i, :] within block j)?
    Returns (need [k, k, cap] padded row indices within the block, cnt
    [k, k] the real ones, cap)."""
    V = A_np.shape[0]
    nb = V // k
    need_sets = [[(np.zeros(0, np.int64) if i == j else  # own block is local
                   np.unique(np.nonzero(A_np[i * nb:(i + 1) * nb,
                                             j * nb:(j + 1) * nb])[1]))
                  for j in range(k)] for i in range(k)]
    cap = max(1, max(len(s) for row in need_sets for s in row))
    need = np.zeros((k, k, cap), np.int32)
    cnt = np.zeros((k, k), np.int32)
    for i in range(k):
        for j in range(k):
            s = need_sets[i][j]
            need[i, j, : len(s)] = s
            cnt[i, j] = len(s)
    return need, cnt, cap


def spmm_1d_p2p(grid: ProcessGrid, A_rows: torch.Tensor, H_rows: torch.Tensor,
                plan: Tuple[np.ndarray, np.ndarray, int]) -> torch.Tensor:
    """1D CC with selective P2P (ParallelGCN/DistGNN): only the boundary
    rows each pair needs cross the wire, one all_to_all of padded
    per-destination buffers.  Communication is proportional to the cut
    size, not to V."""
    group = _axis1(grid)
    k, me = collectives.world_size(group), collectives.rank(group)
    need, cnt, cap = plan
    nb, D = H_rows.shape
    dev = H_rows.device
    # the rows of MY block each destination d needs: need[d, me]
    rows_for = torch.as_tensor(need[:, me, :].reshape(-1), dtype=torch.long,
                               device=dev)
    send = torch.index_select(H_rows, 0, rows_for)  # [k*cap, D]
    recv = collectives.all_to_all_rows(send, group)().reshape(k, cap, D)
    acc = H_rows.new_zeros((A_rows.shape[0], D))
    for j in range(k):  # the source blocks, in order
        if j == me:  # the own block never crosses the wire: read it locally
            H_blk = H_rows
        else:
            valid = (torch.arange(cap, device=dev) < int(cnt[me, j]))[:, None]
            ids = torch.as_tensor(need[me, j], dtype=torch.long, device=dev)
            H_blk = H_rows.new_zeros((nb, D)).index_add_(
                0, ids, torch.where(valid, recv[j], 0.0))
        acc = acc + A_rows[:, j * nb:(j + 1) * nb] @ H_blk
    return acc


def spmm_2d_summa(grid: ProcessGrid, A_blk: torch.Tensor,
                  H_blk: torch.Tensor) -> torch.Tensor:
    """2D A-stationary (CCR, CAGNET 2D / SUMMA) on an r x c grid: A block
    (i, j) is stationary; rank (i, j) holds H row chunk j*r + i (the
    chunks column-group-major), so the all-gather over its grid column
    reassembles the rows of block column j that A block (i, j) reads; the
    partials are reduce-scattered over its grid row, leaving Y chunk
    i*c + j."""
    col_group, row_group = _axes2(grid)
    Hj = collectives.all_gather_rows(H_blk.contiguous(), col_group)()
    part = A_blk @ Hj  # block column j's share of Y's block row i
    return collectives.reduce_scatter_rows(part, row_group)


def spmm_15d(grid: ProcessGrid, A_blk: torch.Tensor,
             H_blk: torch.Tensor) -> torch.Tensor:
    """1.5D A-stationary (CCR): A is 2D-partitioned (r x c); H is 1D
    row-partitioned over c (block j replicated over the grid's rows).  The
    partials reduce-scatter over the grid row, leaving Y chunk i*c + j."""
    _, row_group = _axes2(grid)
    return collectives.reduce_scatter_rows(A_blk @ H_blk, row_group)


SPMM_MODELS = {
    "replicated": spmm_replicated,
    "spmm_1d": spmm_1d_broadcast,
    "spmm_1d_ring": spmm_1d_ring,
    "spmm_2d": spmm_2d_summa,
    "spmm_15d": spmm_15d,
}

# each function's layout: the reference's (in_specs, out_specs) in words
_LAYOUTS = {
    spmm_replicated: "replicated",
    spmm_1d_broadcast: "rows",
    spmm_1d_ring: "rows",
    spmm_1d_p2p: "rows",
    spmm_2d_summa: "2d",
    spmm_15d: "15d",
}


def input_block(fn, grid: ProcessGrid, V: int, D: int) -> Tuple[slice, slice]:
    """The (rows, columns) of H [V, D] that this rank's input of ``fn``
    holds: the reference's ``in_specs`` position."""
    kind = _LAYOUTS[fn]
    if kind == "replicated":
        (k,), (me,) = grid.shape, grid.coords
        dc = D // k
        return slice(None), slice(me * dc, (me + 1) * dc)
    if kind == "rows":
        (k,), (me,) = grid.shape, grid.coords
        nb = V // k
        return slice(me * nb, (me + 1) * nb), slice(None)
    (r, c), (i, j) = grid.shape, grid.coords
    if kind == "2d":  # H chunk j*r + i of r*c
        n = V // (r * c)
        return slice((j * r + i) * n, (j * r + i + 1) * n), slice(None)
    return slice(j * (V // c), (j + 1) * (V // c)), slice(None)  # 15d: block j of c


def local_blocks(fn, grid: ProcessGrid, A, H):
    """This rank's (A block, H block) of the whole A [V, V] and H [V, D]
    for the model ``fn``, as the reference's ``in_specs`` lay them out;
    works on numpy arrays and tensors alike (views)."""
    kind = _LAYOUTS[fn]
    V, D = H.shape
    rows, cols = input_block(fn, grid, V, D)
    if kind == "replicated":
        return A, H[rows, cols]
    if kind == "rows":
        return A[rows], H[rows, cols]
    (r, c), (i, j) = grid.shape, grid.coords
    A_blk = A[i * (V // r):(i + 1) * (V // r), j * (V // c):(j + 1) * (V // c)]
    return A_blk, H[rows, cols]


def output_block(fn, grid: ProcessGrid, V: int, D: int) -> Tuple[slice, slice]:
    """The (rows, columns) of Y [V, D] that this rank's output of ``fn``
    holds: the reference's ``out_specs`` position."""
    kind = _LAYOUTS[fn]
    if kind == "replicated":
        (k,), (me,) = grid.shape, grid.coords
        return slice(None), slice(me * (D // k), (me + 1) * (D // k))
    if kind == "rows":
        (k,), (me,) = grid.shape, grid.coords
        return slice(me * (V // k), (me + 1) * (V // k)), slice(None)
    (r, c), (i, j) = grid.shape, grid.coords
    n = V // (r * c)
    return slice((i * c + j) * n, (i * c + j + 1) * n), slice(None)


class _BlockOfWhole(torch.autograd.Function):
    """This rank's block of a tensor every rank holds whole and alike; the
    backward sums every rank's block cotangent into the whole cotangent
    (one all_reduce of a zero-padded buffer), which every rank then holds
    alike."""

    @staticmethod
    def forward(ctx, H, rows, cols):
        ctx.shape, ctx.rows, ctx.cols = H.shape, rows, cols
        return H[rows, cols].contiguous()

    @staticmethod
    def backward(ctx, ct):
        whole = ct.new_zeros(ctx.shape)
        whole[ctx.rows, ctx.cols] = ct
        return collectives.all_reduce_flat([whole])[0], None, None


class _WholeOfBlocks(torch.autograd.Function):
    """The whole [V, D] from every rank's disjoint block (one all_reduce of
    a zero-padded buffer: each entry is one rank's value plus zeros, so
    exact); the backward takes this rank's block of the cotangent, which
    every rank holds alike."""

    @staticmethod
    def forward(ctx, Y, rows, cols, shape):
        ctx.rows, ctx.cols = rows, cols
        whole = Y.new_zeros(shape)
        whole[rows, cols] = Y
        return collectives.all_reduce_flat([whole])[0]

    @staticmethod
    def backward(ctx, ct):
        return ct[ctx.rows, ctx.cols].contiguous(), None, None, None


def whole_product(fn, grid: ProcessGrid, A: torch.Tensor,
                  H: torch.Tensor) -> torch.Tensor:
    """The reference's global-view call ``fn(mesh, A, H)`` over the process
    grid: every rank holds the whole A [V, V] and H [V, D] alike, runs
    ``fn`` on its blocks (`local_blocks`) and gets the whole Y = A @ H [V,
    D], as `shard_map` hands the global array back.  Differentiable in H
    with the exact gradient on every rank: the cotangent of each rank's
    output block is its block of Y's (which every rank holds alike), and
    the ranks' H-block cotangents are summed into H's (`_BlockOfWhole`).
    Two all_reduce calls a product beside ``fn``'s own collectives (four
    with the backward)."""
    V, D = H.shape
    A_blk, _ = local_blocks(fn, grid, A, H)
    H_blk = _BlockOfWhole.apply(H, *input_block(fn, grid, V, D))
    Y_blk = fn(grid, A_blk, H_blk)
    return _WholeOfBlocks.apply(Y_blk, *output_block(fn, grid, V, D), (V, D))
