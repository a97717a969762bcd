"""Asynchronous protocols with historical embeddings (the port's copy of
`repro/core/protocols/async_hist.py`, survey §7.2): the three staleness
models (epoch-fixed, epoch-adaptive, variation-based) as state machines over
tensors, and PipeGCN-style embedding and gradient staleness.

True racing asynchrony does not exist in a step that every rank runs in
lockstep: the staleness BOUND (the convergence-relevant property) is kept by
a deterministic refresh schedule, and every refresh decision is a mask, so
the reference step can replay it block by block.

State layout: hist [V, D] historical embeddings; age [K] per-partition epochs
since refresh.  `boundary_mask` [V] marks vertices whose CONSUMERS are
remote: only those ever read stale values (local reads are always fresh),
exactly the GA-stage semantics of the survey's Table 3.  The step is a
Python int; everything else is a tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class HistoricalState:
    hist: torch.Tensor  # [V, D]
    age: torch.Tensor  # [K] int32 epochs since each partition's last push
    bytes_pushed: torch.Tensor  # [] running comm counter (rows refreshed * D * 4)

    @staticmethod
    def create(V: int, D: int, K: int, device="cpu") -> "HistoricalState":
        return HistoricalState(
            torch.zeros((V, D), dtype=torch.float32, device=device),
            torch.zeros((K,), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.float32, device=device))


def _mix(h_new, hist, part_refreshed, assignment, boundary_mask):
    """Rows of refreshed partitions read fresh; stale boundary rows read hist;
    non-boundary rows are always fresh (they never cross the wire)."""
    fresh_row = part_refreshed[assignment] | ~boundary_mask
    return torch.where(fresh_row[:, None], h_new, hist)


def _aged(part_refreshed, age):
    return torch.where(part_refreshed, 0, age + 1).to(age.dtype)


def epoch_fixed_refresh(state: HistoricalState, h_new: torch.Tensor, step: int,
                        assignment: torch.Tensor, boundary_mask: torch.Tensor,
                        staleness: int
                        ) -> Tuple[torch.Tensor, HistoricalState]:
    """DistGNN/PipeGCN (Table 3, epoch-fixed): every partition pushes every
    `staleness` epochs, so |e - ẽ| <= staleness by construction."""
    K = state.age.shape[0]
    refresh = (step % staleness) == 0
    part_refreshed = torch.full((K,), refresh, dtype=torch.bool,
                                device=h_new.device)
    h_used = _mix(h_new, state.hist, part_refreshed, assignment, boundary_mask)
    rows = boundary_mask.sum() if refresh else boundary_mask.new_zeros(
        (), dtype=torch.int64)
    hist2 = h_new if refresh else state.hist
    return h_used, HistoricalState(
        hist2, _aged(part_refreshed, state.age),
        state.bytes_pushed + rows * h_new.shape[1] * 4.0)


def epoch_adaptive_refresh(state: HistoricalState, h_new: torch.Tensor,
                           step: int, assignment: torch.Tensor,
                           boundary_mask: torch.Tensor, staleness: int
                           ) -> Tuple[torch.Tensor, HistoricalState]:
    """DIGEST (epoch-adaptive): partitions push round-robin, 1/staleness of
    them per epoch, so each partition's age stays <= staleness, but
    DIFFERENT partitions have different staleness within one epoch."""
    K = state.age.shape[0]
    part_refreshed = (torch.arange(K, device=h_new.device) % staleness) == (
        step % staleness)
    # safety: anything that would exceed the bound refreshes too
    part_refreshed = part_refreshed | (state.age >= staleness - 1)
    h_used = _mix(h_new, state.hist, part_refreshed, assignment, boundary_mask)
    row_refresh = part_refreshed[assignment] & boundary_mask
    hist2 = torch.where(row_refresh[:, None], h_new, state.hist)
    return h_used, HistoricalState(
        hist2, _aged(part_refreshed, state.age),
        state.bytes_pushed + row_refresh.sum() * h_new.shape[1] * 4.0)


def variation_refresh(state: HistoricalState, h_new: torch.Tensor, step: int,
                      assignment: torch.Tensor, boundary_mask: torch.Tensor,
                      eps: float, hard_bound: int = 4
                      ) -> Tuple[torch.Tensor, HistoricalState]:
    """SANCUS skip-broadcast (variation-based): a partition pushes only when
    its embeddings drifted more than eps (relative Frobenius) from the last
    pushed version; a hard epoch bound keeps staleness finite (the reference
    keeps it small, 4: drift can sit just under eps for many epochs while
    the stale boundary rows quietly stall convergence)."""
    K = state.age.shape[0]
    diff = torch.square(h_new - state.hist).sum(-1)  # [V]
    base = torch.square(state.hist).sum(-1) + 1e-12
    drift_v = diff / base
    # per-partition mean drift over boundary rows
    w = boundary_mask.to(torch.float32)
    zeros = torch.zeros((K,), dtype=torch.float32, device=h_new.device)
    num = zeros.index_add(0, assignment, drift_v * w)
    den = zeros.index_add(0, assignment, w) + 1e-9
    part_refreshed = (num / den > eps) | (state.age >= hard_bound)
    h_used = _mix(h_new, state.hist, part_refreshed, assignment, boundary_mask)
    row_refresh = part_refreshed[assignment] & boundary_mask
    hist2 = torch.where(row_refresh[:, None], h_new, state.hist)
    return h_used, HistoricalState(
        hist2, _aged(part_refreshed, state.age),
        state.bytes_pushed + row_refresh.sum() * h_new.shape[1] * 4.0)


STALENESS_MODELS = {
    "epoch_fixed": epoch_fixed_refresh,
    "epoch_adaptive": epoch_adaptive_refresh,
    "variation": variation_refresh,
}


def block_refresh(protocol: str, hist_b: torch.Tensor, h_b: torch.Tensor,
                  age: torch.Tensor, step: int, bmask_b: torch.Tensor,
                  part_id: int, *, staleness: int = 2, eps: float = 0.05,
                  hard_bound: int = 4
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Block-local (one partition's rows) form of the staleness models, for
    the engine: every refresh decision here depends only on this
    partition's own rows, age and id, so the same function runs on each rank
    AND block by block in the single-device reference step, which is what
    makes the engine oracle-checkable under asynchrony.

    hist_b/h_b [nb, D]; age [] int32; bmask_b [nb] bool; part_id an int.
    Returns (h_used_b, hist2_b, age2, rows_pushed): rows_pushed an int64
    tensor []."""
    if protocol == "epoch_fixed":
        refreshed = torch.tensor((step % staleness) == 0, device=h_b.device)
        fresh_row = refreshed | ~bmask_b
        h_used = torch.where(fresh_row[:, None], h_b, hist_b)
        hist2 = torch.where(refreshed, h_b, hist_b)  # full-block push
        rows = torch.where(refreshed, bmask_b.sum(), 0)
    elif protocol in ("epoch_adaptive", "variation"):
        if protocol == "epoch_adaptive":
            refreshed = ((part_id % staleness) == (step % staleness)) | (
                age >= staleness - 1)
        else:
            w = bmask_b.to(torch.float32)
            diff = torch.square(h_b - hist_b).sum(-1)
            base = torch.square(hist_b).sum(-1) + 1e-12
            drift = (diff / base * w).sum() / (w.sum() + 1e-9)
            refreshed = (drift > eps) | (age >= hard_bound)
        fresh_row = refreshed | ~bmask_b
        h_used = torch.where(fresh_row[:, None], h_b, hist_b)
        row_refresh = refreshed & bmask_b
        hist2 = torch.where(row_refresh[:, None], h_b, hist_b)
        rows = row_refresh.sum()
    else:
        raise ValueError(f"unknown protocol {protocol!r}")
    age2 = torch.where(refreshed, 0, age + 1).to(age.dtype)
    return h_used, hist2, age2, rows


@dataclasses.dataclass
class PipeGCNState:
    """PipeGCN: both boundary embeddings AND boundary gradients come from the
    previous epoch (staleness exactly 1); carried per layer."""
    hist_h: torch.Tensor  # [L, V, D]
    hist_g: torch.Tensor  # [L, V, D]

    @staticmethod
    def create(L: int, V: int, D: int, device="cpu") -> "PipeGCNState":
        return PipeGCNState(
            torch.zeros((L, V, D), dtype=torch.float32, device=device),
            torch.zeros((L, V, D), dtype=torch.float32, device=device))


class _PipeGCNMix(torch.autograd.Function):
    """Forward: boundary rows read last epoch's embeddings.  Backward:
    boundary rows receive last epoch's GRADIENTS (hist_g), and the FRESH
    boundary cotangent comes out on the hist_g channel."""

    @staticmethod
    def forward(ctx, h_new, hist_h, hist_g, bmask_f):
        ctx.save_for_backward(hist_g, bmask_f)
        b = bmask_f[:, None]
        return h_new * (1.0 - b) + hist_h * b

    @staticmethod
    def backward(ctx, ct):
        hist_g, bmask_f = ctx.saved_tensors
        b = bmask_f[:, None]
        d_h_new = ct * (1.0 - b) + hist_g * b  # stale gradient injected
        d_hist_g = ct * b  # fresh boundary cotangent -> next epoch's hist_g
        return d_h_new, torch.zeros_like(ct), d_hist_g, torch.zeros_like(bmask_f)


def pipegcn_mix(h_new: torch.Tensor, hist_h: torch.Tensor,
                hist_g: torch.Tensor, bmask_f: torch.Tensor) -> torch.Tensor:
    """Both PipeGCN staleness points (GA and gradient-GA, survey Table 3) in
    one differentiable call: h_new, hist_h, hist_g [V, D], bmask_f [V] float
    (1 on boundary rows).  The forward mixes in last epoch's boundary
    embeddings; the backward hands h_new last epoch's boundary gradients
    and emits the fresh boundary cotangent as hist_g's gradient, so the
    caller can harvest it as next epoch's state."""
    return _PipeGCNMix.apply(h_new, hist_h, hist_g, bmask_f)
