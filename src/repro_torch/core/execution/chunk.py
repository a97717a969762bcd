"""Graph-view execution models (the port's copy of
`repro/core/execution/chunk.py`, survey §6.2.1): one-shot against
chunk-based aggregation, single-device semantics (the distributed
counterparts are in `spmm_models`: one-shot is the 1D broadcast, the
sequential chunk the ring, the parallel chunk the CCR reduction).  Plain
fp32 products, as the reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

import torch


def one_shot_aggregate(A: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Collect every neighbor feature first, aggregate in one shot."""
    return A @ H


def _chunks(A: torch.Tensor, H: torch.Tensor, num_chunks: int):
    """A [R, V] as [k, R, V/k] column blocks and H [V, D] as [k, V/k, D]
    row blocks."""
    V = H.shape[0]
    assert V % num_chunks == 0
    nb = V // num_chunks
    Ar = A.reshape(A.shape[0], num_chunks, nb).permute(1, 0, 2)
    return Ar, H.reshape(num_chunks, nb, H.shape[1])


def sequential_chunk_aggregate(A: torch.Tensor, H: torch.Tensor,
                               num_chunks: int) -> torch.Tensor:
    """Split the neighborhood into chunks; accumulate partial aggregations
    sequentially, in chunk order (NeuGraph/SAR): one chunk live at a time."""
    Ar, Hr = _chunks(A, H, num_chunks)
    acc = H.new_zeros((A.shape[0], H.shape[1]))
    for A_blk, H_blk in zip(Ar, Hr):
        acc = acc + A_blk @ H_blk
    return acc


def parallel_chunk_aggregate(A: torch.Tensor, H: torch.Tensor,
                             num_chunks: int) -> torch.Tensor:
    """Every chunk computes its partial at once, then one reduction
    (DeepGalois/DistGNN/FlexGraph); across ranks the reduction is the
    reduce-scatter."""
    Ar, Hr = _chunks(A, H, num_chunks)
    return torch.einsum("krn,knd->krd", Ar, Hr).sum(0)
