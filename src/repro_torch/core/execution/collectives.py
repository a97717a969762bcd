"""The collectives of the multi-rank engine over `torch.distributed` (the
JAX package has no counterpart: its `shard_map` emits them).

One process per rank.  `init_group` joins the default process group from an
explicit rendezvous (``init_method``), world size and rank; the backend
follows the device the caller asked for: NCCL for a CUDA device, gloo for
the CPU.  Nothing here probes for a card, and nothing falls back: a failed
rendezvous or collective raises.

Three collectives, each counting its calls in a plain integer
(``all_gather_rows.calls`` and so on, like the kernel wrappers' launch
counters):

- `all_gather_rows`: [nb, D] on every rank -> [k*nb, D], rank r's rows at
  [r*nb, (r+1)*nb), issued asynchronously.  Its gradient (`_AllGatherRows`)
  is a reduce-scatter of the summed cotangent back to each rank's [nb, D],
  the transpose shard_map gives ``all_gather(tiled=True)``.
- `reduce_scatter_rows`: that gradient.
- `all_reduce_flat`: one summed all_reduce of a list of tensors packed
  into one flat buffer in the order given, so the summation is the same
  on every run and every rank.
"""
from __future__ import annotations

import datetime
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

RENDEZVOUS_TIMEOUT = datetime.timedelta(seconds=60)


def group_active() -> bool:
    """Whether this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if group_active() else 1


def rank() -> int:
    return dist.get_rank() if group_active() else 0


def init_group(init_method: str, world_size: int, rank: int, device) -> None:
    """Join the default process group: ``init_method`` is the rendezvous
    (``file://<path>`` or ``tcp://<host>:<port>``), ``rank`` in
    [0, world_size).  The backend is NCCL for a CUDA device, which becomes
    this process's current device first so NCCL binds the rank to it, and
    gloo for the CPU.  A rank that does not reach the rendezvous within
    RENDEZVOUS_TIMEOUT makes its peers raise."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is not in [0, {world_size})")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=RENDEZVOUS_TIMEOUT)


def destroy_group() -> None:
    if group_active():
        dist.destroy_process_group()


def zero_calls() -> None:
    for fn in COLLECTIVES.values():
        fn.calls = 0


def read_calls() -> dict:
    return {name: fn.calls for name, fn in COLLECTIVES.items()}


class _AllGatherRows(torch.autograd.Function):
    """The autograd face of an all_gather already issued by
    `all_gather_rows`: the forward waits on its handle and returns the
    gathered table; the backward reduce-scatters the table's cotangent to
    this rank's rows.  ``h`` is the tensor that was sent, so autograd routes
    the gradient to it."""

    @staticmethod
    def forward(ctx, h, pending):
        out, work = pending
        work.wait()
        return out

    @staticmethod
    def backward(ctx, ct):
        return reduce_scatter_rows(ct), None


def all_gather_rows(h: torch.Tensor) -> Callable[[], torch.Tensor]:
    """Issue the all_gather of this rank's rows h [nb, D] (contiguous) and
    return ``finish``: a call that waits on it and returns the [k*nb, D]
    table, differentiable in h.  Between the two, the caller may issue more
    work: on NCCL the wait orders the streams without blocking the host; on
    gloo it blocks the host until the rows have arrived."""
    out = h.new_empty((world_size() * h.shape[0], h.shape[1]))
    # the collective sees no autograd history: `_AllGatherRows` carries it
    work = dist.all_gather_into_tensor(out, h.detach(), async_op=True)
    all_gather_rows.calls += 1

    def finish() -> torch.Tensor:
        return _AllGatherRows.apply(h, (out, work))
    return finish


def reduce_scatter_rows(ct: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ct [k*nb, D], this rank's block [nb, D]."""
    ct = ct.contiguous()
    out = ct.new_empty((ct.shape[0] // world_size(), ct.shape[1]))
    dist.reduce_scatter_tensor(out, ct, op=dist.ReduceOp.SUM)
    reduce_scatter_rows.calls += 1
    return out


def all_reduce_flat(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum over ranks of every tensor, through one all_reduce of one
    flat buffer packed in the order given; returns new tensors of the
    inputs' shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    all_reduce_flat.calls += 1
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


COLLECTIVES = {"all_gather": all_gather_rows,
               "reduce_scatter": reduce_scatter_rows,
               "all_reduce": all_reduce_flat}
zero_calls()
