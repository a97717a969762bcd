"""The collectives of the multi-rank engine over `torch.distributed` (the
JAX package has no counterpart: its `shard_map` emits them).

One process per rank.  `init_group` joins the default process group from an
explicit rendezvous (``init_method``), world size and rank; the backend
follows the device the caller asked for: NCCL for a CUDA device, gloo for
the CPU.  Nothing here probes for a card, and nothing falls back: a failed
rendezvous or collective raises.

Five collectives, each counting its calls in a plain integer
(``all_gather_rows.calls`` and so on, like the kernel wrappers' launch
counters).  Each takes an optional ``group`` (a subgroup from
`torch.distributed.new_group`, the 2-D SpMM models' grid rows and
columns, the MoE layer's data and model groups); without one it acts on
the world, and k and r below are the group's size and this rank's place
in it:

- `all_gather_rows`: [nb, D] on every rank -> [k*nb, D], rank r's rows at
  [r*nb, (r+1)*nb), issued asynchronously.  Its gradient (`_AllGatherRows`)
  is a reduce-scatter of the summed cotangent back to each rank's [nb, D],
  the transpose shard_map gives ``all_gather(tiled=True)``.
- `reduce_scatter_rows`: that gradient; itself differentiable
  (`_ReduceScatterRows`: its gradient is the all_gather of the cotangent,
  the 2-D SpMM models' transpose), an all_gather call in the backward.
- `all_to_all_rows`: [k*w, D] on every rank, block d of w rows bound for
  rank d -> [k*w, D], block s the w rows rank s sent here, issued
  asynchronously (the p2p halo exchange's installment).  Its gradient
  (`_AllToAllRows`) is the reverse all_to_all of the cotangent, which sends
  block s back to rank s; both directions count as calls of
  ``all_to_all_rows``.
- `ring_rotate`: [nb, D] on every rank, sent to rank (r - 1) % k and
  received from rank (r + 1) % k, issued asynchronously (the ring's
  rotation, the reference's ``ppermute`` with perm i -> i - 1 mod k).  Its
  gradient (`_RingRotate`) is the reverse rotation of the cotangent; both
  directions count as calls of ``ring_rotate`` (key ``ppermute``).  It is
  an all_to_all whose split sizes leave one peer each way; at k = 1 there is
  no other rank, and the ring issues none.
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


def world_size(group=None) -> int:
    return dist.get_world_size(group) if group_active() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if group_active() else 0


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
    def forward(ctx, h, pending, group):
        out, work = pending
        ctx.group = group
        work.wait()
        return out

    @staticmethod
    def backward(ctx, ct):
        return reduce_scatter_rows(ct, ctx.group), None, None


def all_gather_rows(h: torch.Tensor,
                    group=None) -> Callable[[], torch.Tensor]:
    """Issue the all_gather of this rank's rows h [nb, D] (contiguous) and
    return ``finish``: a call that waits on it and returns the [k*nb, D]
    table, differentiable in h.  Between the two, the caller may issue more
    work: on NCCL the wait orders the streams without blocking the host; on
    gloo it blocks the host until the rows have arrived."""
    out = h.new_empty((world_size(group) * h.shape[0], h.shape[1]))
    # the collective sees no autograd history: `_AllGatherRows` carries it
    work = dist.all_gather_into_tensor(out, h.detach(), group=group,
                                       async_op=True)
    all_gather_rows.calls += 1

    def finish() -> torch.Tensor:
        return _AllGatherRows.apply(h, (out, work), group)
    return finish


class _AllToAllRows(torch.autograd.Function):
    """The autograd face of an all_to_all already issued by
    `all_to_all_rows`: the forward waits on its handle and returns the
    received rows; the backward runs the reverse all_to_all of their
    cotangent (an all_to_all of equal blocks is its own transpose)."""

    @staticmethod
    def forward(ctx, send, pending, group):
        out, work = pending
        ctx.group = group
        work.wait()
        return out

    @staticmethod
    def backward(ctx, ct):
        ct = ct.contiguous()
        out = torch.empty_like(ct)
        dist.all_to_all_single(out, ct, group=ctx.group)
        all_to_all_rows.calls += 1
        return out, None, None


def all_to_all_rows(send: torch.Tensor,
                    group=None) -> Callable[[], torch.Tensor]:
    """Issue the all_to_all of ``send`` [k*w, D] (contiguous; block d goes
    to rank d) and return ``finish``: a call that waits on it and returns
    the received [k*w, D] (block s from rank s), differentiable in send.
    Between the two the caller may issue more work, as with
    `all_gather_rows`."""
    out = torch.empty_like(send)
    # the collective sees no autograd history: `_AllToAllRows` carries it
    work = dist.all_to_all_single(out, send.detach(), group=group,
                                  async_op=True)
    all_to_all_rows.calls += 1

    def finish() -> torch.Tensor:
        return _AllToAllRows.apply(send, (out, work), group)
    return finish


def _rotate(h: torch.Tensor, reverse: bool, async_op: bool, group=None):
    """One rotation of h [nb, D] (contiguous) over the ring: to rank
    (r - 1) % k from rank (r + 1) % k, or the other way round when
    ``reverse``.  Returns (received rows, work handle or None)."""
    k, me = world_size(group), rank(group)
    step = 1 if reverse else -1
    send_splits, recv_splits = [0] * k, [0] * k
    send_splits[(me + step) % k] = h.shape[0]
    recv_splits[(me - step) % k] = h.shape[0]
    out = torch.empty_like(h)
    work = dist.all_to_all_single(out, h, recv_splits, send_splits,
                                  group=group, async_op=async_op)
    ring_rotate.calls += 1
    return out, work


class _RingRotate(torch.autograd.Function):
    """The autograd face of a rotation already issued by `ring_rotate`: the
    forward waits on its handle and returns the rows rank (r + 1) % k sent;
    the backward sends their cotangent back there, the reverse rotation."""

    @staticmethod
    def forward(ctx, h, pending, group):
        out, work = pending
        ctx.group = group
        work.wait()
        return out

    @staticmethod
    def backward(ctx, ct):
        return _rotate(ct.contiguous(), reverse=True, async_op=False,
                       group=ctx.group)[0], None, None


def ring_rotate(h: torch.Tensor, group=None) -> Callable[[], torch.Tensor]:
    """Issue the rotation of this rank's rows h [nb, D] (contiguous) to rank
    (r - 1) % k and return ``finish``: a call that waits on it and returns
    the [nb, D] rows rank (r + 1) % k sent, differentiable in h.  Between
    the two the caller may issue more work, as with `all_gather_rows`."""
    # the collective sees no autograd history: `_RingRotate` carries it
    pending = _rotate(h.detach(), reverse=False, async_op=True, group=group)

    def finish() -> torch.Tensor:
        return _RingRotate.apply(h, pending, group)
    return finish


class _ReduceScatterRows(torch.autograd.Function):
    """The reduce-scatter as an autograd op: the backward all-gathers the
    cotangent of this rank's block back to [k*nb, D]."""

    @staticmethod
    def forward(ctx, ct, group):
        ctx.group = group
        out = ct.new_empty((ct.shape[0] // world_size(group), ct.shape[1]))
        dist.reduce_scatter_tensor(out, ct, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return all_gather_rows(g.contiguous(), ctx.group)(), None


def reduce_scatter_rows(ct: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ranks of ct [k*nb, D], this rank's block [nb, D];
    differentiable in ct."""
    out = _ReduceScatterRows.apply(ct.contiguous(), group)
    reduce_scatter_rows.calls += 1
    return out


def all_reduce_flat(tensors: Sequence[torch.Tensor],
                    group=None) -> List[torch.Tensor]:
    """The sum over ranks of every tensor, through one all_reduce of one
    flat buffer packed in the order given; returns new tensors of the
    inputs' shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    all_reduce_flat.calls += 1
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


COLLECTIVES = {"all_gather": all_gather_rows,
               "reduce_scatter": reduce_scatter_rows,
               "all_to_all": all_to_all_rows,
               "ppermute": ring_rotate,
               "all_reduce": all_reduce_flat}
zero_calls()
