"""Row-sparse AdamW for trainable embedding tables (the port's copy of
`row_adamw_update` and `sparse_adamw_ids` of
`repro/optim/sparse_optim.py`).

When layer-0 rows are learnable embeddings, a step sees gradients only for
the rows it touched, so the optimizer must update only those rows: dense
Adam would decay every row's moments every step and pay O(V) work a step.

The core is `row_adamw_update`: AdamW over the rows of one table with a
per-row touched mask and per-row step counts for the bias correction (a
row's correction uses how often that row has been updated, not the global
step: the one definition under which "sparse update == dense AdamW
restricted to the touched rows" holds across steps with different touched
sets).  Untouched rows of the params, both moments and the counts stay
bitwise unchanged.

`sparse_adamw_ids` gathers the rows of an explicit touched-id list, runs
`row_adamw_update` and writes them back through a dead row past the table
(the engine's mini-batch path; the ids come from the frontier plan), so an
untouched row is never written.  Every write is a copy to a distinct row:
no `index_add_`, no accumulating `index_put_`, nothing a rerun could sum in
another order.  `sparse_adamw` is the same update as an `Optimizer`
(`optim/optimizers.py`), reached through `make_optimizer`.
"""
from __future__ import annotations

from typing import Optional

import torch


def _row_mask(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """Broadcast a [N] row mask over a [N, ...] table."""
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


def row_adamw_update(p, g, m, v, t, touched, *, lr: float, b1: float = 0.9,
                     b2: float = 0.999, eps: float = 1e-8,
                     weight_decay: float = 0.0):
    """Masked-dense row AdamW: p, g, m, v [N, ...] (m and v float32), t [N]
    int32 per-row update counts, touched [N] (bool or float).  Returns new
    (p2, m2, v2, t2), every untouched row of all four bitwise the input's.
    The bias correction is per row: row r's uses t2[r] = t[r] + touched[r],
    so a row updated for the i-th time moves as dense AdamW at step i
    restricted to that row does."""
    tch = touched.to(torch.bool)
    rm = _row_mask(tch, p.dim())
    g32 = g.to(torch.float32)
    t2 = t + tch.to(t.dtype)
    tf = t2.to(torch.float32)
    # an untouched row may still have t2 == 0: guard the division (the
    # where below drops the guarded rows anyway)
    bc1 = torch.clamp(1.0 - torch.pow(b1, tf), min=1e-30)
    bc2 = torch.clamp(1.0 - torch.pow(b2, tf), min=1e-30)
    m2 = b1 * m + (1 - b1) * g32
    v2 = b2 * v + (1 - b2) * torch.square(g32)
    mh = m2 / _row_mask(bc1, p.dim())
    vh = v2 / _row_mask(bc2, p.dim())
    u = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(torch.float32)
    p2 = (p.to(torch.float32) - lr * u).to(p.dtype)
    return (torch.where(rm, p2, p), torch.where(rm, m2, m),
            torch.where(rm, v2, v), t2)


def sparse_adamw_ids(table, m, v, t, ids, grads, *, lr: float,
                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                     weight_decay: float = 0.0,
                     valid: Optional[torch.Tensor] = None,
                     dedup: bool = False):
    """Sparse row AdamW over an explicit touched-id list: gather the R rows,
    run `row_adamw_update`, write them back.  table, m, v [N, D], t [N];
    ids [R] int row indices; grads [R, D] the gradient rows aligned with
    ``ids``.

    ``valid`` [R] marks the real entries (default 0 <= ids < N, so a
    sentinel id >= N marks padding).  With ``dedup`` the gradients of equal
    valid ids are summed onto their first occurrence and the later ones
    dropped (an R x R combine, for small R); otherwise the valid ids must be
    distinct.

    Returns new (table, m, v, t).  Only the applied ids are written: every
    other entry (invalid, or a later duplicate) writes a dead row past the
    table that is cut off, so the work and the moment traffic are O(R * D)
    past the copies, and every untouched row of all four stays bitwise
    unchanged."""
    N = table.shape[0]
    ids = ids.to(torch.int64)
    if valid is None:
        valid = (ids >= 0) & (ids < N)
    valid = valid.to(torch.bool)
    g = grads.to(torch.float32) * _row_mask(valid, grads.dim())
    if dedup:
        R = ids.shape[0]
        eq = (ids[:, None] == ids[None, :]) & valid[:, None] & valid[None, :]
        # the first j with the same (valid) id: argmax returns the first of
        # equal maxima
        first = torch.argmax(eq.to(torch.int8), dim=1)
        is_first = first == torch.arange(R, device=ids.device)
        g = (eq.to(g.dtype) @ g.reshape(R, -1)).reshape(g.shape)
        apply = valid & is_first
    else:
        apply = valid
    safe = torch.where(valid, ids, 0)
    p2, m2, v2, t2 = row_adamw_update(
        table.index_select(0, safe), g, m.index_select(0, safe),
        v.index_select(0, safe), t.index_select(0, safe), apply,
        lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    ids_eff = torch.where(apply, ids, N)  # the dead row past the table

    def scatter(buf, rows):
        pad = buf.new_zeros((1,) + tuple(buf.shape[1:]))
        return torch.cat([buf, pad], 0).index_copy_(0, ids_eff, rows)[:N]

    return scatter(table, p2), scatter(m, m2), scatter(v, v2), scatter(t, t2)


def sparse_adamw(lr_fn, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
    """Lazy row-sparse AdamW as a generic `Optimizer`: per leaf, a leading-
    axis row whose gradient is entirely zero is untouched (its params, both
    moments and its per-row step count stay put; the state carries a [rows]
    int32 count per leaf for the per-row bias correction).  With dense
    nonzero gradients every row updates every step and the trajectory is
    `adamw`'s with the same hyperparameters (the defaults differ:
    embeddings want b2 0.999 and no weight decay).  As the other
    optimizers, the new moments and counts are written into the state's
    tensors."""
    from repro_torch.optim.optimizers import Optimizer, _by_name
    from repro_torch.utils import tree_map

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        counts = lambda p: torch.zeros(p.shape[:1], dtype=torch.int32,  # noqa: E731
                                       device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "t": tree_map(counts, params)}

    def prepare(step):
        return dict(lr=lr_fn(step))

    def leaf(g, s, p, c):
        g32 = g.to(torch.float32)
        touched = (g32 != 0).reshape(g32.shape[0], -1).any(1)
        p2, m2, v2, t2 = row_adamw_update(
            p, g32, s["m"], s["v"], s["t"], touched, lr=c["lr"], b1=b1, b2=b2,
            eps=eps, weight_decay=weight_decay)
        for name, new in (("m", m2), ("v", v2), ("t", t2)):
            s[name].copy_(new)
        return (p2 - p).to(p.dtype), s

    return Optimizer(init, prepare, leaf, *_by_name("m", "v", "t"))
