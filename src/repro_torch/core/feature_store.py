"""Owner-partitioned, id-addressed feature/embedding store (the port's copy
of `repro/core/feature_store.py`).

One table of shape [k, rows, D] whose row (owner, slot) has the flat store
id ``owner * rows + slot``: under edge_cut exactly the engine's relabeled
vertex id, under the replica families its replica-slot id.  The store keeps
the whole table on the host, as the JAX store does, and its device part on
the engine's device: every row, or with ``owner`` that owner's block alone
(one rank of a process group).  `update_rows` writes both in place, so the
next sweep reads the live rows without a host-to-device copy of the plane
(the JAX store re-uploads its host copy on every `device_table()` call).

The mini-batch feature cache is a hot-row overlay on the store: each owner
pins a capacity-bounded set of remote store rows (`attach_overlay`).  With
frozen features the overlay is a snapshot taken on the host
(`overlay_table`), exact for as long as the features do not change; with
trainable rows it must be re-read from the live owner shards every step,
through the static bucketed all_to_all plan `overlay_refresh_plan` builds
(whose reverse routes the cache hits' gradients back to the owners).
`touched_rows_from_frontier` gives the row-sparse optimizer its ids.

The module imports numpy only at the top (torch inside the methods that
need it): the sampling worker processes read `touched_rows_from_frontier`
and must not import torch.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.execution.bucketing import (
    bucketed_cap_widths,
    bucketed_send_table,
    halo_slot,
)


class FeatureStore:
    def __init__(self, table: np.ndarray, device: "torch.device",
                 owner: Optional[int] = None):
        import torch

        table = np.array(table, np.float32)
        if table.ndim != 3:
            raise ValueError(
                f"FeatureStore wants [k, rows, D]; got shape {table.shape}")
        self.k, self.rows, self.dim = table.shape
        self._host = table.reshape(self.k * self.rows, self.dim)
        # the flat store ids the device part holds: [first, first + n)
        self._first = 0 if owner is None else owner * self.rows
        n = self.num_rows if owner is None else self.rows
        self._flat = torch.from_numpy(
            self._host[self._first:self._first + n]).to(device)
        self._overlay_ids: Optional[List[np.ndarray]] = None
        self._overlay_cap = 0
        self._overlay_tab: Optional[np.ndarray] = None
        # set by DistGNNEngine.enable_telemetry: the overlay hit, miss and
        # refresh counters land in the run's MetricRegistry (None: none)
        self.telemetry = None

    def count_overlay(self, device: int, hits: int, misses: int) -> None:
        """Per-batch overlay accounting (the engine's extract stage knows
        which remote frontier rows the hot-row overlay served)."""
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.counter("store.overlay_hit", device=device).add(int(hits))
            tel.counter("store.overlay_miss", device=device).add(int(misses))

    # -- id addressing --------------------------------------------------
    def owner_of(self, ids) -> np.ndarray:
        return np.asarray(ids) // self.rows

    def slot_of(self, ids) -> np.ndarray:
        return np.asarray(ids) % self.rows

    @property
    def num_rows(self) -> int:
        return self.k * self.rows

    @classmethod
    def from_flat(cls, flat: np.ndarray, k: int, device: "torch.device",
                  owner: Optional[int] = None) -> "FeatureStore":
        """A store from a flat [k*rows, D] table."""
        flat = np.asarray(flat, np.float32)
        return cls(flat.reshape(k, flat.shape[0] // k, flat.shape[1]), device,
                   owner=owner)

    def flat(self) -> np.ndarray:
        """The whole flat [k*rows, D] table on the host (live)."""
        return self._host

    def lookup(self, ids) -> np.ndarray:
        """Rows by flat store id from the host table; a sentinel id ==
        k*rows reads a zero row."""
        ids = np.asarray(ids)
        out = np.zeros(ids.shape + (self.dim,), np.float32)
        real = (ids >= 0) & (ids < self.num_rows)
        out[real] = self._host[ids[real]]
        return out

    def device_table(self) -> "torch.Tensor":
        """The device part: the flat [k*rows, D] table, or the owner's
        [rows, D] block (live: later `update_rows` calls show through
        it)."""
        return self._flat

    def update_rows(self, ids, values) -> None:
        """Write rows by flat store id, on the host and, for the rows it
        holds, on the device."""
        import torch

        ids = np.asarray(ids, np.int64)
        values = np.asarray(values, np.float32)
        self._host[ids] = values
        local = (ids >= self._first) & (ids < self._first + len(self._flat))
        dev = self._flat.device
        self._flat.index_copy_(
            0, torch.as_tensor(ids[local] - self._first, device=dev),
            torch.as_tensor(values[local], device=dev))

    # -- hot-row overlay (the mini-batch cache as a view of the store) ---
    def attach_overlay(self, ids_per_device: Sequence[np.ndarray],
                       capacity: int) -> None:
        """Pin per-owner hot REMOTE store rows (a cache policy's ranking,
        relabeled to store ids); ``capacity`` is the padded slot count of
        every owner's overlay table."""
        if len(ids_per_device) != self.k:
            raise ValueError(f"want {self.k} id lists, got "
                             f"{len(ids_per_device)}")
        ids_per_device = [np.asarray(a, np.int64) for a in ids_per_device]
        for d, a in enumerate(ids_per_device):
            if len(a) > capacity:
                raise ValueError(f"device {d} overlay {len(a)} > capacity "
                                 f"{capacity}")
            if np.any(self.owner_of(a) == d):
                raise ValueError(f"device {d} overlay contains its own rows "
                                 "(local rows are already resident)")
        self._overlay_ids = ids_per_device
        self._overlay_cap = int(capacity)
        self.refresh_overlay()

    def overlay_table(self) -> np.ndarray:
        """[k, capacity, D] overlay snapshot (zeros past each owner's real
        rows): the engine's static cache table while features are frozen."""
        if self._overlay_tab is None:
            raise ValueError("no overlay attached")
        return self._overlay_tab

    def refresh_overlay(self) -> None:
        """Re-read the overlay snapshot from the current host table."""
        tab = np.zeros((self.k, self._overlay_cap, self.dim), np.float32)
        for d, a in enumerate(self._overlay_ids):
            tab[d, : len(a)] = self.lookup(a)
        self._overlay_tab = tab
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.counter("store.overlay_refresh").add(1)


def overlay_refresh_plan(ids_per_device: Sequence[np.ndarray], k: int,
                         rows: int, capacity: int, buckets: int = 1
                         ) -> Tuple[np.ndarray, np.ndarray, list]:
    """Static plan to re-gather every owner's overlay rows from the LIVE
    owner shards inside the step: returns (send_rows [k, B, k, w], tab_ids
    [k, capacity], widths).

    The read side mirrors the p2p frontier fetch: rank d builds table =
    [own shard | bucketed_all_to_all(own shard, send_rows[d]) | zero row]
    and reads tab_ids[d]: slot j < len(ids) yields overlay row j, the rest
    read the zero row.  The plan is static, so the refresh is part of every
    step, and its reverse all_to_all routes the cache hits' gradients back
    to the owners' shards."""
    ids_per_device = [np.asarray(a, np.int64) for a in ids_per_device]
    need_lists = [[np.zeros(0, np.int64) for _ in range(k)]
                  for _ in range(k)]  # [src][dst]
    for d, a in enumerate(ids_per_device):
        owners = a // rows
        for s in range(k):
            if s != d:
                need_lists[s][d] = (a[owners == s] % rows)
    cap = max(1, max((len(x) for row in need_lists for x in row), default=1))
    widths = bucketed_cap_widths(cap, buckets)
    B, w = len(widths), widths[0]
    send_rows = bucketed_send_table(need_lists, k, widths)
    tab_ids = np.full((k, capacity), rows + B * k * w, np.int32)
    for d, a in enumerate(ids_per_device):
        # the t-th row a owner s ships to d lands at halo slot t of s
        owners = a // rows
        t = np.zeros(len(a), np.int64)
        for s in range(k):
            sel = owners == s
            t[sel] = np.arange(int(sel.sum()))
        tab_ids[d, :len(a)] = halo_slot(t, owners, w, k, rows)
    return send_rows, tab_ids, widths


def touched_rows_from_frontier(frontier_sids: np.ndarray, k: int, rows: int,
                               cap: int) -> np.ndarray:
    """Per-OWNER touched local-row lists from a batch's frontier store ids:
    frontier_sids [k, cap0] (sentinel k*rows for pads) -> ids [k, cap] int32
    whose row s lists the distinct local rows of owner s any rank's frontier
    reads this step, sorted, then the sentinel ``rows``.

    This is the row-sparse optimizer's id set: a row is touched iff some
    rank's frontier reads it, a cache hit or a miss (a hit reads the
    refreshed overlay, whose gradient still lands on the owner's shard)."""
    sids = np.asarray(frontier_sids).ravel()
    sids = sids[(sids >= 0) & (sids < k * rows)]
    out = np.full((k, cap), rows, np.int32)
    owners, slots = sids // rows, sids % rows
    for s in range(k):
        uniq = np.unique(slots[owners == s])
        if len(uniq) > cap:
            raise ValueError(f"touched-row cap overflow: owner {s} has "
                             f"{len(uniq)} touched rows, cap={cap}")
        out[s, : len(uniq)] = uniq
    return out
