"""Owner-partitioned, id-addressed feature store (the port's copy of the part
of `repro/core/feature_store.py` the inference sweep reads).

One table of shape [k, rows, D] whose row (owner, slot) has the flat store
id ``owner * rows + slot`` — under edge_cut exactly the engine's relabeled
vertex id.  The store keeps the whole table on the host, as the JAX store
does, and its device part on the engine's device: every row, or with
``owner`` that owner's block alone (one rank of a process group).
`update_rows` writes both in place, so the next sweep reads the live rows
without a host-to-device copy of the plane (the JAX store re-uploads its
host copy on every `device_table()` call).

The mini-batch feature cache is a hot-row overlay on the store: each owner
pins a capacity-bounded set of remote store rows (`attach_overlay`), and
with frozen features the overlay is a snapshot taken on the host
(`overlay_table`), exact for as long as the features do not change.  The
live refresh plan of trainable features arrives with them.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


class FeatureStore:
    def __init__(self, table: np.ndarray, device: torch.device,
                 owner: Optional[int] = None):
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

    # -- id addressing --------------------------------------------------
    def owner_of(self, ids) -> np.ndarray:
        return np.asarray(ids) // self.rows

    def slot_of(self, ids) -> np.ndarray:
        return np.asarray(ids) % self.rows

    @property
    def num_rows(self) -> int:
        return self.k * self.rows

    def lookup(self, ids) -> np.ndarray:
        """Rows by flat store id from the host table; a sentinel id ==
        k*rows reads a zero row."""
        ids = np.asarray(ids)
        out = np.zeros(ids.shape + (self.dim,), np.float32)
        real = (ids >= 0) & (ids < self.num_rows)
        out[real] = self._host[ids[real]]
        return out

    def device_table(self) -> torch.Tensor:
        """The device part: the flat [k*rows, D] table, or the owner's
        [rows, D] block (live: later `update_rows` calls show through
        it)."""
        return self._flat

    def host_table(self) -> np.ndarray:
        """The whole flat [k*rows, D] table on the host (live)."""
        return self._host

    def update_rows(self, ids, values) -> None:
        """Write rows by flat store id, on the host and, for the rows it
        holds, on the device."""
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
