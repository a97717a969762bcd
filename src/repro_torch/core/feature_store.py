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
"""
from __future__ import annotations

from typing import Optional

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

    @property
    def num_rows(self) -> int:
        return self.k * self.rows

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
