"""Owner-partitioned, id-addressed feature store (the port's copy of the part
of `repro/core/feature_store.py` the inference sweep reads).

One table of shape [k, rows, D] whose row (owner, slot) has the flat store
id ``owner * rows + slot`` — under edge_cut exactly the engine's relabeled
vertex id.  The port keeps the table on the engine's device and writes
`update_rows` into it in place, so the next sweep reads the live rows
without a host-to-device copy of the whole plane (the JAX store keeps a host
copy and re-uploads it on every `device_table()` call).
"""
from __future__ import annotations

import numpy as np
import torch


class FeatureStore:
    def __init__(self, table: np.ndarray, device: torch.device):
        table = np.asarray(table, np.float32)
        if table.ndim != 3:
            raise ValueError(
                f"FeatureStore wants [k, rows, D]; got shape {table.shape}")
        self.k, self.rows, self.dim = table.shape
        self._flat = torch.from_numpy(
            table.reshape(self.k * self.rows, self.dim)).to(device)

    @property
    def num_rows(self) -> int:
        return self.k * self.rows

    def device_table(self) -> torch.Tensor:
        """The flat [k*rows, D] table on the engine's device (live: later
        `update_rows` calls show through it)."""
        return self._flat

    def update_rows(self, ids, values) -> None:
        """Write rows by flat store id."""
        ids = torch.as_tensor(np.asarray(ids, np.int64), device=self._flat.device)
        values = torch.as_tensor(np.asarray(values, np.float32),
                                 device=self._flat.device)
        self._flat.index_copy_(0, ids, values)
