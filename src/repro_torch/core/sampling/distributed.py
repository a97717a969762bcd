"""Communication accounting (the port's copy of `CommStats` from
`repro/core/sampling/distributed.py`)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CommStats:
    pull_bytes: int = 0  # neighbor lists / features moved to the requester
    push_bytes: int = 0  # sampling requests + results (CSP)
    cache_hit_bytes: int = 0  # feature bytes served by a local cache instead
    replica_sync_bytes: int = 0  # vertex-cut partial/aggregate rows exchanged
    halo_bytes: int = 0  # edge-cut/hybrid full-graph halo exchange
    embed_grad_bytes: int = 0  # trainable embeddings: layer-0 gradient rows
    inference_bytes: int = 0  # layer-wise full-graph inference sweeps: one
    #   forward-only exchange per layer (cost_models.inference_bytes_per_sweep)

    def reset(self) -> "CommStats":
        """Zero every field IN PLACE, so a reference a caller holds keeps
        observing traffic."""
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)
        return self

    def total(self) -> int:
        """Bytes that actually cross the wire (cache hits excluded)."""
        return (self.pull_bytes + self.push_bytes + self.replica_sync_bytes
                + self.halo_bytes + self.embed_grad_bytes
                + self.inference_bytes)

    def requested(self) -> int:
        """Bytes the computation asked for, whether cached or fetched."""
        return self.total() + self.cache_hit_bytes
