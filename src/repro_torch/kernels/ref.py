"""Plain PyTorch versions of the port's kernels: the CPU path of each
wrapper and the oracle the CUDA kernels are held against on the card."""
from __future__ import annotations

import torch

# elements of the [rows, K, D] gathered block materialized at once: 2**24
# fp32 values = 64 MiB.  One unchunked gather at the gcn-paper shape
# (2**20 x 38 x 256) would be 40 GB.
_GATHER_ELEMS = 1 << 24


def ell_spmm_ref(ids: torch.Tensor, mask: torch.Tensor, H: torch.Tensor,
                 *, normalize: bool = True) -> torch.Tensor:
    """ELLPACK aggregation: out[v] = sum_k mask[v,k] * H[ids[v,k]], divided
    by max(sum_k mask[v,k], 1) if ``normalize``.  ids [V,K] int (padded
    entries point anywhere in [0, N) but are masked), mask [V,K] float,
    H [N,D].  Walks the rows in chunks with the same math, so the gathered
    block stays bounded."""
    V, K = ids.shape
    D = H.shape[1]
    out = torch.empty((V, D), dtype=H.dtype, device=H.device)
    step = max(1, _GATHER_ELEMS // max(K * D, 1))
    for r0 in range(0, V, step):
        i, m = ids[r0:r0 + step].long(), mask[r0:r0 + step]
        y = (m[..., None] * H[i]).sum(1)
        if normalize:
            y = y / torch.clamp(m.sum(1, keepdim=True), min=1.0)
        out[r0:r0 + step] = y
    return out
