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


def ell_spmm_transpose_ref(ids: torch.Tensor, mask: torch.Tensor,
                           ct: torch.Tensor, N: int, *,
                           normalize: bool = True) -> torch.Tensor:
    """The gradient of `ell_spmm_ref` with respect to H [N, D]:
    dH[ids[v,k]] += mask[v,k] * ct[v], with ct divided by
    max(sum_k mask[v,k], 1) first if ``normalize``.  Walks the rows in
    chunks with index_add_, so the contribution block stays bounded as in
    `ell_spmm_ref`.  Masked slots add exact zeros and are left out: on the
    card, every padded slot of a layout names the same pad row, and their
    atomic adds would queue on it."""
    V, K = ids.shape
    D = ct.shape[1]
    if normalize:
        ct = ct / torch.clamp(mask.sum(1, keepdim=True), min=1.0)
    dH = torch.zeros((N, D), dtype=ct.dtype, device=ct.device)
    step = max(1, _GATHER_ELEMS // max(K * D, 1))
    for r0 in range(0, V, step):
        m = mask[r0:r0 + step]
        r, k = torch.nonzero(m, as_tuple=True)
        dH.index_add_(0, ids[r0:r0 + step][r, k].long(),
                      m[r, k, None] * ct[r0 + r])
    return dH
