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


def sddmm_ref(ids: torch.Tensor, mask: torch.Tensor, Hw: torch.Tensor,
              a_src: torch.Tensor, a_dst: torch.Tensor, *,
              slope: float = 0.2) -> torch.Tensor:
    """GAT edge logits over the ELL structure:
    e[v,k] = LeakyReLU(a_dst.Hw[v] + a_src.Hw[ids[v,k]], slope), masked
    slots -1e30.  Hw may hold more rows than ids (the pad row, halo rows):
    dst row v is table row v, the first V rows of the table."""
    s_dst = (Hw @ a_dst)[: ids.shape[0]]
    s_src = (Hw @ a_src)[ids.long()]
    e = s_dst[:, None] + s_src
    e = torch.where(e > 0, e, slope * e)
    return torch.where(mask > 0, e, torch.full_like(e, -1e30))


def ell_attend_dw_ref(ids: torch.Tensor, ct: torch.Tensor,
                      H: torch.Tensor) -> torch.Tensor:
    """The gradient of the weighted ELL sum sum_k w[v,k] * H[ids[v,k]] with
    respect to the weights: dw[v,k] = ct[v] . H[ids[v,k]], for every slot
    (a masked slot reads whatever row its id names; on the engine's layouts
    that is the zero pad row).  Walks the rows in chunks like
    `ell_spmm_ref`, so the gathered block stays bounded."""
    V, K = ids.shape
    D = H.shape[1]
    dw = torch.empty((V, K), dtype=H.dtype, device=H.device)
    step = max(1, _GATHER_ELEMS // max(K * D, 1))
    for r0 in range(0, V, step):
        i = ids[r0:r0 + step].long()
        dw[r0:r0 + step] = (ct[r0:r0 + step, None, :] * H[i]).sum(-1)
    return dw


def ell_slot_transpose_ref(ids: torch.Tensor, mask: torch.Tensor,
                           dz: torch.Tensor, N: int) -> torch.Tensor:
    """The per-slot scalar transpose of an ELL table:
    g[u] = sum of dz[v,k] over the unmasked slots (mask[v,k] != 0) with
    ids[v,k] == u, [N].  One index_add_ over the unmasked slots only; the
    masked ones would all land on the pad row."""
    r, k = torch.nonzero(mask, as_tuple=True)
    g = torch.zeros((N,), dtype=dz.dtype, device=dz.device)
    return g.index_add_(0, ids[r, k].long(), dz[r, k])
