"""GAT edge logits over ELL structure (SDDMM) and the per-slot scalar
transpose: the wrappers of the hand-written CUDA kernels in `csrc/sddmm.cu`,
which replace the Pallas TPU kernel `sddmm_pallas`
(`src/repro/kernels/sddmm.py:35`) and the scatter-add of its gradient rule
`_sddmm_bwd` (`:100`).

    e[v,k] = LeakyReLU(a_dst.Hw[v] + a_src.Hw[ids[v,k]], slope)   (-1e30 masked)
    g[u]   = sum_{unmasked (v,k): ids[v,k] == u} dz[v,k]

`sddmm_ell` is a `torch.autograd.Function` with the reference's analytic
gradient: dz is elementwise, g_dst a row sum, g_src the slot transpose (over
the CSR plan of `ell_transpose_plan`, so it sums in a fixed order without
float atomics), and dHw, da_src, da_dst rank-1 products and Hw^T g in torch
ops, as XLA computes them outside the Pallas call.  `ell_slot_gather` is the
gather col[ids] over the unmasked slots whose gradient is the same transpose.

A CPU tensor takes the plain version (`ref.py`); a CUDA tensor launches the
kernel on the current stream or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.ell_spmm import (
    Plan,
    _check,
    _check_plan,
    ell_transpose_plan,
)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("sddmm")
    p = ctypes.c_void_p
    lib.sddmm_launch.argtypes = [p, p, p, p, p, p, p, p, ctypes.c_longlong,
                                 ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_float, p]
    lib.sddmm_launch.restype = ctypes.c_int
    lib.ell_slot_transpose_launch.argtypes = [p, p, p, p, ctypes.c_longlong, p]
    lib.ell_slot_transpose_launch.restype = ctypes.c_int
    lib.sddmm_error_string.argtypes = [ctypes.c_int]
    lib.sddmm_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({lib.sddmm_error_string(err).decode()})")


def sddmm(ids: torch.Tensor, mask: torch.Tensor, Hw: torch.Tensor,
          a_src: torch.Tensor, a_dst: torch.Tensor, *,
          slope: float = 0.2) -> torch.Tensor:
    """The forward kernel: masked GAT edge logits e [V, K].  ids int32
    [V,K], mask float32 [V,K], Hw float32 [N,D] with N >= V (dst row v is
    table row v), a_src and a_dst float32 [D].  Unmasked slots must hold ids
    in [0, N)."""
    _check(ids, mask, Hw, "sddmm")
    (V, K), (N, D) = ids.shape, Hw.shape
    for a in (a_src, a_dst):
        if a.dtype != torch.float32 or a.shape != (D,) \
                or not a.is_contiguous() or a.device != Hw.device:
            raise ValueError(f"sddmm wants a_src, a_dst float32 [{D}] on "
                             f"{Hw.device}; got {a.dtype} {tuple(a.shape)} on "
                             f"{a.device}")
    if N < V:
        raise ValueError(f"sddmm: the table's first V rows are the dst rows; "
                         f"got N={N} < V={V}")
    if Hw.device.type == "cpu":
        return ref.sddmm_ref(ids, mask, Hw, a_src, a_dst, slope=slope)
    e = torch.empty((V, K), dtype=torch.float32, device=Hw.device)
    if V == 0 or K == 0:
        return e
    s_src = torch.empty((N,), dtype=torch.float32, device=Hw.device)
    s_dst = torch.empty((V,), dtype=torch.float32, device=Hw.device)
    lib = _library()
    stream = torch.cuda.current_stream(Hw.device).cuda_stream
    with torch.cuda.device(Hw.device):
        err = lib.sddmm_launch(ids.data_ptr(), mask.data_ptr(), Hw.data_ptr(),
                               a_src.data_ptr(), a_dst.data_ptr(),
                               s_src.data_ptr(), s_dst.data_ptr(), e.data_ptr(),
                               N, V, K, D, float(slope), stream)
    _raise_on(lib, err, "sddmm")
    sddmm.launches += 1
    return e


def ell_slot_transpose(ids: torch.Tensor, mask: torch.Tensor, dz: torch.Tensor,
                       N: int, *, plan: Optional[Plan] = None) -> torch.Tensor:
    """g [N]: g[u] = sum of dz[v,k] over the unmasked slots (mask != 0) with
    ids[v,k] == u.  A CPU tensor takes the plain version (an index_add_ over
    the unmasked slots); a CUDA tensor launches the transpose kernel over
    ``plan`` (`ell_transpose_plan(ids, mask, N)`, built here when the caller
    passes none)."""
    _check(ids, mask, dz, "ell_slot_transpose")
    if dz.shape != ids.shape:
        raise ValueError(f"ell_slot_transpose wants dz {tuple(ids.shape)}; got "
                         f"{tuple(dz.shape)}")
    if dz.device.type == "cpu":
        return ref.ell_slot_transpose_ref(ids, mask, dz, N)
    if plan is None:
        plan = ell_transpose_plan(ids, mask, N)
    _check_plan(plan, N, dz.device, "ell_slot_transpose")
    g = torch.empty((N,), dtype=torch.float32, device=dz.device)
    if N == 0:
        return g
    lib = _library()
    stream = torch.cuda.current_stream(dz.device).cuda_stream
    with torch.cuda.device(dz.device):
        err = lib.ell_slot_transpose_launch(plan[0].data_ptr(),
                                            plan[1].data_ptr(), dz.data_ptr(),
                                            g.data_ptr(), N, stream)
    _raise_on(lib, err, "ell_slot_transpose")
    ell_slot_transpose.launches += 1
    return g


class _Sddmm(torch.autograd.Function):
    """Forward kernel; the backward is `_sddmm_bwd`'s analytic rule with the
    slot transpose for g_src.  ids and mask get no gradient."""

    @staticmethod
    def forward(ctx, ids, mask, Hw, a_src, a_dst, slope, plan):
        ctx.save_for_backward(ids, mask, Hw, a_src, a_dst)
        ctx.slope, ctx.plan = slope, plan
        return sddmm(ids, mask, Hw, a_src, a_dst, slope=slope)

    @staticmethod
    def backward(ctx, ct):
        ids, mask, Hw, a_src, a_dst = ctx.saved_tensors
        V, N = ids.shape[0], Hw.shape[0]
        s_dst, s_src = Hw @ a_dst, Hw @ a_src
        z = s_dst[:V, None] + s_src.index_select(0, ids.reshape(-1)).view(ids.shape)
        dz = (ct * torch.where(z > 0, 1.0, ctx.slope) * (mask > 0)).contiguous()
        g_dst = torch.zeros((N,), dtype=Hw.dtype, device=Hw.device)
        g_dst[:V] = dz.sum(1)
        g_src = ell_slot_transpose(ids, mask, dz, N, plan=ctx.plan)
        dHw = g_dst[:, None] * a_dst[None, :] + g_src[:, None] * a_src[None, :]
        return (None, None, dHw, Hw.t() @ g_src, Hw.t() @ g_dst, None, None)


def sddmm_ell(ids: torch.Tensor, mask: torch.Tensor, Hw: torch.Tensor,
              a_src: torch.Tensor, a_dst: torch.Tensor, *, slope: float = 0.2,
              plan: Optional[Plan] = None) -> torch.Tensor:
    """Differentiable masked GAT edge logits over the ELL structure (the
    counterpart of `repro.kernels.sddmm.sddmm_ell`): the forward kernel,
    gradients to Hw, a_src and a_dst.  ``plan`` is the transpose plan of
    (ids, mask, Hw.shape[0]) its backward reads on the card (built there when
    none is given)."""
    return _Sddmm.apply(ids, mask, Hw, a_src, a_dst, slope, plan)


class _SlotGather(torch.autograd.Function):
    """col[ids] on the unmasked slots, 0 on the masked ones; its backward is
    the slot transpose."""

    @staticmethod
    def forward(ctx, col, ids, mask, plan):
        ctx.save_for_backward(ids, mask)
        ctx.N, ctx.plan = col.shape[0], plan
        picked = col.index_select(0, ids.reshape(-1)).view(ids.shape)
        return torch.where(mask != 0, picked, 0.0)

    @staticmethod
    def backward(ctx, ct):
        ids, mask = ctx.saved_tensors
        g = ell_slot_transpose(ids, mask, ct.contiguous(), ctx.N, plan=ctx.plan)
        return g, None, None, None


def ell_slot_gather(col: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor, *,
                    plan: Optional[Plan] = None) -> torch.Tensor:
    """s[v,k] = col[ids[v,k]] on the unmasked slots and 0 on the masked ones,
    [V, K], differentiable in col [N]: its gradient is the slot transpose
    over ``plan``.  Autograd's own rule for ``col[ids]`` would scatter every
    masked slot into the pad row, one serial run on the card."""
    if col.dim() != 1:
        raise ValueError(f"ell_slot_gather wants a column [N]; got "
                         f"{tuple(col.shape)}")
    return _SlotGather.apply(col, ids, mask, plan)


sddmm.launches = 0  # kernel launches since the last reset (CPU calls excluded)
ell_slot_transpose.launches = 0  # likewise, for the slot transpose kernel
