"""ELL SpMM (neighbor aggregation), its gradient and the attention-weighted
form: the wrappers of the hand-written CUDA kernels in `csrc/ell_spmm.cu`,
which replace the Pallas TPU kernel `ell_spmm_pallas`
(`src/repro/kernels/ell_spmm.py:38`), its gradient rule `_ell_spmm_bwd`
(`:98`) and the weight gradient of `ell_attend` (`_ell_attend_bwd`, `:129`).

    out[v]   = sum_k mask[v,k] * H[ids[v,k]]   (/ max(sum_k mask[v,k], 1))
    dH[u]    = sum_{ids[v,k] == u} mask[v,k] * ct[v]   (ct / max(deg, 1) likewise)
    dw[v,k]  = ct[v] . H[ids[v,k]]

`ell_spmm` is a `torch.autograd.Function`: the forward kernel, and the
transpose kernel as its backward with respect to H (ids and mask are graph
structure and carry no gradient).  The transpose reads a CSR plan of the
ELL table (`ell_transpose_plan`), built once per engine, so it sums in a
fixed order without float atomics.  `ell_attend` is the same forward with
attention weights in the mask lane, differentiable in the weights too: its
backward is the transpose kernel with the weights and the dw kernel.

A CPU tensor takes the plain version (`ref.py`); a CUDA tensor launches the
kernel on the current stream or raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

Plan = Tuple[torch.Tensor, torch.Tensor]  # (indptr int64 [N+1], slots int64 [nnz])


def _check(ids: torch.Tensor, mask: Optional[torch.Tensor], H: torch.Tensor,
           what: str = "ell_spmm") -> None:
    """ids int32 [V,K], mask float32 [V,K] (None when the kernel takes
    none), rows float32 [*,D]; contiguous, on one cpu or cuda device."""
    tensors = (ids, H) if mask is None else (ids, mask, H)
    if ids.dtype != torch.int32 or H.dtype != torch.float32 or (
            mask is not None and mask.dtype != torch.float32):
        raise TypeError(f"{what} wants ids int32, mask float32, float32 rows; "
                        f"got {[t.dtype for t in tensors]}")
    if ids.dim() != 2 or H.dim() != 2 or (
            mask is not None and mask.shape != ids.shape):
        raise ValueError(f"{what} wants ids [V,K], mask [V,K], rows [*,D]; got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} wants contiguous tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what} wants all tensors on one device; got "
                         f"{[t.device for t in tensors]}")
    if H.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {H.device}")
    if ids.shape[1] >= 2 ** 31 or H.shape[1] >= 2 ** 31:
        raise ValueError(f"{what}: K={ids.shape[1]}, D={H.shape[1]} out of the "
                         "kernel's range")


def _check_plan(plan: Plan, N: int, device, what: str) -> None:
    indptr, slots = plan
    if indptr.dtype != torch.int64 or slots.dtype != torch.int64 \
            or indptr.shape != (N + 1,) or slots.dim() != 1 \
            or indptr.device != device or slots.device != device \
            or not (indptr.is_contiguous() and slots.is_contiguous()):
        raise ValueError(f"{what} wants a plan of int64 indptr [{N + 1}] and "
                         f"int64 slots [nnz] on {device}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("ell_spmm")
    p = ctypes.c_void_p
    lib.ell_spmm_launch.argtypes = [p, p, p, p, ctypes.c_longlong,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    lib.ell_spmm_launch.restype = ctypes.c_int
    lib.ell_spmm_transpose_launch.argtypes = [p, p, p, p, p, ctypes.c_longlong,
                                              ctypes.c_int, ctypes.c_int, p]
    lib.ell_spmm_transpose_launch.restype = ctypes.c_int
    lib.ell_attend_dw_launch.argtypes = [p, p, p, p, ctypes.c_longlong,
                                         ctypes.c_int, ctypes.c_int, p]
    lib.ell_attend_dw_launch.restype = ctypes.c_int
    lib.ell_spmm_error_string.argtypes = [ctypes.c_int]
    lib.ell_spmm_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({lib.ell_spmm_error_string(err).decode()})")


def _forward(ids, mask, H, normalize: bool) -> torch.Tensor:
    if H.device.type == "cpu":
        return ref.ell_spmm_ref(ids, mask, H, normalize=normalize)
    (V, K), D = ids.shape, H.shape[1]
    out = torch.empty((V, D), dtype=torch.float32, device=H.device)
    if V == 0 or D == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(H.device).cuda_stream
    with torch.cuda.device(H.device):
        err = lib.ell_spmm_launch(ids.data_ptr(), mask.data_ptr(),
                                  H.data_ptr(), out.data_ptr(), V, K, D,
                                  int(normalize), stream)
    _raise_on(lib, err, "ell_spmm")
    ell_spmm.launches += 1
    return out


def ell_transpose_plan(ids: torch.Tensor, mask: torch.Tensor, N: int) -> Plan:
    """The CSR transpose of an ELL table: ``slots`` lists v*K + k of every
    slot whose mask is non-zero, grouped by the row ids[v,k] it reads (a
    stable sort, so each segment is in increasing slot order, the same on
    every run), and ``indptr[u]:indptr[u+1]`` is row u's segment.  Built on
    the tensors' device.  A padded transposed ELL would be as wide as the
    largest out-degree, which has no bound on skewed graphs; the CSR is
    nnz long."""
    if ids.dim() != 2 or mask.shape != ids.shape:
        raise ValueError("ell_transpose_plan wants ids [V,K] and mask [V,K]; "
                         f"got {tuple(ids.shape)}, {tuple(mask.shape)}")
    flat = torch.nonzero(mask.reshape(-1) != 0).reshape(-1)  # increasing
    rows = ids.reshape(-1)[flat].long()
    if rows.numel() and not bool((rows.min() >= 0) & (rows.max() < N)):
        raise ValueError(f"ell_transpose_plan: an unmasked id lies outside "
                         f"[0, {N})")
    rows, order = torch.sort(rows, stable=True)
    indptr = torch.searchsorted(
        rows, torch.arange(N + 1, dtype=torch.int64, device=ids.device))
    return indptr, flat[order]


def ell_spmm_transpose(ids: torch.Tensor, mask: torch.Tensor, ct: torch.Tensor,
                       N: int, *, normalize: bool,
                       plan: Optional[Plan] = None) -> torch.Tensor:
    """The gradient of ``ell_spmm(ids, mask, H, normalize=...)`` with respect
    to H [N, D], given the cotangent ct [V, D] of its output.  A CPU tensor
    takes the plain version (a chunked index_add_ over ids); a CUDA tensor
    launches the transpose kernel over ``plan`` (built here when the caller
    passes none)."""
    _check(ids, mask, ct, "ell_spmm_transpose")
    if ct.shape[0] != ids.shape[0]:
        raise ValueError(f"ell_spmm_transpose: ct has {ct.shape[0]} rows, "
                         f"ids {ids.shape[0]}")
    if ct.device.type == "cpu":
        return ref.ell_spmm_transpose_ref(ids, mask, ct, N, normalize=normalize)
    if plan is None:
        plan = ell_transpose_plan(ids, mask, N)
    _check_plan(plan, N, ct.device, "ell_spmm_transpose")
    indptr, slots = plan
    (V, K), D = ids.shape, ct.shape[1]
    if max(V, slots.numel()) >= 2 ** 31:  # the kernel's 32-bit rows and segments
        raise ValueError(f"ell_spmm_transpose: ct's {V} rows and the plan's "
                         f"{slots.numel()} slots must each be below 2**31")
    if normalize:
        ct = (ct / torch.clamp(mask.sum(1, keepdim=True), min=1.0)).contiguous()
    dH = torch.empty((N, D), dtype=torch.float32, device=ct.device)
    if N == 0 or D == 0:
        return dH
    lib = _library()
    stream = torch.cuda.current_stream(ct.device).cuda_stream
    with torch.cuda.device(ct.device):
        err = lib.ell_spmm_transpose_launch(
            indptr.data_ptr(), slots.data_ptr(), mask.data_ptr(),
            ct.data_ptr(), dH.data_ptr(), N, K, D, stream)
    _raise_on(lib, err, "ell_spmm_transpose")
    ell_spmm_transpose.launches += 1
    return dH


class _EllSpmm(torch.autograd.Function):
    """Forward kernel; its backward with respect to H is the transpose
    kernel.  ids and mask get no gradient (graph structure)."""

    @staticmethod
    def forward(ctx, ids, mask, H, normalize, plan):
        ctx.save_for_backward(ids, mask)
        ctx.normalize, ctx.plan, ctx.N = normalize, plan, H.shape[0]
        return _forward(ids, mask, H, normalize)

    @staticmethod
    def backward(ctx, ct):
        if not ctx.needs_input_grad[2]:
            return None, None, None, None, None
        ids, mask = ctx.saved_tensors
        dH = ell_spmm_transpose(ids, mask, ct.contiguous(), ctx.N,
                                normalize=ctx.normalize, plan=ctx.plan)
        return None, None, dH, None, None


def ell_spmm(ids: torch.Tensor, mask: torch.Tensor, H: torch.Tensor, *,
             normalize: bool = True, plan: Optional[Plan] = None) -> torch.Tensor:
    """ids int32 [V,K], mask float32 [V,K] (0/1 structure or edge weights),
    H float32 [N,D] -> float32 [V,D].  Slots whose mask is non-zero must hold
    ids in [0, N).  Differentiable in H; ``plan`` is the transpose plan its
    backward reads on the card (`ell_transpose_plan(ids, mask, N)`, built at
    the first backward when none is given)."""
    _check(ids, mask, H)
    if torch.is_grad_enabled() and mask.requires_grad:
        raise NotImplementedError(
            "ell_spmm gives no gradient for mask (graph structure); use "
            "ell_attend for weights that need one")
    return _EllSpmm.apply(ids, mask, H, normalize, plan)


def ell_attend_dw(ids: torch.Tensor, ct: torch.Tensor,
                  H: torch.Tensor) -> torch.Tensor:
    """The gradient of ``ell_attend(ids, w, H)`` with respect to w, given the
    cotangent ct [V, D] of its output: dw[v,k] = ct[v] . H[ids[v,k]], [V, K],
    on every slot (masked slots too: every id must lie in [0, N), as on the
    engine's layouts, where a masked slot names the zero pad row)."""
    _check(ids, None, H, "ell_attend_dw")
    if ct.dtype != torch.float32 or ct.shape != (ids.shape[0], H.shape[1]) \
            or not ct.is_contiguous() or ct.device != H.device:
        raise ValueError(f"ell_attend_dw wants ct float32 "
                         f"[{ids.shape[0]}, {H.shape[1]}] on {H.device}; got "
                         f"{ct.dtype} {tuple(ct.shape)} on {ct.device}")
    if H.device.type == "cpu":
        return ref.ell_attend_dw_ref(ids, ct, H)
    (V, K), D = ids.shape, H.shape[1]
    dw = torch.empty((V, K), dtype=torch.float32, device=H.device)
    if V == 0 or K == 0:
        return dw
    lib = _library()
    # H's device and its current stream, switched to only when H lies on
    # another device: a short kernel's call is paid for in host time
    index = H.device.index
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        err = lib.ell_attend_dw_launch(ids.data_ptr(), ct.data_ptr(),
                                       H.data_ptr(), dw.data_ptr(), V, K, D,
                                       torch._C._cuda_getCurrentRawStream(index))
    _raise_on(lib, err, "ell_attend_dw")
    ell_attend_dw.launches += 1
    return dw


class _EllAttend(torch.autograd.Function):
    """Forward kernel with the weights in the mask lane; the backward is the
    transpose kernel with the weights (dH) and the dw kernel (dw)."""

    @staticmethod
    def forward(ctx, ids, w, H, plan):
        ctx.save_for_backward(ids, w, H)
        ctx.plan = plan
        return _forward(ids, w, H, False)

    @staticmethod
    def backward(ctx, ct):
        ids, w, H = ctx.saved_tensors
        ct = ct.contiguous()
        dw = ell_attend_dw(ids, ct, H) if ctx.needs_input_grad[1] else None
        dH = (ell_spmm_transpose(ids, w, ct, H.shape[0], normalize=False,
                                 plan=ctx.plan)
              if ctx.needs_input_grad[2] else None)
        return None, dw, dH, None


def ell_attend(ids: torch.Tensor, weights: torch.Tensor, H: torch.Tensor, *,
               plan: Optional[Plan] = None) -> torch.Tensor:
    """Attention-weighted ELL sum, out[v] = sum_k weights[v,k] * H[ids[v,k]]
    (no normalization), differentiable in both weights and H (the
    counterpart of `repro.kernels.ell_spmm.ell_attend`).  ``plan`` is a
    transpose plan listing every slot whose weight can be non-zero (the
    structural plan of the ELL table: attention weights vanish off the
    structure); its backward builds one from the weights when none is
    given."""
    _check(ids, weights, H, "ell_attend")
    return _EllAttend.apply(ids, weights, H, plan)


ell_spmm.launches = 0  # kernel launches since the last reset (CPU calls excluded)
ell_spmm_transpose.launches = 0  # likewise, for the transpose kernel
ell_attend_dw.launches = 0  # likewise, for the weight-gradient kernel
