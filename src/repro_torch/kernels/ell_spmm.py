"""ELL SpMM (neighbor aggregation): the wrapper of the hand-written CUDA
kernel `csrc/ell_spmm.cu`, which replaces the Pallas TPU kernel
`ell_spmm_pallas` (`src/repro/kernels/ell_spmm.py:38`).

    out[v] = sum_k mask[v,k] * H[ids[v,k]]   (/ max(sum_k mask[v,k], 1))

A CPU tensor takes the plain version (`ref.ell_spmm_ref`); a CUDA tensor
launches the kernel on the current stream or raises.  Forward only: the
scatter-add backward arrives with the training slice.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref


def _check(ids: torch.Tensor, mask: torch.Tensor, H: torch.Tensor) -> None:
    if ids.dtype != torch.int32 or mask.dtype != torch.float32 \
            or H.dtype != torch.float32:
        raise TypeError("ell_spmm wants ids int32, mask float32, H float32; "
                        f"got {ids.dtype}, {mask.dtype}, {H.dtype}")
    if ids.dim() != 2 or H.dim() != 2 or mask.shape != ids.shape:
        raise ValueError("ell_spmm wants ids [V,K], mask [V,K], H [N,D]; got "
                         f"{tuple(ids.shape)}, {tuple(mask.shape)}, "
                         f"{tuple(H.shape)}")
    if not (ids.is_contiguous() and mask.is_contiguous()
            and H.is_contiguous()):
        raise ValueError("ell_spmm wants contiguous tensors")
    if not ids.device == mask.device == H.device:
        raise ValueError("ell_spmm wants all tensors on one device; got "
                         f"{ids.device}, {mask.device}, {H.device}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("ell_spmm")
    p = ctypes.c_void_p
    lib.ell_spmm_launch.argtypes = [p, p, p, p, ctypes.c_longlong,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    lib.ell_spmm_launch.restype = ctypes.c_int
    lib.ell_spmm_error_string.argtypes = [ctypes.c_int]
    lib.ell_spmm_error_string.restype = ctypes.c_char_p
    return lib


def ell_spmm(ids: torch.Tensor, mask: torch.Tensor, H: torch.Tensor, *,
             normalize: bool = True) -> torch.Tensor:
    """ids int32 [V,K], mask float32 [V,K] (0/1 structure or edge weights),
    H float32 [N,D] -> float32 [V,D].  Slots whose mask is non-zero must hold
    ids in [0, N)."""
    _check(ids, mask, H)
    if torch.is_grad_enabled() and (H.requires_grad or mask.requires_grad):
        raise NotImplementedError(
            "ell_spmm has no backward yet (the scatter-add arrives with the "
            "training slice); call it under torch.no_grad()")
    if H.device.type == "cpu":
        return ref.ell_spmm_ref(ids, mask, H, normalize=normalize)
    if H.device.type != "cuda":
        raise ValueError(f"ell_spmm runs on cpu or cuda tensors, not {H.device}")
    (V, K), D = ids.shape, H.shape[1]
    if K >= 2 ** 31 or D >= 2 ** 31:
        raise ValueError(f"ell_spmm: K={K}, D={D} out of the kernel's range")
    out = torch.empty((V, D), dtype=torch.float32, device=H.device)
    if V == 0 or D == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(H.device).cuda_stream
    with torch.cuda.device(H.device):
        err = lib.ell_spmm_launch(ids.data_ptr(), mask.data_ptr(),
                                  H.data_ptr(), out.data_ptr(), V, K, D,
                                  int(normalize), stream)
    if err != 0:
        raise RuntimeError("ell_spmm kernel launch failed: CUDA error "
                           f"{err} ({lib.ell_spmm_error_string(err).decode()})")
    ell_spmm.launches += 1
    return out


ell_spmm.launches = 0  # kernel launches since the last reset (CPU calls excluded)
