"""Flash attention forward: the wrapper of the hand-written CUDA kernel in
`csrc/flash_attention.cu`, which replaces the Pallas TPU kernel
`flash_attention_pallas` / `_flash_kernel`
(`src/repro/kernels/flash_attention.py:59` / `:20`).

    o[b,h,q] = sum_k softmax_k(q[b,h,q] . k[b,h,k] / sqrt(D)) v[b,h,k]

q [B,H,S,D], k and v [B,H,T,D], fp32 or bf16 (all three alike), D in
{32, 64, 128}; with ``causal`` query q sees key k only if k <= q.  The
output takes q's dtype.  Forward only, as the Pallas kernel: it has no
gradient rule.

A CPU tensor takes the plain version (`ref.flash_attention_ref`); a CUDA
tensor launches the kernel on the current stream or raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (32, 64, 128)  # the widths the kernel is instantiated for
_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                           ctypes.c_float, p]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    qkv = (q, k, v)
    if any(t.dim() != 4 for t in qkv):
        raise ValueError(f"flash_attention wants q [B,H,S,D], k and v "
                         f"[B,H,T,D]; got {[tuple(t.shape) for t in qkv]}")
    B, H, _, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"flash_attention wants k and v [{B},{H},T,{D}] "
                         f"beside q {tuple(q.shape)}; got k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention wants q, k, v all float32 or all "
                        f"bfloat16; got {[t.dtype for t in qkv]}")
    if len({t.device for t in qkv}) != 1:
        raise ValueError(f"flash_attention wants q, k, v on one device; got "
                         f"{[t.device for t in qkv]}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, not "
                         f"{q.device}")


def _check_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the CUDA kernel takes beyond `_check`: D in `HEAD_DIMS`, no
    gradient, contiguous 16-byte aligned tensors, 32-bit offsets."""
    B, H, S, D = q.shape
    T = k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention's kernel is built for head dims "
                         f"{HEAD_DIMS}; got D={D}")
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention's CUDA kernel is forward only (the Pallas kernel "
            "it replaces has no gradient rule); detach the inputs")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError("flash_attention's kernel wants contiguous, 16-byte "
                         "aligned q, k, v")
    if B * H * max(S, T) * D >= 2 ** 31 or B * H * ((S + 63) // 64) >= 2 ** 31:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} / T={T} out "
                         "of the kernel's range")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """softmax(q.k^T / sqrt(D)) . v -> [B,H,S,D] in q's dtype (see the
    module docstring)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    _check_kernel(q, k, v)
    B, H, S, D = q.shape
    T = k.shape[2]
    o = torch.empty_like(q)
    if B * H * S == 0:
        return o
    lib = _library()
    # q's device and its current stream, switched to only when q lies on
    # another device: a short kernel's call is paid for in host time
    index = q.device.index
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B * H, S, T,
            D, int(q.dtype == torch.bfloat16), int(causal), float(D ** -0.5),
            torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err} ({lib.flash_attention_error_string(err).decode()})")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0  # kernel launches since the last reset (CPU calls excluded)
