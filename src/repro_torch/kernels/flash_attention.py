"""Flash attention forward and backward: the wrappers of the hand-written
CUDA kernels in `csrc/flash_attention.cu` and `csrc/flash_attention_bwd.cu`
(bf16: `wgmma` with TMA-fed tiles in both directions; fp32: SIMT FFMA).
The forward replaces the Pallas TPU kernel `flash_attention_pallas` /
`_flash_kernel` (`src/repro/kernels/flash_attention.py:59` / `:20`); the
backward's two kernels (dQ, then dK and dV) replace JAX's autodiff of the
reference's `chunked_attention` (`src/repro/models/layers.py:167`): the
Pallas kernel has no gradient rule.

    o[b,h,q] = sum_k softmax_k(q[b,h,q] . k[b,h,k] / sqrt(D)) v[b,h,k]

q [B,H,S,D], k and v [B,H,T,D], fp32 or bf16 (all three alike), D in
{32, 64, 128}; with ``causal`` query q sees key k only if k <= q.  The
output takes q's dtype.

`flash_attention` is differentiable: on a CUDA tensor that needs a
gradient it runs `_FlashAttention`, whose forward launches the forward
kernel with its log-sum-exp output and whose backward launches
`flash_attention_bwd_dq` and `flash_attention_bwd_dkdv`; without a gradient
it launches the forward alone (no LSE).  A CPU tensor takes the plain
version (`ref.flash_attention_ref`, differentiable through autograd); a
CUDA tensor launches the kernels on the current stream or raises.  Each
wrapper counts its own launches.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (32, 64, 128)  # the widths the kernels are instantiated for
_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, p]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    """The backward's kernels, a source of their own
    (`csrc/flash_attention_bwd.cu`), built beside the forward's."""
    lib = build.load("flash_attention_bwd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ("flash_attention_bwd_dq_launch", "flash_attention_bwd_dkdv_launch"):
        getattr(lib, name).argtypes = [p] * 8 + [i] * 6 + [f, p]
        getattr(lib, name).restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    lib.flash_attention_bwd_resources.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    lib.flash_attention_bwd_resources.restype = ctypes.c_int
    return lib


def bwd_kernel_resources(D: int, dtype: torch.dtype) -> dict:
    """Per backward pass ("dq", "dkdv"): the causal kernel's registers a
    thread, local (spilled) bytes a thread, dynamic shared memory a CTA and
    CTAs an SM (the occupancy calculator on the current card), for head dim
    D and dtype (bf16: the wgmma kernels; fp32: the SIMT ones)."""
    out = {}
    for name, dkdv in (("dq", 0), ("dkdv", 1)):
        got = (ctypes.c_int * 4)()
        err = _bwd_library().flash_attention_bwd_resources(
            D, int(dtype == torch.bfloat16), 1, dkdv, got)
        _raise_on_bwd(err, "flash_attention_bwd_resources")
        out[name] = dict(registers=got[0], local_bytes=got[1],
                         smem_bytes=got[2], ctas_per_sm=got[3])
    return out


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


def _aligned(*ts) -> bool:
    return all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts)


def _check_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the CUDA kernels take beyond `_check`: D in `HEAD_DIMS`,
    contiguous 16-byte aligned tensors, 32-bit offsets."""
    B, H, S, D = q.shape
    T = k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention's kernel is built for head dims "
                         f"{HEAD_DIMS}; got D={D}")
    if not _aligned(q, k, v):
        raise ValueError("flash_attention's kernel wants contiguous, 16-byte "
                         "aligned q, k, v")
    if B * H * max(S, T) * D >= 2 ** 31 or B * H * ((S + 63) // 64) >= 2 ** 31:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} / T={T} out "
                         "of the kernel's range")


def _check_bwd(q, k, v, o, lse, do) -> None:
    """The backward's extra inputs: o and do like q, lse [B,H,S] fp32."""
    _check(q, k, v)
    if q.device.type == "cuda":
        _check_kernel(q, k, v)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention's backward wants {name} like q "
                             f"{tuple(q.shape)} {q.dtype}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention's backward wants lse "
                         f"{tuple(q.shape[:3])} float32; got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if q.device.type == "cuda" and not _aligned(o, do, lse):
        raise ValueError("flash_attention's backward wants contiguous, 16-byte "
                         "aligned o, do and lse")


@contextlib.contextmanager
def _on(device: torch.device):
    """q's device, switched to only when it is not current: a short
    kernel's call is paid for in host time."""
    with (contextlib.nullcontext() if device.index == torch.cuda.current_device()
          else torch.cuda.device(device.index)):
        yield torch._C._cuda_getCurrentRawStream(device.index)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({_library().flash_attention_error_string(err).decode()})")


def _raise_on_bwd(err: int, what: str) -> None:
    if err != 0:
        text = _bwd_library().flash_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({text})")


def _forward(q, k, v, causal: bool, with_lse: bool):
    """One launch of the forward kernel: (o, lse [B,H,S] fp32 or None)."""
    _check_kernel(q, k, v)
    B, H, S, D = q.shape
    T = k.shape[2]
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B * H * S == 0:
        return o, lse
    with _on(q.device) as stream:
        err = _library().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), B * H, S, T, D,
            int(q.dtype == torch.bfloat16), int(causal), float(D ** -0.5),
            stream)
    _raise_on(err, "flash_attention")
    flash_attention.launches += 1
    return o, lse


class _FlashAttention(torch.autograd.Function):
    """The kernels under autograd: the forward with its LSE, the backward's
    two passes."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = _forward(q, k, v, causal, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """softmax(q.k^T / sqrt(D)) . v -> [B,H,S,D] in q's dtype (see the
    module docstring); differentiable on both paths."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        _check_kernel(q, k, v)
        return _FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal, False)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             *, causal: bool = True) -> tuple:
    """(o, lse): the forward and each row's log-sum-exp of the scaled scores
    [B,H,S] fp32, natural units (the backward's input).  On the card one
    launch of the forward kernel, o bitwise `flash_attention`'s; on the CPU
    `ref.flash_attention_lse_ref`.  No gradient."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_lse_ref(q, k, v, causal=causal)
    return _forward(q, k, v, causal, True)


def flash_attention_bwd_dq(q, k, v, o, lse, do, *, causal: bool = True) -> tuple:
    """The backward's first pass: (dq in q's dtype, delta [B,H,S] fp32 =
    rowsum(do o o), which `flash_attention_bwd_dkdv` reads).  CUDA only:
    the CPU's gradient is `ref.flash_attention_bwd_ref`."""
    _check_bwd(q, k, v, o, lse, do)
    if q.device.type != "cuda":
        raise ValueError("flash_attention_bwd_dq launches the CUDA kernel; "
                         "on the CPU use flash_attention_bwd")
    B, H, S, D = q.shape
    T = k.shape[2]
    dq = torch.empty_like(q)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if B * H * S == 0:
        return dq, delta
    with _on(q.device) as stream:
        err = _bwd_library().flash_attention_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
            B * H, S, T, D, int(q.dtype == torch.bfloat16), int(causal),
            float(D ** -0.5), stream)
    _raise_on_bwd(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq, delta


def flash_attention_bwd_dkdv(q, k, v, lse, delta, do, *,
                             causal: bool = True) -> tuple:
    """The backward's second pass: (dk, dv) in k's dtype from the first
    pass's delta.  CUDA only."""
    _check_bwd(q, k, v, q, lse, do)
    if q.device.type != "cuda":
        raise ValueError("flash_attention_bwd_dkdv launches the CUDA kernel; "
                         "on the CPU use flash_attention_bwd")
    if delta.shape != lse.shape or delta.dtype != torch.float32 \
            or not _aligned(delta):
        raise ValueError(f"flash_attention_bwd_dkdv wants delta like lse "
                         f"{tuple(lse.shape)} float32, contiguous")
    B, H, S, D = q.shape
    T = k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if B * H * T == 0:
        return dk, dv
    with _on(q.device) as stream:
        err = _bwd_library().flash_attention_bwd_dkdv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B * H, S, T, D, int(q.dtype == torch.bfloat16), int(causal),
            float(D ** -0.5), stream)
    _raise_on_bwd(err, "flash_attention_bwd_dkdv")
    flash_attention_bwd_dkdv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True) -> tuple:
    """(dq, dk, dv) of `flash_attention` for the output's cotangent do, from
    the forward's o and lse.  On the card the two backward kernels, in
    order; on the CPU `ref.flash_attention_bwd_ref` (o and lse unread)."""
    _check_bwd(q, k, v, o, lse, do)
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, do, causal=causal)
    dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, causal=causal)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, lse, delta, do, causal=causal)
    return dq, dk, dv


# kernel launches since the last reset (CPU calls excluded)
flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkdv.launches = 0
