"""Chunked RWKV6 WKV forward: the wrapper of the hand-written CUDA kernel in
`csrc/wkv_chunk.cu`, which replaces the Pallas TPU kernel
`wkv_chunk_pallas` / `_wkv_kernel` (`src/repro/kernels/wkv_chunk.py:67` /
`:26`).

    y_t = r_t . (state + u (x) (k_t (x) v_t)),  state <- e^{g_t} state + k_t (x) v_t

r, k, v, g [B,H,S,K] and u [H,K], fp32 or bf16 (all alike, computed in
fp32), K in {16, 32, 64}; y [B,H,S,K] in r's dtype.  g is clipped to
[-1.2, 0] (-1.2 rounded to the inputs' dtype) inside the kernel, as
`wkv_chunk_pallas` clips it before its call.  The kernel walks each (b, h) in chunks of ``chunk`` steps; the result
does not depend on the chunk beyond rounding.  Forward only, as the Pallas
kernel: it has no gradient rule.

A CPU tensor takes the plain version (`ref.wkv_chunk_ref` on the clipped
g); a CUDA tensor launches the kernel on the current stream or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

KEY_DIMS = (16, 32, 64)  # the widths the kernel is instantiated for
MAX_CHUNK = 128  # its tiles take 217,600 bytes of shared memory at K = 64
G_MIN = -1.2  # the decay clip floor shared with the reference's ssm.py
_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("wkv_chunk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv_chunk_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                     ctypes.c_float, p]
    lib.wkv_chunk_launch.restype = ctypes.c_int
    lib.wkv_chunk_error_string.argtypes = [ctypes.c_int]
    lib.wkv_chunk_error_string.restype = ctypes.c_char_p
    return lib


def _check(r, k, v, g, u, chunk: int) -> int:
    """The checks both paths make; returns the chunk the walk uses
    (``min(chunk, S)``, as the reference takes it)."""
    seq = (r, k, v, g)
    if r.dim() != 4 or any(t.shape != r.shape for t in seq):
        raise ValueError(f"wkv wants r, k, v, g [B,H,S,K] alike; got "
                         f"{[tuple(t.shape) for t in seq]}")
    B, H, S, K = r.shape
    if u.shape != (H, K):
        raise ValueError(f"wkv wants u [{H},{K}]; got {tuple(u.shape)}")
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (*seq, u)):
        raise TypeError(f"wkv wants r, k, v, g, u all float32 or all bfloat16; "
                        f"got {[t.dtype for t in (*seq, u)]}")
    if len({t.device for t in (*seq, u)}) != 1:
        raise ValueError(f"wkv wants its tensors on one device; got "
                         f"{[t.device for t in (*seq, u)]}")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"wkv runs on cpu or cuda tensors, not {r.device}")
    chunk = min(int(chunk), S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"wkv walks S={S} in whole chunks; got chunk={chunk}")
    return chunk


def _check_kernel(r, k, v, g, u, chunk: int) -> None:
    """What the CUDA kernel takes beyond `_check`: K in `KEY_DIMS`, chunk up
    to `MAX_CHUNK`, no gradient, contiguous tensors, 32-bit offsets."""
    B, H, S, K = r.shape
    if K not in KEY_DIMS:
        raise ValueError(f"wkv's kernel is built for key dims {KEY_DIMS}; "
                         f"got K={K}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"wkv's kernel holds a chunk of at most {MAX_CHUNK} "
                         f"steps in shared memory; got chunk={chunk}")
    if any(t.requires_grad for t in (r, k, v, g, u)):
        raise NotImplementedError(
            "wkv's CUDA kernel is forward only (the Pallas kernel it replaces "
            "has no gradient rule); detach the inputs")
    if not all(t.is_contiguous() for t in (r, k, v, g, u)):
        raise ValueError("wkv's kernel wants contiguous tensors")
    if B * H * S * K >= 2 ** 31:
        raise ValueError(f"wkv: shape {tuple(r.shape)} out of the kernel's range")


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
        u: torch.Tensor, *, chunk: int = 64) -> torch.Tensor:
    """The RWKV6 WKV of (r, k, v, clip(g, -1.2, 0), u) -> y [B,H,S,K] in r's
    dtype (see the module docstring)."""
    chunk = _check(r, k, v, g, u, chunk)
    if r.device.type == "cpu":
        return ref.wkv_chunk_ref(r, k, v, torch.clamp(g, G_MIN, 0.0), u)
    _check_kernel(r, k, v, g, u, chunk)
    B, H, S, K = r.shape
    y = torch.empty_like(r)
    if B * H * S == 0:
        return y
    # the floor in the inputs' dtype, as torch.clamp / jnp.clip round it
    g_min = float(torch.tensor(G_MIN, dtype=r.dtype))
    lib = _library()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        err = lib.wkv_chunk_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   g.data_ptr(), u.data_ptr(), y.data_ptr(),
                                   B * H, H, S, K, chunk,
                                   int(r.dtype == torch.bfloat16),
                                   g_min, stream)
    if err != 0:
        raise RuntimeError(f"wkv kernel launch failed: CUDA error {err} "
                           f"({lib.wkv_chunk_error_string(err).decode()})")
    wkv.launches += 1
    return y


wkv.launches = 0  # kernel launches since the last reset (CPU calls excluded)
