"""Chunked RWKV6 WKV forward: the wrapper of the hand-written CUDA kernel in
`csrc/wkv_chunk.cu`, which replaces the Pallas TPU kernel
`wkv_chunk_pallas` / `_wkv_kernel` (`src/repro/kernels/wkv_chunk.py:67` /
`:26`).

    y_t = r_t . (state + u (x) (k_t (x) v_t)),  state <- e^{g_t} state + k_t (x) v_t

r, k, v, g [B,H,S,K] and u [H,K], fp32 or bf16 (all alike, computed in
fp32), K in {16, 32, 64}; y [B,H,S,K] in r's dtype, rounded once.  g is
clipped to [-1.2, 0] (-1.2 rounded to the inputs' dtype) inside the kernel,
as `wkv_chunk_pallas` clips it before its call.  Forward only, as the Pallas
kernel: it has no gradient rule.

``chunk`` is checked as the reference asserts it (S a multiple of
``min(chunk, S)``), and any chunk that passes is taken, but it no longer
changes the kernel's arithmetic: the kernel walks S in tiles of its own 32
steps (a ragged last tile masked), where the factored intra-tile weights
r 2^{Lp} . (k 2^{-L})^T keep every exponent at or under 55.4 bits at the
clip floor, against fp32's 127.  A CTA takes one (b, h) and 32 value
columns (320 CTAs at rwkv6-3b's B 4, H 40, K 64), three an SM, 71,176
bytes of shared memory each at K = 64 in fp32; the tile's r, k, g, v come
as four TMA bulk copies, the next tile's in flight while this one is
computed, and the four products a tile run on the tensor cores as
mma.sync in 3xTF32 (each fp32 operand split into two tf32 parts, three
products summed in fp32: no one-pass TF32).  The kernel is bound by bytes
on the H100: r, k, v, g read and y written once, 0.250 ms at B 4, H 40,
S 4096, K 64 in fp32.  Sums run in a fixed order, so two launches are
bitwise equal, and the output is the same at every chunk.

`wkv_with_state` also returns the final [B,H,K,K] state in fp32, written
by the same launch (a null state pointer writes nothing, and y does not
depend on it).

A CPU tensor takes the plain version (`ref.wkv_chunk_ref` on the clipped
g); a CUDA tensor launches the kernel on the current stream or raises.
`wkv.launches` counts one a call of either wrapper that launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

KEY_DIMS = (16, 32, 64)  # the widths the kernel is instantiated for
G_MIN = -1.2  # the decay clip floor shared with the reference's ssm.py
_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("wkv_chunk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv_chunk_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                     ctypes.c_float, p]
    lib.wkv_chunk_launch.restype = ctypes.c_int
    lib.wkv_chunk_error_string.argtypes = [ctypes.c_int]
    lib.wkv_chunk_error_string.restype = ctypes.c_char_p
    for name in ("wkv_chunk_ctas_per_sm", "wkv_chunk_smem_bytes"):
        getattr(lib, name).argtypes = [i, i]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def kernel_resources(K: int, dtype: torch.dtype) -> dict:
    """The kernel's CTAs an SM (the occupancy calculator's answer on the
    current card) and shared-memory bytes a CTA, for key width K."""
    lib, bf16 = _library(), int(dtype == torch.bfloat16)
    return dict(ctas_per_sm=lib.wkv_chunk_ctas_per_sm(K, bf16),
                smem_bytes=lib.wkv_chunk_smem_bytes(K, bf16))


def _check(r, k, v, g, u, chunk: int) -> None:
    """The checks both paths make; ``chunk`` as the reference asserts it
    (S a multiple of ``min(chunk, S)``)."""
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


def _check_kernel(r, k, v, g, u) -> None:
    """What the CUDA kernel takes beyond `_check`: K in `KEY_DIMS`, no
    gradient, contiguous tensors, r, k, v, g on 16-byte boundaries (its
    bulk copies), a grid in range.  Any chunk `_check` passes is taken."""
    B, H, S, K = r.shape
    if K not in KEY_DIMS:
        raise ValueError(f"wkv's kernel is built for key dims {KEY_DIMS}; "
                         f"got K={K}")
    if any(t.requires_grad for t in (r, k, v, g, u)):
        raise NotImplementedError(
            "wkv's CUDA kernel is forward only (the Pallas kernel it replaces "
            "has no gradient rule); detach the inputs")
    if not all(t.is_contiguous() for t in (r, k, v, g, u)):
        raise ValueError("wkv's kernel wants contiguous tensors")
    if any(t.data_ptr() % 16 for t in (r, k, v, g)):
        raise ValueError("wkv's kernel wants r, k, v, g on 16-byte boundaries")
    if B * H * S * K >= 2 ** 31:
        raise ValueError(f"wkv: shape {tuple(r.shape)} out of the kernel's range")


def _launch(r, k, v, g, u, state) -> torch.Tensor:
    """One launch of the kernel on the current stream; ``state`` (a
    [B,H,K,K] fp32 tensor on r's device, or None) receives the final
    state.  Counts the launch on `wkv.launches`."""
    _check_kernel(r, k, v, g, u)
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
                                   None if state is None else state.data_ptr(),
                                   B * H, H, S, K,
                                   int(r.dtype == torch.bfloat16),
                                   g_min, stream)
    if err != 0:
        raise RuntimeError(f"wkv kernel launch failed: CUDA error {err} "
                           f"({lib.wkv_chunk_error_string(err).decode()})")
    wkv.launches += 1
    return y


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
        u: torch.Tensor, *, chunk: int = 64) -> torch.Tensor:
    """The RWKV6 WKV of (r, k, v, clip(g, -1.2, 0), u) -> y [B,H,S,K] in r's
    dtype (see the module docstring)."""
    _check(r, k, v, g, u, chunk)
    if r.device.type == "cpu":
        return ref.wkv_chunk_ref(r, k, v, torch.clamp(g, G_MIN, 0.0), u)
    return _launch(r, k, v, g, u, None)


def wkv_with_state(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   g: torch.Tensor, u: torch.Tensor, *,
                   chunk: int = 64) -> tuple:
    """`wkv` and the state after the last step, (y [B,H,S,K] in r's dtype,
    state [B,H,K,K] fp32, key rows by value columns): what a prefill hands
    to decode.  On the card one launch of the same kernel, which writes the
    state from the registers that carried it (y bitwise `wkv`'s); on the
    CPU `ref.wkv_chunk_ref(..., return_state=True)`."""
    _check(r, k, v, g, u, chunk)
    if r.device.type == "cpu":
        return ref.wkv_chunk_ref(r, k, v, torch.clamp(g, G_MIN, 0.0), u,
                                 return_state=True)
    B, H, S, K = r.shape
    # every CTA writes its whole slice (`_check` refuses S = 0)
    state = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    return _launch(r, k, v, g, u, state), state


wkv.launches = 0  # kernel launches since the last reset (CPU calls excluded)
