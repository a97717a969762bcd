"""Chunked RWKV6 WKV forward and backward: the wrappers of the hand-written
CUDA kernels in `csrc/wkv_chunk.cu`.  The forward replaces the Pallas TPU kernel
`wkv_chunk_pallas` / `_wkv_kernel` (`src/repro/kernels/wkv_chunk.py:67` /
`:26`).

    y_t = r_t . (state + u (x) (k_t (x) v_t)),  state <- e^{g_t} state + k_t (x) v_t

r, k, v, g [B,H,S,K] and u [H,K], fp32 or bf16 (all alike, computed in
fp32), K in {16, 32, 64}; y [B,H,S,K] in r's dtype, rounded once.  g is
clipped to [-1.2, 0] (-1.2 rounded to the inputs' dtype) inside the kernel,
as `wkv_chunk_pallas` clips it before its call.

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

Both wrappers are differentiable.  On a CUDA tensor that needs a gradient
they run `_WKV`, whose backward calls `wkv_bwd`: dr, dk, dv, dg (0 where g
was clipped, halved where g is -1.2 or 0 exactly, as jnp.clip's gradient
halves a tie) and du in fp32, replacing JAX's autodiff of the reference's
`_chunked_linear_attention` (`src/repro/models/ssm.py:29`; the Pallas
kernel has no gradient rule), and like it differentiating the tiled form.
Two CUDA kernels on the current stream: `wkv_bwd_walk_kernel` walks the
32-step tiles forward for each tile's starting state and, in the other
half of its grid, backwards for each tile's scaled end cotangent (two
fp32 workspaces of [K, K] a (b, h) and tile, 84 MB each at rwkv6-3b's B 1,
S 4096); `wkv_bwd_grad_kernel` then takes one (b, h, tile) a CTA (5,120 at
B 1) and forms the tile's gradients from small products on the tensor
cores in 3xTF32, with a du partial a tile that the wrapper sums over b
and the tiles in a fixed order.  No float atomics: two calls are bitwise
equal.  `ref.wkv_bwd_tiled_ref` is the same algebra in plain tensor ops.
The backward takes fp32 inputs only (the model's scan hands the kernel
fp32): a bf16 input that needs a gradient on the card raises.

A CPU tensor takes the plain version (`ref.wkv_chunk_ref` on g clipped by
`ref.clip_half_ties`, differentiable through autograd); a CUDA tensor launches the kernels on
the current stream or raises.  `wkv.launches` counts one a call of either
forward wrapper that launches, `wkv_bwd.launches` one a backward call
(its two kernels).
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
    lib.wkv_bwd_launch.argtypes = [p] * 14 + [i, i, i, i, ctypes.c_float, p]
    lib.wkv_bwd_launch.restype = ctypes.c_int
    lib.wkv_bwd_workspace_floats.argtypes = [i, i, i, i]
    lib.wkv_bwd_workspace_floats.restype = ctypes.c_longlong
    lib.wkv_bwd_resources.argtypes = [i, i, p]
    lib.wkv_bwd_resources.restype = ctypes.c_int
    return lib


def kernel_resources(K: int, dtype: torch.dtype) -> dict:
    """The kernel's CTAs an SM (the occupancy calculator's answer on the
    current card) and shared-memory bytes a CTA, for key width K."""
    lib, bf16 = _library(), int(dtype == torch.bfloat16)
    return dict(ctas_per_sm=lib.wkv_chunk_ctas_per_sm(K, bf16),
                smem_bytes=lib.wkv_chunk_smem_bytes(K, bf16))


def bwd_kernel_resources(K: int) -> dict:
    """Per backward kernel ("wkv_bwd_walk_kernel", "wkv_bwd_grad_kernel"):
    registers a thread, local (spilled) bytes a thread, dynamic shared
    memory a CTA and CTAs an SM (the occupancy calculator on the current
    card), for key width K."""
    out = {}
    for name, which in (("wkv_bwd_walk_kernel", 0), ("wkv_bwd_grad_kernel", 1)):
        got = (ctypes.c_int * 4)()
        err = _library().wkv_bwd_resources(K, which, got)
        if err != 0:
            raise RuntimeError(f"wkv_bwd_resources failed: CUDA error {err} "
                               f"({_library().wkv_chunk_error_string(err).decode()})")
        out[name] = dict(registers=got[0], local_bytes=got[1], smem_bytes=got[2],
                         ctas_per_sm=got[3])
    return out


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
    """What the CUDA kernel takes beyond `_check`: K in `KEY_DIMS`,
    contiguous tensors, r, k, v, g on 16-byte boundaries (its bulk copies),
    a grid in range.  Any chunk `_check` passes is taken."""
    B, H, S, K = r.shape
    if K not in KEY_DIMS:
        raise ValueError(f"wkv's kernel is built for key dims {KEY_DIMS}; "
                         f"got K={K}")
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


class _WKV(torch.autograd.Function):
    """The forward kernel under autograd (``with_state``: the final state
    as a second output), its backward `wkv_bwd`."""

    @staticmethod
    def forward(ctx, r, k, v, g, u, with_state):
        if r.dtype != torch.float32:
            raise NotImplementedError(
                "wkv's backward kernel takes float32 inputs (the model's scan "
                f"hands it float32); got {r.dtype} inputs that need a gradient")
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, g, u)
        if not with_state:
            return _launch(r, k, v, g, u, None)
        B, H, _, K = r.shape
        state = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
        return _launch(r, k, v, g, u, state), state

    @staticmethod
    def backward(ctx, dy, dstate=None):
        r, k, v, g, u = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        grads = wkv_bwd(r, k, v, g, u, dy.contiguous(),
                        None if dstate is None else dstate.contiguous())
        return (*grads, None)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
        u: torch.Tensor, *, chunk: int = 64) -> torch.Tensor:
    """The RWKV6 WKV of (r, k, v, clip(g, -1.2, 0), u) -> y [B,H,S,K] in r's
    dtype (see the module docstring); differentiable on both paths."""
    _check(r, k, v, g, u, chunk)
    if r.device.type == "cpu":
        return ref.wkv_chunk_ref(r, k, v, ref.clip_half_ties(g, G_MIN, 0.0), u)
    if _needs_grad(r, k, v, g, u):
        _check_kernel(r, k, v, g, u)
        return _WKV.apply(r, k, v, g, u, False)
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
        return ref.wkv_chunk_ref(r, k, v, ref.clip_half_ties(g, G_MIN, 0.0), u,
                                 return_state=True)
    if _needs_grad(r, k, v, g, u):
        _check_kernel(r, k, v, g, u)
        return _WKV.apply(r, k, v, g, u, True)
    B, H, S, K = r.shape
    # every CTA writes its whole slice (`_check` refuses S = 0)
    state = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    return _launch(r, k, v, g, u, state), state


def wkv_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
            u: torch.Tensor, dy: torch.Tensor,
            dstate: torch.Tensor = None) -> tuple:
    """The gradient of `wkv` (of `wkv_with_state` with ``dstate``, the final
    state's cotangent [B,H,K,K]) for y's cotangent dy: (dr, dk, dv, dg
    [B,H,S,K], du [H,K]), fp32; dg is 0 where g was clipped and halved
    where g is -1.2 or 0 exactly.  On the card
    the backward's two kernels (du's tile partials summed over b and the
    tiles afterwards, in order); on the CPU `ref.wkv_bwd_ref`."""
    _check(r, k, v, g, u, r.shape[2] or 1)
    for name, t, shape in (("dy", dy, r.shape),
                           ("dstate", dstate, r.shape[:2] + (r.shape[3],) * 2)):
        if t is not None and (t.shape != shape or t.dtype != torch.float32
                              or t.device != r.device):
            raise ValueError(f"wkv_bwd wants {name} {tuple(shape)} float32 on "
                             f"{r.device}; got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    if r.device.type == "cpu":
        return ref.wkv_bwd_ref(r, k, v, g, u, dy, dstate)
    _check_kernel(r, k, v, g, u)
    if r.dtype != torch.float32:
        raise NotImplementedError(f"wkv's backward kernel takes float32 "
                                  f"inputs; got {r.dtype}")
    if not (dy.is_contiguous() and dy.data_ptr() % 16 == 0) or (
            dstate is not None and not dstate.is_contiguous()):
        raise ValueError("wkv_bwd wants contiguous dy (16-byte aligned) and "
                         "dstate")
    B, H, S, K = r.shape
    dr, dk, dv, dg = (torch.empty_like(r) for _ in range(4))
    lib = _library()
    # the tiles' states, their scaled end cotangents, the du partials
    s0, gh, du_part = (torch.empty((lib.wkv_bwd_workspace_floats(B * H, S, K, w),),
                                   dtype=torch.float32, device=r.device)
                       for w in (0, 1, 2))
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        err = lib.wkv_bwd_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), u.data_ptr(),
            dy.data_ptr(), None if dstate is None else dstate.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dg.data_ptr(),
            du_part.data_ptr(), s0.data_ptr(), gh.data_ptr(), B * H, H, S,
            K, float(G_MIN), stream)
    if err != 0:
        raise RuntimeError(f"wkv_bwd kernel launch failed: CUDA error {err} "
                           f"({lib.wkv_chunk_error_string(err).decode()})")
    wkv_bwd.launches += 1
    # du over b and the tiles in a fixed order (a reduction, no atomics)
    return dr, dk, dv, dg, du_part.view(B, H, -1, K).sum((0, 2))


# kernel launches since the last reset (CPU calls excluded)
wkv.launches = 0
wkv_bwd.launches = 0
