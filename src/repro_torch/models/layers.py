"""Core neural layers of the language-model substrate: the dense half of
`repro/models/layers.py` (parameter builder, RMSNorm, RoPE in its three
styles, chunked
attention, decode attention, the GQA attention block, the SwiGLU MLP).

Functions take the reference's arguments and layouts ([B,S,H,D] activations,
parameters read by name as ``p["wq"]``), so the tests hold each to its JAX
twin.  Parameters live in `Params` modules (one per reference dict), drawn by
`ParamBuilder`: a `torch.Generator` per parameter path, seeded from the run
seed and ``zlib.crc32(path)``, with the reference's inits and scales (the
JAX scheme's distribution, not its bits), on the device the caller names.

`chunked_attention` is the routine whose TPU-target twin is the Pallas flash
kernel (`src/repro/kernels/flash_attention.py`).  On a CUDA tensor it runs
the port's flash kernel (`kernels/csrc/flash_attention.cu`) over q and the
expanded k, v taken to contiguous [B,H,S,D], and raises for what that kernel
does not compute (a window, a softcap, a query offset, a value width unlike
the query's, a head dim outside `HEAD_DIMS`); on a CPU tensor it runs a plain
copy of the reference's streaming softmax, window and softcap included.
Both paths are differentiable: on the card the gradient is the flash
backward's two kernels (the kernels work on the expanded heads; autograd
sums the grouped heads back through `repeat_kv`), on the CPU autograd
through the streaming softmax, the counterpart of JAX's autodiff of the
reference's.  `decode_attention` is plain on every device, as in the
reference (no Pallas twin).
"""
from __future__ import annotations

import contextlib
import math
import zlib
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class ParamBuilder:
    """Draws the parameters of a model, one call per parameter path.

    Each path ("blocks/attn/wq") draws from its own `torch.Generator` on
    ``device``, seeded from the run ``seed`` and ``zlib.crc32(path)``, with
    the reference's inits: ``fan_in`` (normal, std scale / sqrt(fan_in),
    fan_in the first dim unless given), ``normal`` (std scale), ``zeros``,
    ``ones``.  Inside ``stacked(n)`` every parameter gets a leading (n,)
    layer dim, drawn whole, as the reference stacks its blocks.  A leaf of
    more than WHOLE_DRAW elements (kimi-k2's expert stacks, 5.6e9 each) is
    drawn one slice at a time along its leading dims, in order, from the
    same generator: a whole fp32 draw would hold 22.5 GB beside the
    parameter's own bf16 copy."""

    WHOLE_DRAW = 1 << 31

    def __init__(self, seed: int, device, param_dtype=torch.float32):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.param_dtype = param_dtype
        self._prefix = []
        self._stack = []

    @contextlib.contextmanager
    def scope(self, name: str):
        self._prefix.append(name)
        try:
            yield
        finally:
            self._prefix.pop()

    @contextlib.contextmanager
    def stacked(self, n: int):
        self._stack.append(n)
        try:
            yield
        finally:
            self._stack.pop()

    def generator(self, path: str) -> torch.Generator:
        # 32 bits: the CPU generator (mt19937) reads no more of its seed;
        # the seed's multiplicative hash is one to one below 2**32
        return torch.Generator(device=self.device).manual_seed(
            (zlib.crc32(path.encode()) ^ (self.seed * 0x9E3779B1)) % (1 << 32))

    def param(self, name, shape, init="fan_in", fan_in=None, scale=1.0):
        full_shape = tuple(self._stack) + tuple(shape)
        path = "/".join(self._prefix + [name])
        kw = dict(dtype=self.param_dtype, device=self.device)
        if init == "zeros":
            return torch.zeros(full_shape, **kw)
        if init == "ones":
            return torch.ones(full_shape, **kw)
        if init == "fan_in":
            fi = fan_in if fan_in is not None else (shape[0] if shape else 1)
            std = scale / max(float(fi), 1.0) ** 0.5
        elif init == "normal":
            std = scale
        else:
            raise ValueError(init)
        gen = self.generator(path)
        n = math.prod(full_shape)
        if n <= self.WHOLE_DRAW:
            x = torch.randn(full_shape, generator=gen, dtype=torch.float32,
                            device=self.device)
            return x.mul_(std).to(self.param_dtype)
        lead = 0  # the leading dims walked; each slice the rest
        while n > self.WHOLE_DRAW:
            n //= full_shape[lead]
            lead += 1
        out = torch.empty(full_shape, **kw)
        for piece in out.view(-1, *full_shape[lead:]):
            piece.copy_(torch.randn(piece.shape, generator=gen,
                                    dtype=torch.float32,
                                    device=self.device).mul_(std))
        return out


class Params(nn.Module):
    """One of the reference's parameter dicts as a module: its tensors are
    registered under the reference's keys as trainable parameters (serving
    runs under `torch.inference_mode`, which records no gradient) and read
    as the reference reads them, ``p["wq"]``, ``"bq" in p``; a nested dict
    (the MoE layer's ``shared`` expert) is a `Params` child, ``p["shared"]``."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            if isinstance(t, dict):
                self.add_module(name, Params(t))
            else:
                self.register_parameter(name, nn.Parameter(t))

    def __getitem__(self, name: str):
        if name in self._modules:
            return self._modules[name]
        return self._parameters[name]

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def unbind_layers(self) -> list:
        """The stacked [L, ...] leaves as L `LayerParams`, one ``unbind`` a
        leaf (its backward stacks the layers' gradients once)."""
        per = {k: t.unbind(0) for k, t in self._parameters.items()}
        per.update({k: m.unbind_layers() for k, m in self._modules.items()})
        n = len(next(iter(per.values())))
        return [LayerParams({k: ts[i] for k, ts in per.items()})
                for i in range(n)]


class LayerParams:
    """One layer's slice of a stacked `Params` ([L, ...] leaves): read as
    `Params` is, ``p["wq"]`` the layer's view of the stacked leaf."""

    __slots__ = ("_tensors",)

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self._tensors = tensors

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._tensors[name]

    def __contains__(self, name: str) -> bool:
        return name in self._tensors


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_params(b: ParamBuilder, name: str, dim: int):
    with b.scope(name):
        return {"scale": b.param("scale", (dim,), init="ones")}


def rmsnorm(p, x, eps: float):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE: "full", "half" (chatglm's 2d RoPE) and "mrope" (qwen2-vl's M-RoPE)
# ---------------------------------------------------------------------------


def _rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., 2m] rotated pairwise by the angles of cos, sin [..., m]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


def mrope_sections(dh: int) -> tuple:
    """M-RoPE's (t, h, w) shares of the dh/2 frequencies: (16, 24, 24) at
    dh 128, as the reference splits them."""
    half = dh // 2
    s_hw = 3 * half // 8
    return (half - 2 * s_hw, s_hw, s_hw)


def _rope_angles(positions, dh: int, theta: float, style: str):
    """The angles [B,S,1,m] of the dims ``style`` rotates: "full" m = dh/2
    over all dh dims and "half" m = dh/4 over the first dh/2 (the
    frequencies of dh/2), for positions [B,S]; "mrope" m = dh/2 for
    positions [3,B,S], the (t, h, w) sections of the frequencies taking
    the three position rows in turn."""
    dev = positions.device
    if style == "full":
        return positions[..., None, None].float() * _rope_freqs(dh, theta, dev)
    if style == "half":
        return positions[..., None, None].float() * _rope_freqs(dh // 2, theta,
                                                                dev)
    if style == "mrope":
        if positions.dim() != 3:
            raise ValueError("rope_style 'mrope' needs [3,B,S] position "
                             f"triplets; got positions {tuple(positions.shape)}")
        freqs = _rope_freqs(dh, theta, dev)
        parts, off = [], 0
        for row, sec in zip(positions, mrope_sections(dh)):
            parts.append(row[..., None, None].float() * freqs[off:off + sec])
            off += sec
        return torch.cat(parts, -1)
    raise ValueError(f"rope_style must be 'full', 'half' or 'mrope'; got "
                     f"{style!r}")


def _rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 style: str) -> torch.Tensor:
    """x rotated by a style's angles: "half" rotates the first half of the
    head dims and keeps the rest."""
    if style == "half":
        rot, keep = x.chunk(2, dim=-1)
        return torch.cat([_rotate(rot, cos, sin), keep], -1)
    return _rotate(x, cos, sin)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               style: str = "full") -> torch.Tensor:
    """x [B,S,H,Dh]; positions [B,S] ([3,B,S] for mrope)."""
    ang = _rope_angles(positions, x.shape[-1], theta, style)
    return _rope_rotate(x, torch.cos(ang), torch.sin(ang), style)


# ---------------------------------------------------------------------------
# Chunked (flash-style) attention
# ---------------------------------------------------------------------------


def _attn_mask(q_idx, k_idx, causal: bool, window: int):
    m = torch.ones((q_idx.shape[0], k_idx.shape[0]), dtype=torch.bool,
                   device=q_idx.device)
    if causal:
        m &= k_idx[None, :] <= q_idx[:, None]
    if window > 0:
        m &= q_idx[:, None] - k_idx[None, :] < window
    return m


def _streaming_attention(q, k, v, causal, window, softcap, q_chunk, kv_chunk,
                         q_offset):
    """The reference's streaming softmax, plain: for each chunk of queries a
    running max, sum and accumulator over chunks of keys, scores and P.V
    summed in fp32 (p rounded to v's dtype first)."""
    B, S, H, Dh = q.shape
    Dv = v.shape[-1]
    T = k.shape[1]
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, T)
    if S % q_chunk or T % kv_chunk:
        raise ValueError(f"chunked_attention walks S={S} and T={T} in whole "
                         f"chunks; got q_chunk={q_chunk}, kv_chunk={kv_chunk}")
    scale = Dh ** -0.5
    f32 = torch.float32
    outs = []
    for q0 in range(0, S, q_chunk):
        q_blk = q[:, q0:q0 + q_chunk].float()
        q_idx = q_offset + q0 + torch.arange(q_chunk, device=q.device)
        m = torch.full((B, H, q_chunk), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((B, H, q_chunk), dtype=f32, device=q.device)
        acc = torch.zeros((B, H, q_chunk, Dv), dtype=f32, device=q.device)
        for k0 in range(0, T, kv_chunk):
            k_blk = k[:, k0:k0 + kv_chunk].float()
            v_blk = v[:, k0:k0 + kv_chunk]
            k_idx = k0 + torch.arange(kv_chunk, device=q.device)
            s = torch.einsum("bqhd,bkhd->bhqk", q_blk, k_blk) * scale
            if softcap > 0:
                s = softcap * torch.tanh(s / softcap)
            mask = _attn_mask(q_idx, k_idx, causal, window)
            s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v_blk.dtype).float(),
                              v_blk.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 2, 1, 3).to(q.dtype))
    return torch.cat(outs, 1)


def _flash(q, k, v, causal, window, softcap, q_offset):
    """The flash kernel over [B,S,H,D] q and expanded k, v; raises for what
    the kernel does not compute (never runs the plain version instead)."""
    refused = {"a sliding window (window > 0)": window > 0,
               "a logit softcap (softcap > 0)": softcap > 0,
               "a query offset (q_offset != 0)": q_offset != 0,
               "a value width unlike the query's": v.shape[-1] != q.shape[-1],
               f"a head dim outside {HEAD_DIMS}": q.shape[-1] not in HEAD_DIMS}
    for what, hit in refused.items():
        if hit:
            raise NotImplementedError(
                f"chunked_attention on {q.device}: the flash kernel does not "
                f"compute {what} (ROADMAP.md queue 2)")
    qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
    return flash_attention(qh, kh, vh, causal=causal).permute(0, 2, 1, 3)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      softcap: float = 0.0, q_chunk: int = 512,
                      kv_chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """q [B,S,H,D]; k, v [B,T,H,D] (heads already expanded) -> [B,S,H,Dv]
    in q's dtype.  CPU: the reference's streaming softmax; CUDA: the flash
    kernel, which walks its own tiles (the chunks do not reach it), and
    under autograd its backward kernels."""
    if q.device.type == "cpu":
        return _streaming_attention(q, k, v, causal, window, softcap, q_chunk,
                                    kv_chunk, q_offset)
    return _flash(q, k, v, causal, window, softcap, q_offset)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B,T,KV,D] -> [B,T,KV*n_rep,D] (contiguous groups)."""
    if n_rep == 1:
        return x
    B, T, KV, Dh = x.shape
    return x[:, :, :, None, :].expand(B, T, KV, n_rep, Dh).reshape(
        B, T, KV * n_rep, Dh)


# ---------------------------------------------------------------------------
# Decode attention
# ---------------------------------------------------------------------------


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     softcap: float = 0.0):
    """q [B,1,H,D]; caches [B,T,H,D] (heads expanded); cache_len an int or
    a per-batch [B] tensor (continuous batching).  Plain on every device."""
    B, _, H, Dh = q.shape
    T = k_cache.shape[1]
    scale = Dh ** -0.5
    s = torch.einsum("bqhd,bthd->bhqt", q.float(), k_cache.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    t_idx = torch.arange(T, device=q.device)
    # an int stays a Python number: a host-to-device copy of it would wait
    # for the card's queue each layer
    cl = cache_len if isinstance(cache_len, int) else cache_len.reshape(-1, 1)
    valid = t_idx[None, :] < cl
    if window > 0:
        valid = valid & (t_idx[None, :] > cl - 1 - window)
    s = torch.where(valid.expand(B, T)[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqt,bthd->bqhd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------


def attention_params(b: ParamBuilder, cfg):
    D, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    with b.scope("attn"):
        p = {
            "wq": b.param("wq", (D, H, Dh)),
            "wk": b.param("wk", (D, KV, Dh)),
            "wv": b.param("wv", (D, KV, Dh)),
            "wo": b.param("wo", (H, Dh, D), fan_in=H * Dh),
        }
        if cfg.qkv_bias:
            p["bq"] = b.param("bq", (H, Dh), init="zeros")
            p["bk"] = b.param("bk", (KV, Dh), init="zeros")
            p["bv"] = b.param("bv", (KV, Dh), init="zeros")
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) in x's dtype."""
    D, heads, dh = w.shape
    return (x @ w.to(x.dtype).reshape(D, heads * dh)).unflatten(-1, (heads, dh))


def attention_qkv(p, x, cfg, *, positions=None, rope: bool = True):
    """Returns q [B,S,H,D], k, v [B,T,KV,D] with RoPE applied to q, k."""
    q, k, v = (_project(x, p[w]) for w in ("wq", "wk", "wv"))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if rope and positions is not None:  # one set of angles for q and k
        ang = _rope_angles(positions, q.shape[-1], cfg.rope_theta,
                           cfg.rope_style)
        cos, sin = torch.cos(ang), torch.sin(ang)
        q = _rope_rotate(q, cos, sin, cfg.rope_style)
        k = _rope_rotate(k, cos, sin, cfg.rope_style)
    return q, k, v


def attention_out(p, y, dtype):
    """einsum("bshk,hkd->bsd", y, wo) in ``dtype``."""
    H, Dh, D = p["wo"].shape
    return y.reshape(*y.shape[:2], H * Dh) @ p["wo"].to(dtype).reshape(H * Dh, D)


def attention_apply(p, x, positions, cfg, *, window=0):
    """Full-sequence causal self-attention (prefill)."""
    q, k, v = attention_qkv(p, x, cfg, positions=positions)
    n_rep = cfg.num_heads // cfg.num_kv_heads
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    y = chunked_attention(q, k, v, causal=True, window=window,
                          softcap=cfg.attn_logit_softcap)
    return attention_out(p, y, x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_params(b: ParamBuilder, cfg, name="mlp", d_ff=None):
    D, F_ = cfg.d_model, d_ff or cfg.d_ff
    with b.scope(name):
        return {
            "wi": b.param("wi", (D, F_)),
            "wg": b.param("wg", (D, F_)),
            "wo": b.param("wo", (F_, D)),
        }


def mlp_apply(p, x):
    dtype = x.dtype
    h = x @ p["wi"].to(dtype)
    g = x @ p["wg"].to(dtype)
    return (F.silu(g) * h) @ p["wo"].to(dtype)
