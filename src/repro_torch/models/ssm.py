"""SSM layers: the RWKV6 ("Finch", data-dependent per-channel decay) half of
`repro/models/ssm.py`, with the chunked linear attention in both modes.

`_chunked_linear_attention` on a CPU tensor is a plain copy of the
reference's chunked scan (mode ``rwkv`` or ``mamba``, an optional initial
state).  On a CUDA tensor, mode ``rwkv`` runs the port's WKV kernel
(`kernels/csrc/wkv_chunk.cu`) on [B,H,S,K] fp32 inputs (the reference
computes in fp32) and casts y back to q's dtype; with ``return_state`` the
same launch writes the final state.  Both are differentiable: on the card
the gradient is the WKV backward kernel (`wkv_bwd`), on the CPU autograd
through the chunked scan.  The kernel starts from a zero state, so
an ``init_state`` on a CUDA tensor raises, as does mode ``mamba`` (no
kernel; mamba2 is not ported).  Decode goes through `rwkv6_time_mix_step`,
the single-step recurrence in plain torch (`linear_attention_step`), which
the reference has no Pallas twin for either; decode never trains.

Log-decays are clipped to [LOG_DECAY_MIN, 0] per step, as the reference and
the kernel clip them, by `ref.clip_half_ties`: its gradient is jnp.clip's,
half the cotangent where a decay sits exactly on a bound.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import clip_half_ties
from repro_torch.kernels.wkv_chunk import wkv, wkv_with_state
from repro_torch.models.layers import ParamBuilder, rmsnorm

LOG_DECAY_MIN = -1.2


def _scan_plain(q, k, v, log_decay, chunk, mode, bonus, init_state,
                return_state):
    """The reference's chunked scan: within a chunk the masked factored
    matmul, across chunks a [B,H,K,V] state, all in fp32."""
    B, S, H, K = q.shape
    V = v.shape[-1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    f32 = torch.float32
    out_dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    g = clip_half_ties(log_decay.float(), LOG_DECAY_MIN, 0.0).expand(B, S, H, K)
    if pad:
        # zero k/v and unit decay on the tail: earlier outputs unaffected,
        # final state unchanged by padded steps
        q, k, v, g = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v, g))
    n = (S + pad) // chunk
    split = [x.reshape(B, n, chunk, H, -1) for x in (q, k, v, g)]
    state = (torch.zeros((B, H, K, V), dtype=f32, device=q.device)
             if init_state is None else init_state.float())
    ones = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device)
    mask = torch.tril(ones) if mode == "mamba" else torch.tril(ones, -1)
    ys = []
    for c in range(n):
        qc, kc, vc, gc = (x[:, c] for x in split)  # [B,chunk,H,*]
        L = torch.cumsum(gc, 1)  # inclusive cumulative log decay
        L_end = L[:, -1]  # [B,H,K]
        if mode == "mamba":
            q_eff = qc * torch.exp(L)
        else:  # rwkv: past decay over (s, t-1]
            q_eff = qc * torch.exp(L - gc)
        k_eff = kc * torch.exp(-L)
        A = torch.einsum("bthk,bshk->bhts", q_eff, k_eff)
        A = torch.where(mask[None, None], A, 0.0)
        y = torch.einsum("bhts,bshv->bthv", A, vc)
        if mode == "rwkv" and bonus is not None:
            coef = torch.einsum("bthk,hk->bth", qc * kc, bonus.float())
            y = y + coef[..., None] * vc
        y = y + torch.einsum("bthk,bhkv->bthv", q_eff, state)
        k_dec = kc * torch.exp(L_end[:, None] - L)
        state = (torch.exp(L_end)[..., None] * state
                 + torch.einsum("bshk,bshv->bhkv", k_dec, vc))
        ys.append(y)
    y = torch.cat(ys, 1)[:, :S].to(out_dtype)
    return (y, state) if return_state else y


def _scan_kernel(q, k, v, log_decay, chunk, mode, bonus, init_state,
                 return_state):
    """Mode ``rwkv`` through the WKV kernel (under autograd, its backward
    kernel too); raises for what it does not compute."""
    B, S, H, K = q.shape
    refused = {"mode 'mamba' (mamba2 is not ported)": mode != "rwkv",
               "an initial state (the kernel starts from zero; decode goes "
               "through linear_attention_step)": init_state is not None,
               "a value width unlike the key's": v.shape[-1] != K}
    for what, hit in refused.items():
        if hit:
            raise NotImplementedError(
                f"_chunked_linear_attention on {q.device}: the WKV kernel "
                f"does not take {what}")
    f32 = torch.float32
    r_, k_, v_ = (x.to(f32).permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
    g_ = log_decay.to(f32).expand(B, S, H, K).permute(0, 2, 1, 3).contiguous()
    u = (bonus.to(f32).contiguous() if bonus is not None
         else torch.zeros((H, K), dtype=f32, device=q.device))
    # the kernel walks its own 32-step tiles whatever the chunk, and the
    # reference pads a ragged S with steps that add nothing: one chunk of S
    # asks the kernel for the same y and state as ``chunk`` does
    if return_state:
        y, state = wkv_with_state(r_, k_, v_, g_, u, chunk=S)
    else:
        y, state = wkv(r_, k_, v_, g_, u, chunk=S), None
    y = y.permute(0, 2, 1, 3).to(q.dtype)
    return (y, state) if return_state else y


def _chunked_linear_attention(q, k, v, log_decay, *, chunk: int, mode: str,
                              bonus: Optional[torch.Tensor] = None,
                              init_state: Optional[torch.Tensor] = None,
                              return_state: bool = False):
    """y_t = sum_s decay(s,t) (q_t . k_s) v_s, chunked.

    q, k [B,S,H,K]; v [B,S,H,V]; log_decay [B,S,H,K] (rwkv) or [B,S,H,1]
    (mamba).  mode='mamba': inclusive (s <= t), decay prod over (s,t].
    mode='rwkv': strictly past (s < t), decay prod over (s,t-1], plus the
    bonus term (q_t . (u*k_t)) v_t with u [H,K].  Returns y [B,S,H,V] in q's
    dtype (fp32 accumulate) and optionally the final state [B,H,K,V]."""
    scan = _scan_plain if q.device.type == "cpu" else _scan_kernel
    return scan(q, k, v, log_decay, chunk, mode, bonus, init_state,
                return_state)


def linear_attention_step(q, k, v, log_decay, state, *, mode: str,
                          bonus: Optional[torch.Tensor] = None):
    """Single-token recurrence for decode. q, k [B,H,K]; v [B,H,V];
    log_decay [B,H,K] or [B,H,1]; state [B,H,K,V].  Returns (y [B,H,V],
    state), fp32; plain on every device."""
    q, k, v = q.float(), k.float(), v.float()
    g = clip_half_ties(log_decay.float(), LOG_DECAY_MIN, 0.0).expand(k.shape)
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    if mode == "mamba":
        state = torch.exp(g)[..., None] * state + kv
        y = torch.einsum("bhk,bhkv->bhv", q, state)
    else:
        eff = state + (bonus.float()[None, ..., None] * kv
                       if bonus is not None else kv)
        y = torch.einsum("bhk,bhkv->bhv", q, eff)
        state = torch.exp(g)[..., None] * state + kv
    return y, state


# ---------------------------------------------------------------------------
# RWKV6 block (time-mix + channel-mix)
# ---------------------------------------------------------------------------


def rwkv6_params(b: ParamBuilder, cfg):
    D = cfg.d_model
    H, K = cfg.ssm_heads, cfg.ssm_state
    inner = H * K
    lora = max(32, D // 16)
    with b.scope("rwkv"):
        return {
            "w_r": b.param("w_r", (D, inner)),
            "w_k": b.param("w_k", (D, inner)),
            "w_v": b.param("w_v", (D, inner)),
            "w_g": b.param("w_g", (D, inner)),
            "w_o": b.param("w_o", (inner, D)),
            # data-dependent decay (low-rank, "Finch")
            "wd1": b.param("wd1", (D, lora)),
            "wd2": b.param("wd2", (lora, inner), init="zeros"),
            "w0": b.param("w0", (inner,), init="zeros"),
            "u": b.param("u", (H, K), init="zeros"),
            # token-shift mix coefficients
            "mu": b.param("mu", (5, D), init="zeros"),
            "ln_x": b.param("ln_x", (inner,), init="ones"),
        }


def _token_shift(x, prev: Optional[torch.Tensor] = None):
    """shift(x)[t] = x[t-1]; position 0 gets `prev` (decode state) or 0."""
    first = (torch.zeros_like(x[:, :1]) if prev is None
             else prev.to(x.dtype)[:, None])
    if x.shape[1] == 1:  # a decode step: the shift is the state alone
        return first
    return torch.cat([first, x[:, :-1]], 1)


def _time_mix_inputs(p, x, cfg, prev_x):
    """r, k, v [B,S,H,K] and the gate in x's dtype, the log decay
    [B,S,H,K] in fp32: -exp(w0 + tanh(x wd1) wd2)."""
    B, S, D = x.shape
    H, K = cfg.ssm_heads, cfg.ssm_state
    dtype = x.dtype
    delta = _token_shift(x, prev_x) - x
    mix = torch.sigmoid(p["mu"].to(dtype))
    xr, xk, xv, xg, xw = [x + delta * mix[i] for i in range(5)]
    r = (xr @ p["w_r"].to(dtype)).reshape(B, S, H, K)
    k = (xk @ p["w_k"].to(dtype)).reshape(B, S, H, K)
    v = (xv @ p["w_v"].to(dtype)).reshape(B, S, H, K)
    gate = F.silu(xg @ p["w_g"].to(dtype))
    wlog = p["w0"].float() + (torch.tanh(xw.float() @ p["wd1"].float())
                              @ p["wd2"].float())
    return r, k, v, gate, (-torch.exp(wlog)).reshape(B, S, H, K)


def _time_mix_out(p, y, gate, dtype):
    """ln_x, the gate and the output projection over y [B,S,H,K]."""
    y = y.reshape(*y.shape[:2], -1)
    y = rmsnorm({"scale": p["ln_x"]}, y, 1e-5) * gate.to(y.dtype)
    return y.to(dtype) @ p["w_o"].to(dtype)


def rwkv6_time_mix(p, x, cfg, *, return_state=False):
    """x [B,S,D] from a zero state (a prefill). Returns y [B,S,D] (and
    (last_x, state) if return_state)."""
    r, k, v, gate, log_decay = _time_mix_inputs(p, x, cfg, None)
    y = _chunked_linear_attention(r, k, v, log_decay, chunk=cfg.ssm_chunk,
                                  mode="rwkv", bonus=p["u"],
                                  return_state=return_state)
    if return_state:
        y, state_f = y
        return _time_mix_out(p, y, gate, x.dtype), (x[:, -1], state_f)
    return _time_mix_out(p, y, gate, x.dtype)


def rwkv6_time_mix_step(p, x, cfg, prev_x, state):
    """Single-token decode. x [B,D]; prev_x [B,D]; state [B,H,K,K].  The
    recurrence of one step in plain torch (`linear_attention_step`), y cast
    to x's dtype as the reference's chunked path casts it."""
    r, k, v, gate, log_decay = _time_mix_inputs(p, x[:, None], cfg, prev_x)
    y, state_f = linear_attention_step(r[:, 0], k[:, 0], v[:, 0],
                                       log_decay[:, 0], state, mode="rwkv",
                                       bonus=p["u"])
    out = _time_mix_out(p, y.to(r.dtype)[:, None], gate, x.dtype)
    return out[:, 0], (x, state_f)


def rwkv6_channel_mix_params(b: ParamBuilder, cfg):
    D, F_ = cfg.d_model, cfg.d_ff
    with b.scope("cmix"):
        return {
            "w_k": b.param("w_k", (D, F_)),
            "w_v": b.param("w_v", (F_, D)),
            "mu": b.param("mu", (D,), init="zeros"),
        }


def rwkv6_channel_mix(p, x, *, prev_x=None, return_state=False):
    dtype = x.dtype
    xs = _token_shift(x, prev_x)
    xk = x + (xs - x) * torch.sigmoid(p["mu"].to(dtype))
    h = torch.square(torch.relu(xk @ p["w_k"].to(dtype)))
    out = h @ p["w_v"].to(dtype)
    if return_state:
        return out, x[:, -1]
    return out
