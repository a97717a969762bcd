"""Plain PyTorch versions of the port's kernels: the CPU path of each
wrapper and the oracle the CUDA kernels are held against on the card."""
from __future__ import annotations

import torch

# elements of the [rows, K, D] gathered block materialized at once: 2**24
# fp32 values = 64 MiB.  One unchunked gather at the gcn-paper shape
# (2**20 x 38 x 256) would be 40 GB.
_GATHER_ELEMS = 1 << 24


def ell_spmm_ref(ids: torch.Tensor, mask: torch.Tensor, H: torch.Tensor,
                 *, normalize: bool = True) -> torch.Tensor:
    """ELLPACK aggregation: out[v] = sum_k mask[v,k] * H[ids[v,k]], divided
    by max(sum_k mask[v,k], 1) if ``normalize``.  ids [V,K] int (padded
    entries point anywhere in [0, N) but are masked), mask [V,K] float,
    H [N,D].  Walks the rows in chunks with the same math, so the gathered
    block stays bounded."""
    V, K = ids.shape
    D = H.shape[1]
    out = torch.empty((V, D), dtype=H.dtype, device=H.device)
    step = max(1, _GATHER_ELEMS // max(K * D, 1))
    for r0 in range(0, V, step):
        i, m = ids[r0:r0 + step].long(), mask[r0:r0 + step]
        y = (m[..., None] * H[i]).sum(1)
        if normalize:
            y = y / torch.clamp(m.sum(1, keepdim=True), min=1.0)
        out[r0:r0 + step] = y
    return out


def ell_spmm_transpose_ref(ids: torch.Tensor, mask: torch.Tensor,
                           ct: torch.Tensor, N: int, *,
                           normalize: bool = True) -> torch.Tensor:
    """The gradient of `ell_spmm_ref` with respect to H [N, D]:
    dH[ids[v,k]] += mask[v,k] * ct[v], with ct divided by
    max(sum_k mask[v,k], 1) first if ``normalize``.  Walks the rows in
    chunks with index_add_, so the contribution block stays bounded as in
    `ell_spmm_ref`.  Masked slots add exact zeros and are left out: on the
    card, every padded slot of a layout names the same pad row, and their
    atomic adds would queue on it."""
    V, K = ids.shape
    D = ct.shape[1]
    if normalize:
        ct = ct / torch.clamp(mask.sum(1, keepdim=True), min=1.0)
    dH = torch.zeros((N, D), dtype=ct.dtype, device=ct.device)
    step = max(1, _GATHER_ELEMS // max(K * D, 1))
    for r0 in range(0, V, step):
        m = mask[r0:r0 + step]
        r, k = torch.nonzero(m, as_tuple=True)
        dH.index_add_(0, ids[r0:r0 + step][r, k].long(),
                      m[r, k, None] * ct[r0 + r])
    return dH


def sddmm_ref(ids: torch.Tensor, mask: torch.Tensor, Hw: torch.Tensor,
              a_src: torch.Tensor, a_dst: torch.Tensor, *,
              slope: float = 0.2) -> torch.Tensor:
    """GAT edge logits over the ELL structure:
    e[v,k] = LeakyReLU(a_dst.Hw[v] + a_src.Hw[ids[v,k]], slope), masked
    slots -1e30.  Hw may hold more rows than ids (the pad row, halo rows):
    dst row v is table row v, the first V rows of the table."""
    s_dst = (Hw @ a_dst)[: ids.shape[0]]
    s_src = (Hw @ a_src)[ids.long()]
    e = s_dst[:, None] + s_src
    e = torch.where(e > 0, e, slope * e)
    return torch.where(mask > 0, e, torch.full_like(e, -1e30))


def ell_attend_dw_ref(ids: torch.Tensor, ct: torch.Tensor,
                      H: torch.Tensor) -> torch.Tensor:
    """The gradient of the weighted ELL sum sum_k w[v,k] * H[ids[v,k]] with
    respect to the weights: dw[v,k] = ct[v] . H[ids[v,k]], for every slot
    (a masked slot reads whatever row its id names; on the engine's layouts
    that is the zero pad row).  Walks the rows in chunks like
    `ell_spmm_ref`, so the gathered block stays bounded."""
    V, K = ids.shape
    D = H.shape[1]
    dw = torch.empty((V, K), dtype=H.dtype, device=H.device)
    step = max(1, _GATHER_ELEMS // max(K * D, 1))
    for r0 in range(0, V, step):
        i = ids[r0:r0 + step].long()
        dw[r0:r0 + step] = (ct[r0:r0 + step, None, :] * H[i]).sum(-1)
    return dw


def ell_slot_transpose_ref(ids: torch.Tensor, mask: torch.Tensor,
                           dz: torch.Tensor, N: int) -> torch.Tensor:
    """The per-slot scalar transpose of an ELL table:
    g[u] = sum of dz[v,k] over the unmasked slots (mask[v,k] != 0) with
    ids[v,k] == u, [N].  One index_add_ over the unmasked slots only; the
    masked ones would all land on the pad row."""
    r, k = torch.nonzero(mask, as_tuple=True)
    g = torch.zeros((N,), dtype=dz.dtype, device=dz.device)
    return g.index_add_(0, ids[r, k].long(), dz[r, k])


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """softmax(q.k^T / sqrt(D)) . v, q [B,H,S,D], k and v [B,H,T,D] ->
    [B,H,S,D] in q's dtype.  Scores in fp32 (bf16 inputs upcast first, so
    every product is exact); with ``causal``, key k_idx is seen by query
    q_idx only if k_idx <= q_idx (masked scores -1e30); softmax in fp32; p
    rounded to v's dtype before P.V, which accumulates in fp32."""
    S, T = q.shape[2], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s / (q.shape[-1] ** 0.5)
    if causal:
        seen = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None])
        s = torch.where(seen, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, causal: bool = True) -> tuple:
    """(`flash_attention_ref`, each row's log-sum-exp of the scaled scores
    [B,H,S] fp32, natural units, masked scores -1e30 as there)."""
    S, T = q.shape[2], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s / (q.shape[-1] ** 0.5)
    if causal:
        seen = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None])
        s = torch.where(seen, s, torch.full_like(s, -1e30))
    return (flash_attention_ref(q, k, v, causal=causal),
            torch.logsumexp(s, dim=-1))


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor, *, causal: bool = True) -> tuple:
    """(dq, dk, dv) of `flash_attention_ref` for the output's cotangent do:
    `torch.autograd.grad` through it, each in its input's dtype (the bf16
    casts round p, dP and the gradients as autograd rounds them)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = flash_attention_ref(*leaves, causal=causal)
        return torch.autograd.grad(o, leaves, do)


def wkv_chunk_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  g: torch.Tensor, u: torch.Tensor, *,
                  return_state: bool = False, dtype: torch.dtype = torch.float32):
    """RWKV6 WKV, the per-step recurrence: r, k, v, g [B,H,S,K] (g the log
    decay, <= 0), u [H,K] the bonus -> y [B,H,S,K] in r's dtype.  Per (b, h),
    from a zero [K, K] state in ``dtype`` (fp32; float64 for an oracle whose
    own rounding stays far under a kernel's tolerance):

        y_t = r_t . (state + u (x) (k_t (x) v_t))
        state <- e^{g_t} * state + k_t (x) v_t

    Products summed elementwise in ``dtype`` (no matmul, so no TF32
    either).  With ``return_state``, (y, the state after the last step
    [B,H,K,K] in ``dtype``, key rows by value columns)."""
    B, H, S, K = r.shape
    rf, kf, vf, gf = (x.reshape(B * H, S, K).to(dtype) for x in (r, k, v, g))
    uf = u.to(dtype).expand(B, H, K).reshape(B * H, K, 1)
    wf = torch.exp(gf)
    state = torch.zeros((B * H, K, K), dtype=dtype, device=r.device)
    # the steps' outputs stacked once at the end: a slice assignment a step
    # would make autograd copy all of y's gradient at every step
    ys = []
    for t in range(S):
        kv = kf[:, t, :, None] * vf[:, t, None, :]
        ys.append((rf[:, t, :, None] * (state + uf * kv)).sum(1))
        state = wf[:, t, :, None] * state + kv
    y = torch.stack(ys, 1).reshape(B, H, S, K).to(r.dtype)
    if return_state:
        return y, state.reshape(B, H, K, K)
    return y


def clip_half_ties(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """clip(x, lo, hi), lo and hi rounded to x's dtype, with `jnp.clip`'s
    gradient: 1 inside (lo, hi), 0 outside, and 1/2 where x equals lo or hi
    exactly (a max and a min, each of which splits a tie's cotangent
    evenly between its two operands; `torch.clamp` would pass it whole)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def wkv_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                g: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
                dstate: torch.Tensor = None, *,
                dtype: torch.dtype = torch.float32) -> tuple:
    """(dr, dk, dv, dg, du) of `wkv_chunk_ref` on clip(g, -1.2, 0) (with
    ``dstate``, of its final state too): `torch.autograd.grad` through the
    per-step recurrence, computed in ``dtype`` (fp32; float64 for an
    oracle: du sums B S per-step terms, and in fp32 that sum alone rounds
    by up to ~8e-4 at B 4, S 4096), returned in the inputs' dtypes.  dg is
    0 where g lies outside [-1.2, 0] and halved where g is -1.2 or 0
    exactly (`clip_half_ties`, jnp.clip's gradient)."""
    with torch.enable_grad():
        leaves = [t.detach().to(dtype).requires_grad_() for t in (r, k, v, g, u)]
        rr, kk, vv, gg, uu = leaves
        gc = clip_half_ties(gg, torch.tensor(-1.2, dtype=g.dtype).item(), 0.0)
        if dstate is None:
            y = wkv_chunk_ref(rr, kk, vv, gc, uu, dtype=dtype)
            grads = torch.autograd.grad(y, leaves, dy.to(dtype))
        else:
            y, state = wkv_chunk_ref(rr, kk, vv, gc, uu, return_state=True, dtype=dtype)
            grads = torch.autograd.grad((y, state), leaves,
                                        (dy.to(dtype), dstate.to(dtype)))
    return tuple(d.to(t.dtype) for d, t in zip(grads, (r, k, v, g, u)))


def wkv_bwd_tiled_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      g: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
                      dstate: torch.Tensor = None, *, tile: int = 32) -> tuple:
    """`wkv_bwd_ref`'s gradients by the CUDA backward's algebra, in plain
    tensor ops (fp32; the tests hold it to JAX).  S is cut into tiles of
    ``tile`` steps (a ragged last tile padded with g = 0, r = k = v = dy =
    0); per tile, L the inclusive cumulative clipped decay in log2 units,
    Lp the exclusive one, Le = L at the tile's last step, q = r 2^Lp,
    ke = k 2^-L, A = strict-lower(q ke^T) + diag(sum_i r u k):

      1. states: S0 of each tile, S0' = 2^Le (S0 + ke^T v) from zero;
      2. cotangents, from the last tile (G = dstate or 0): Gh = 2^Le G is
         the tile's scaled end cotangent, then G <- Gh + q^T dy;
      3. per tile: dA = strict-lower(dy v^T), dbon = rowsum(dy v);
         dq = dy S0^T + dA ke, X = v Gh^T, dke = dA^T q + X,
         dv = A^T dy + ke Gh; dr = dq 2^Lp + u k dbon,
         dk = dke 2^-L + u r dbon; dg_t = dLe + sum_{t' > t} w_t' + b_t
         with b = -ke dke, w = q dq + b and the end decay's
         dLe = rowsum(Gh o S0) + colsum(ke o X); 0 where g was clipped,
         halved where g is -1.2 or 0 exactly (jnp.clip's gradient).

    Returns (dr, dk, dv, dg [B,H,S,K], du [H,K]) in fp32."""
    B, H, S, K = r.shape
    BH, n = B * H, -(-S // tile)
    pad = n * tile - S
    log2e = 1.4426950408889634

    def tiles(x):
        x = x.reshape(BH, S, K).float()
        return torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(BH, n, tile, K)

    rt, kt, vt, gt, dyt = (tiles(x) for x in (r, k, v, g, dy))
    g_min = torch.tensor(-1.2, dtype=g.dtype).item()
    L = torch.cumsum(torch.clamp(gt, g_min, 0.0) * log2e, dim=2)
    Lp = torch.nn.functional.pad(L[:, :, :-1], (0, 0, 1, 0))
    Le = L[:, :, -1]  # [BH, n, K]
    q, ke = rt * torch.exp2(Lp), kt * torch.exp2(-L)
    uf = u.float().expand(B, H, K).reshape(BH, 1, 1, K)
    bonus = (rt * uf * kt).sum(-1)  # [BH, n, tile]

    state, s0 = torch.zeros((BH, K, K), dtype=torch.float32, device=r.device), []
    for c in range(n):
        s0.append(state)
        state = torch.exp2(Le[:, c, :, None]) * (state + ke[:, c].transpose(1, 2) @ vt[:, c])
    G = (torch.zeros((BH, K, K), dtype=torch.float32, device=r.device)
         if dstate is None else dstate.reshape(BH, K, K).float())
    gh = [None] * n
    for c in reversed(range(n)):
        gh[c] = torch.exp2(Le[:, c, :, None]) * G
        G = gh[c] + q[:, c].transpose(1, 2) @ dyt[:, c]
    s0, gh = torch.stack(s0, 1), torch.stack(gh, 1)  # [BH, n, K, K]

    tr = lambda x: x.transpose(-1, -2)  # noqa: E731
    strict = torch.tril(torch.ones((tile, tile), device=r.device), -1)
    dA = (dyt @ tr(vt)) * strict
    A = (q @ tr(ke)) * strict + torch.diag_embed(bonus)
    dbon = (dyt * vt).sum(-1, keepdim=True)
    dq = dyt @ tr(s0) + dA @ ke
    X = vt @ tr(gh)
    dke = tr(dA) @ q + X
    dv = tr(A) @ dyt + ke @ gh
    dr = dq * torch.exp2(Lp) + uf * kt * dbon
    dk = dke * torch.exp2(-L) + uf * rt * dbon
    b = -ke * dke
    w = q * dq + b
    dLe = (gh * s0).sum(-1) + (ke * X).sum(2)  # [BH, n, K]
    later = torch.flip(torch.cumsum(torch.flip(w, [2]), 2), [2]) - w
    inside = ((gt > g_min) & (gt < 0.0)).float()
    tie = ((gt == g_min) | (gt == 0.0)).float()
    dg = (dLe[:, :, None] + later + b) * (inside + 0.5 * tie)
    du = (rt * kt * dbon).reshape(B, H, n * tile, K).sum((0, 2))

    def back(x):
        return x.reshape(BH, n * tile, K)[:, :S].reshape(B, H, S, K)

    return back(dr), back(dk), back(dv), back(dg), du
