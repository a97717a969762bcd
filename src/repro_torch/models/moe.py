"""Mixture-of-Experts with the expert-parallel all_to_all dispatch: the port
of `repro/models/moe.py`.

Two execution paths with the same math:

* `_moe_reference`: the single-device path (the model's forward, prefill
  and decode, training included): capacity packing over all T tokens at
  once, grouped SwiGLU experts, the combine.
* `_moe_expert_parallel` (and its dedup dispatch `_dispatch_chunk_dedup`)
  and `_moe_decode_2d`: one process per rank over a (data, model) grid of
  `torch.distributed` groups (`spmm_models.process_grid((data, model))`:
  ``groups[0]`` the rank's data group, ``groups[1]`` its model group), the
  reference's ``shard_map`` bodies run by each rank on its own pieces
  (`shard_params`, `shard_batch`).  Experts are split over the model
  group; tokens are routed with capacity-based packing and moved by
  all_to_all (`collectives.all_to_all_rows`, counted): the survey's P2P
  protocol (§7.1.2) for the token->expert bipartite graph, a vertex cut of
  it.  They are forward only (serving): training runs the reference path.

The survey connection: MoE dispatch *is* distributed graph aggregation
under a vertex-cut (expert) partition; router load imbalance is challenge
#3, and the aux loss below is the standard mitigation.

Every write of a dispatch is a plain store of each kept pair into its own
slot (the dropped pairs into one spare row, sliced off), and every combine
gathers each pair's expert output and sums a token's k pairs in a fixed
order: no float atomics, so a rerun on the card gives the same bits.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.execution import collectives
from repro_torch.models.layers import ParamBuilder, mlp_apply, mlp_params

# experts cast and multiplied together: the reference casts a whole expert
# stack to the working dtype, which at kimi-k2's width and fp32 would be
# three 22.5 GB copies; 32 experts of it are at most 5.6 GB
EXPERT_GROUP = 32


def moe_params(b: ParamBuilder, cfg, name="moe"):
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    with b.scope(name):
        p = {
            "router": b.param("router", (D, E)),
            "wi": b.param("wi", (E, D, F_), fan_in=D),
            "wg": b.param("wg", (E, D, F_), fan_in=D),
            "wo": b.param("wo", (E, F_, D), fan_in=F_),
        }
        if cfg.num_shared_experts:
            p["shared"] = mlp_params(b, cfg, "shared",
                                     d_ff=cfg.d_ff * cfg.num_shared_experts)
    return p


def _router(p, x_flat, cfg):
    """x_flat [T,D] -> (weights [T,k] in x's dtype, expert ids [T,k],
    aux_loss fp32 scalar).  fp32 logits, softmax, top-k (ties to the lower
    index, as ``lax.top_k``), renormalized; aux = E sum_e (mean prob_e)
    (share of pairs_e), the counts carrying no gradient."""
    logits = x_flat.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)  # [T,E]
    vals, ids = torch.topk(probs, cfg.moe_top_k, dim=-1, sorted=True)
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    E = cfg.num_experts
    me = probs.mean(0)
    ce = torch.bincount(ids.reshape(-1), minlength=E).float() / (
        x_flat.shape[0] * cfg.moe_top_k)
    aux = E * torch.sum(me * ce)
    return vals.to(x_flat.dtype), ids, aux


def _expert_ffn(wi, wg, wo, x, dtype):
    """Grouped SwiGLU: x [E,C,D]; weights [E,D,F] / [E,F,D], cast to
    ``dtype`` and multiplied EXPERT_GROUP experts at a time."""
    outs = []
    for e0 in range(0, x.shape[0], EXPERT_GROUP):
        e = slice(e0, e0 + EXPERT_GROUP)
        h = torch.bmm(x[e], wi[e].to(dtype))
        g = torch.bmm(x[e], wg[e].to(dtype))
        outs.append(torch.bmm(F.silu(g) * h, wo[e].to(dtype)))
    return torch.cat(outs)


def _slots(ids: torch.Tensor, n: int, valid=None) -> torch.Tensor:
    """Each entry's place among the earlier entries of the same id in
    [0, n), entries where ``valid`` is False not counted (their own place
    is left unspecified): the reference's ``(cumsum(one_hot) -
    one_hot)[arange, ids]``, from a stable sort of the ids (a one-hot
    cumsum over [T*k, E] took 12.6 ms of kimi-k2's 46 ms prefill on an
    H100)."""
    if valid is not None:
        ids = torch.where(valid, ids, n)  # a bin of their own, past n
    order = torch.argsort(ids, stable=True)
    counts = torch.bincount(ids, minlength=n + 1)
    starts = torch.cumsum(counts, 0) - counts  # each id's first sorted place
    place = torch.arange(ids.shape[0], device=ids.device) - starts[ids[order]]
    return torch.empty_like(ids).index_put_((order,), place)


def _place(rows: torch.Tensor, slot: torch.Tensor, n: int,
           fill=0) -> torch.Tensor:
    """[n, ...] with rows[i] at slot[i] and ``fill`` in the slots no row
    takes: each slot below n written by one row, slot n a spare row for
    the dropped ones, sliced off."""
    out = rows.new_full((n + 1,) + rows.shape[1:], fill)
    return out.index_put_((slot,), rows)[:n]


def _sum_pairs(y_pair: torch.Tensor, k: int) -> torch.Tensor:
    """[T*k, D] in token-major order -> [T, D], each token's k rows added
    in order (the reference's scatter-add into zeros)."""
    y = y_pair.view(-1, k, y_pair.shape[-1])
    out = y[:, 0]
    for j in range(1, k):
        out = out + y[:, j]
    return out


def routing(p, x, cfg):
    """The single-device path's routing of x [B,S,D]: (weights [T*k],
    expert ids [T*k], slots [T*k], capacity, aux), pairs in token-major
    order; a pair whose slot is >= capacity is dropped."""
    xf = x.reshape(-1, x.shape[-1])
    w, ids, aux = _router(p, xf, cfg)
    flat_ids = ids.reshape(-1)
    cap = max(int(xf.shape[0] * cfg.moe_top_k / cfg.num_experts
                  * cfg.capacity_factor), 1)
    return (w.reshape(-1), flat_ids, _slots(flat_ids, cfg.num_experts), cap,
            aux)


# ---------------------------------------------------------------------------
# Reference (single-device) path
# ---------------------------------------------------------------------------


def _moe_reference(p, x, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, D = x.shape
    dtype = x.dtype
    T = B * S
    xf = x.reshape(T, D)
    E, k = cfg.num_experts, cfg.moe_top_k
    w, flat_ids, pos, cap, aux = routing(p, x, cfg)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    keep = pos < cap
    slot = torch.where(keep, flat_ids * cap + pos, E * cap)
    ex_in = _place(xf[tok], slot, E * cap).view(E, cap, D)
    ex_out = _expert_ffn(p["wi"], p["wg"], p["wo"], ex_in, dtype)
    y_pair = ex_out.reshape(E * cap, D)[torch.where(keep, slot, 0)]
    y_pair = torch.where(keep[:, None], y_pair, 0.0)
    y = _sum_pairs(y_pair * w[:, None], k)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x).reshape(T, D)
    return y.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# Expert-parallel path: each rank's share of the reference's shard_map
# ---------------------------------------------------------------------------


def _shared_psum(p_local, x_c, dtype, model_group):
    """The shared expert split over F on the model group: this rank's
    partial product, summed over the group."""
    sh = p_local["shared"]
    h = x_c @ sh["wi"].to(dtype)
    g = x_c @ sh["wg"].to(dtype)
    part = (F.silu(g) * h) @ sh["wo"].to(dtype)
    return collectives.all_reduce_flat([part], model_group)[0]


def _dispatch_chunk_dedup(p_local, x_c, cfg, model_size: int, dtype,
                          model_group):
    """Deduplicated (and optionally group-limited) dispatch: each token is
    sent ONCE per destination shard carrying its [E_local] weight vector,
    instead of once per (token, expert) pair; with group limit G < M the
    copies a token are bounded to G (DeepSeek-style node-limited routing),
    the selection carrying no gradient.  Two all_to_alls: the tokens with
    their weights, and the return."""
    Ck, D = x_c.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    M = model_size
    E_local = E // M
    G = min(cfg.moe_group_limit or M, M)
    w, ids, aux = _router(p_local, x_c, cfg)
    W = torch.zeros((Ck, E), dtype=dtype, device=x_c.device).scatter(1, ids, w)
    W = W.view(Ck, M, E_local)
    if G < M:
        # keep only the top-G shards by total routed weight; renormalize
        shard_w = W.abs().sum(-1)  # [Ck, M]
        thresh = torch.topk(shard_w.detach(), G, dim=-1).values[:, G - 1:G]
        W = W * (shard_w >= thresh)[..., None].to(W.dtype)
        W = W / torch.clamp(W.sum((1, 2), keepdim=True), min=1e-9)
    active = W.abs().sum(-1) > 0  # [Ck, M]
    cap = max(int(Ck * min(G if G < M else k, M) / M * cfg.capacity_factor), 8)
    act_i = active.long()
    cnt = torch.cumsum(act_i, 0) - act_i  # per-destination running place
    keep = (active & (cnt < cap)).reshape(-1)  # (token, destination) order
    d_grid = torch.arange(M, device=x_c.device).expand(Ck, M).reshape(-1)
    t_grid = torch.arange(Ck, device=x_c.device).repeat_interleave(M)
    slot = torch.where(keep, d_grid * cap + cnt.reshape(-1), M * cap)
    payload = torch.cat([x_c[t_grid], W.reshape(Ck * M, E_local)], -1)
    recv = collectives.all_to_all_rows(_place(payload, slot, M * cap),
                                       model_group)()
    xr, wr = recv[:, :D], recv[:, D:]
    N = M * cap
    cap_e = max(int(N * min(1.0, max(k, 1) / max(E_local, 1))
                    * cfg.capacity_factor), 8)
    # one local expert at a time (the reference's scan over the experts)
    y_slot = torch.zeros((N, D), dtype=dtype, device=x_c.device)
    for e in range(E_local):
        we = wr[:, e]
        act = we.abs() > 0
        pos = torch.cumsum(act.long(), 0) - act.long()
        kp = act & (pos < cap_e)
        ex_in = _place(torch.where(kp[:, None], xr, 0.0),
                       torch.where(kp, pos, cap_e), cap_e)
        h = (F.silu(ex_in @ p_local["wg"][e].to(dtype))
             * (ex_in @ p_local["wi"][e].to(dtype)))
        out_e = h @ p_local["wo"][e].to(dtype)  # [cap_e, D]
        gathered = torch.where(kp[:, None], out_e[torch.where(kp, pos, 0)], 0.0)
        y_slot = y_slot + gathered * we[:, None]
    y_send = collectives.all_to_all_rows(y_slot, model_group)()
    y_pair = torch.where(keep[:, None], y_send[torch.where(keep, slot, 0)], 0.0)
    y_c = _sum_pairs(y_pair, M)
    if "shared" in p_local:
        y_c = y_c + _shared_psum(p_local, x_c, dtype, model_group)
    return y_c, aux


def _dispatch_chunk(p_local, x_c, cfg, model_size: int, dtype, model_group,
                    shared=True):
    """One token chunk on this rank: x_c [Ck, D] -> (y_c [Ck, D], aux).
    Three all_to_alls: the pairs' tokens, their local expert ids, the
    return."""
    Ck, D = x_c.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    M = model_size
    E_local = E // M
    w, ids, aux = _router(p_local, x_c, cfg)
    flat_ids = ids.reshape(-1)
    tok = torch.arange(Ck, device=x_c.device).repeat_interleave(k)
    dest = flat_ids // E_local  # destination model shard
    local_eid = flat_ids % E_local
    # --- pack into per-destination capacity buffers ---
    cap = max(int(Ck * k / M * cfg.capacity_factor), 8)
    pos = _slots(dest, M)
    keep = pos < cap
    slot = torch.where(keep, dest * cap + pos, M * cap)
    send_x = _place(x_c[tok], slot, M * cap)
    send_eid = _place(local_eid[:, None], slot, M * cap, fill=-1)
    # --- all_to_all over the model group ---
    recv_x = collectives.all_to_all_rows(send_x, model_group)
    recv_eid = collectives.all_to_all_rows(send_eid, model_group)
    rx, re = recv_x(), recv_eid()[:, 0]
    # --- pack per local expert ---
    N = rx.shape[0]
    cap_e = max(int(N / E_local * cfg.capacity_factor), 8)
    valid = re >= 0
    re_safe = torch.where(valid, re, 0)
    pos2 = _slots(re_safe, E_local, valid)
    keep2 = valid & (pos2 < cap_e)
    slot2 = torch.where(keep2, re_safe * cap_e + pos2, E_local * cap_e)
    ex_in = _place(rx, slot2, E_local * cap_e).view(E_local, cap_e, D)
    ex_out = _expert_ffn(p_local["wi"], p_local["wg"], p_local["wo"], ex_in,
                         dtype).reshape(E_local * cap_e, D)
    y_rx = torch.where(keep2[:, None], ex_out[torch.where(keep2, slot2, 0)], 0.0)
    # --- return trip ---
    y_send = collectives.all_to_all_rows(y_rx, model_group)()
    y_pair = torch.where(keep[:, None], y_send[torch.where(keep, slot, 0)], 0.0)
    y_c = _sum_pairs(y_pair * w.reshape(-1)[:, None], k)
    # --- shared experts: a tensor-parallel MLP (partial F, summed) ---
    if shared and "shared" in p_local:
        y_c = y_c + _shared_psum(p_local, x_c, dtype, model_group)
    return y_c, aux


def _grid_groups(grid):
    """(data group, model group, data size, model size) of a (data, model)
    `spmm_models.ProcessGrid`."""
    if len(grid.shape) != 2:
        raise ValueError(f"the MoE layer runs on a (data, model) grid, not "
                         f"{grid.shape}")
    return grid.groups[0], grid.groups[1], grid.shape[0], grid.shape[1]


def _moe_expert_parallel(p_local, x_local, cfg, grid, batch_sharded=True):
    """This rank's [Bl,S,D] tokens (its data block, or the whole batch when
    ``batch_sharded`` is False) through its E/M experts: chunks of
    ``cfg.moe_dispatch_chunk`` tokens in order, aux the chunks' mean, then
    the data group's mean when the batch is split over it."""
    data_group, model_group, data_size, M = _grid_groups(grid)
    Bl, S, D = x_local.shape
    dtype = x_local.dtype
    T = Bl * S
    chunk = min(cfg.moe_dispatch_chunk, T)
    if T % chunk:
        raise ValueError(f"{T} tokens are not whole chunks of {chunk}")
    dispatch = _dispatch_chunk_dedup if cfg.moe_group_limit else _dispatch_chunk
    ys, auxs = [], []
    for x_c in x_local.reshape(T // chunk, chunk, D):
        y_c, aux = dispatch(p_local, x_c, cfg, M, dtype, model_group)
        ys.append(y_c)
        auxs.append(aux)
    aux = torch.stack(auxs).mean()
    if batch_sharded and data_size > 1:
        aux = collectives.all_reduce_flat([aux], data_group)[0] / data_size
    return torch.cat(ys).view(Bl, S, D), aux


def _moe_decode_2d(p_local, x_local, cfg, grid, batch_sharded=True):
    """Weights-stationary decode dispatch: expert weights 2-D sharded (E
    over the model group, F over the data group) never move; the decode
    batch is all-gathered over the data group, every rank computes its
    partial-F expert outputs for all tokens, the partials are summed over
    the data group, and each rank keeps its own batch rows."""
    data_group, model_group, data_size, M = _grid_groups(grid)
    dtype = x_local.dtype
    Bl, S, D = x_local.shape
    split = batch_sharded and data_size > 1
    xg = x_local
    if split:
        xg = collectives.all_gather_rows(
            x_local.reshape(Bl * S, D).contiguous(), data_group)().view(-1, S, D)
    xf = xg.reshape(-1, D)
    y_part, aux = _dispatch_chunk(p_local, xf, cfg, M, dtype, model_group,
                                  shared=False)
    y = (collectives.all_reduce_flat([y_part], data_group)[0]
         if data_size > 1 else y_part)  # combine the F partials
    if "shared" in p_local:
        y = y + _shared_psum(p_local, xf, dtype, model_group)
    y = y.view(xg.shape)
    if split:
        me = collectives.rank(data_group)
        y = y[me * Bl:(me + 1) * Bl]
    return y, aux


def shard_params(p, cfg, grid, decode_2d: bool = False) -> dict:
    """This rank's pieces of one MoE layer's full parameters: the router
    whole; experts [j E/M, (j+1) E/M) at model place j (and with
    ``decode_2d`` F block i at data place i); the shared expert's F block
    j."""
    _, _, data_size, M = _grid_groups(grid)
    i, j = grid.coords

    def block(t, dim, n, at):
        size = t.shape[dim] // n
        return t.narrow(dim, at * size, size).contiguous()

    out = {"router": p["router"]}
    for name, fdim in (("wi", 2), ("wg", 2), ("wo", 1)):
        t = block(p[name], 0, M, j)
        out[name] = block(t, fdim, data_size, i) if decode_2d else t
    if "shared" in p:
        sh = p["shared"]
        out["shared"] = {"wi": block(sh["wi"], 1, M, j),
                         "wg": block(sh["wg"], 1, M, j),
                         "wo": block(sh["wo"], 0, M, j)}
    return out


def shard_batch(x, grid):
    """(this rank's rows of x [B,S,D], whether the batch is split): the
    data group splits the batch when it divides B, else every rank takes
    all of it, as the reference's sharding rules do."""
    data_size = grid.shape[0]
    if x.shape[0] % data_size:
        return x, False
    bl = x.shape[0] // data_size
    return x[grid.coords[0] * bl:(grid.coords[0] + 1) * bl], data_size > 1


def moe_apply(p, x, cfg, grid=None, *, decode_2d: bool = False,
              batch_sharded: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,D] -> (y [B,S,D], aux_loss scalar).  Without a grid the
    single-device path; on a (data, model) grid of process groups ``p``
    and ``x`` are this rank's pieces (`shard_params`, `shard_batch`), and
    the path is the weights-stationary decode with ``decode_2d`` (as the
    reference's ``_moe_2d`` rule, up to 4096 tokens), else the
    expert-parallel dispatch.  The grid paths are forward only."""
    if grid is None:
        return _moe_reference(p, x, cfg)
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "the expert-parallel MoE paths are forward only (serving); "
            "training runs the single-device path")
    tokens = x.shape[0] * x.shape[1] * (grid.shape[0] if batch_sharded else 1)
    if decode_2d and tokens <= 4096:
        return _moe_decode_2d(p, x, cfg, grid, batch_sharded)
    return _moe_expert_parallel(p, x, cfg, grid, batch_sharded)
