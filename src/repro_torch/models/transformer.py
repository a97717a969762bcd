"""The language model's serving path for the dense GQA and RWKV6 families:
parameter construction, the full-sequence forward (prefill), and the
single-token decode (serve) of `repro/models/transformer.py`.

The model is a `TransformerLM` module: ``embed``, ``lm_head`` (untied
configs), ``final_norm`` and a `ModuleList` of `Block`s, each holding the
reference's per-layer dicts as `Params` (``ln1``, ``ln2``, and ``attn`` +
``mlp`` or ``tmix`` + ``cmix``), so ``blocks.3.attn.wq`` is the reference's
``params["blocks"]["attn"]["wq"][3]``.  `init_params` draws the port's own
weights on the device it is given (the card unless the caller asks for the
CPU); `params_from_numpy` carries the reference's stacked [L, ...] leaves
over, so the tests compute with JAX's weights.

Everything runs under `torch.inference_mode()`: the kernels on this path
(flash attention in the dense prefill, WKV in the RWKV6 prefill) are forward
only.  The prefill reaches them through `layers.chunked_attention` and
`ssm._chunked_linear_attention`; decode reads the KV cache or the recurrent
state in plain torch, as the reference does.  `serve_step` and
`serve_step_vec` update the cache in place (a 32k-token cache is not copied
a token) and return it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from repro_torch.models import ssm as ssm_lib
from repro_torch.models.kvcache import check_served
from repro_torch.models.layers import (
    ParamBuilder,
    Params,
    attention_apply,
    attention_out,
    attention_params,
    attention_qkv,
    chunked_attention,
    decode_attention,
    mlp_apply,
    mlp_params,
    repeat_kv,
    rmsnorm,
    rmsnorm_params,
)


@dataclasses.dataclass(frozen=True)
class ServeOptions:
    window: int = 0  # sliding window for dense long-context variants
    seq_sharded_cache: bool = False  # long_500k: not ported (one card)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _block_params(b: ParamBuilder, cfg) -> Dict[str, Any]:
    p: Dict[str, Any] = {"ln1": rmsnorm_params(b, "ln1", cfg.d_model),
                         "ln2": rmsnorm_params(b, "ln2", cfg.d_model)}
    if cfg.ssm_kind == "rwkv6":
        p["tmix"] = ssm_lib.rwkv6_params(b, cfg)
        p["cmix"] = ssm_lib.rwkv6_channel_mix_params(b, cfg)
        return p
    p["attn"] = attention_params(b, cfg)
    p["mlp"] = mlp_params(b, cfg)
    return p


def build_params(cfg, b: ParamBuilder) -> Dict[str, Any]:
    """The reference's params tree (blocks stacked over layers)."""
    check_served(cfg)
    params: Dict[str, Any] = {}
    params["embed"] = b.param("embed", (cfg.vocab_size, cfg.d_model),
                              init="normal", scale=0.02)
    if not cfg.tie_embeddings:
        params["lm_head"] = b.param("lm_head", (cfg.d_model, cfg.vocab_size))
    params["final_norm"] = rmsnorm_params(b, "final_norm", cfg.d_model)
    with b.scope("blocks"), b.stacked(cfg.num_layers):
        params["blocks"] = _block_params(b, cfg)
    return params


class Block(nn.Module):
    """One layer: its parameter dicts as `Params` modules."""

    def __init__(self, tree: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        for name, tensors in tree.items():
            self.add_module(name, Params(tensors))


class TransformerLM(nn.Module):
    """The parameters of one model, built from the reference's tree; layer i
    of each stacked leaf is a view of it (no copy)."""

    def __init__(self, cfg, tree: Dict[str, Any]):
        super().__init__()
        self.embed = nn.Parameter(tree["embed"], requires_grad=False)
        if "lm_head" in tree:
            self.lm_head = nn.Parameter(tree["lm_head"], requires_grad=False)
        self.final_norm = Params(tree["final_norm"])
        self.blocks = nn.ModuleList(
            Block({name: {k: t[i] for k, t in sub.items()}
                   for name, sub in tree["blocks"].items()})
            for i in range(cfg.num_layers))


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the language model runs on the card by default and CUDA is not "
            "available; pass device='cpu' to run on the CPU")
    return device


def init_params(cfg, seed: int = 0, device="cuda", param_dtype=None) -> TransformerLM:
    """The port's own seeded weights, drawn on ``device`` (see
    `ParamBuilder`)."""
    pd = _DTYPES[param_dtype or cfg.param_dtype]
    return TransformerLM(cfg, build_params(
        cfg, ParamBuilder(seed, _check_device(device), pd)))


def params_from_numpy(cfg, tree: Dict[str, Any], device="cuda") -> TransformerLM:
    """The weight carry-over: the reference's params tree as numpy arrays
    (``jax.tree.map(np.asarray, params)``), stacked [L, ...] leaves, as
    float32 tensors on ``device``."""
    device = _check_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, np.float32)).to(device)

    return TransformerLM(cfg, convert(tree))


def lm_head(cfg, params: TransformerLM) -> torch.Tensor:
    """[D, V]."""
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def _logits(cfg, params, h_last: torch.Tensor) -> torch.Tensor:
    """einsum("bd,dv->bv") over the working dtype, summed in fp32."""
    head = lm_head(cfg, params).to(h_last.dtype)
    return h_last.float() @ head.float()


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------


def embed_tokens(cfg, params: TransformerLM, tokens: torch.Tensor) -> torch.Tensor:
    return params.embed[tokens.long()].to(_dtype(cfg))


def _std_block_seq(cfg, blk, h, positions, *, window, collect_kv):
    hn = rmsnorm(blk.ln1, h, cfg.norm_eps)
    kv = None
    if collect_kv:
        q, k, v = attention_qkv(blk.attn, hn, cfg, positions=positions)
        kv = (k.to(torch.bfloat16), v.to(torch.bfloat16))
        n_rep = cfg.num_heads // cfg.num_kv_heads
        y = chunked_attention(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                              causal=True, window=window,
                              softcap=cfg.attn_logit_softcap)
        h = h + attention_out(blk.attn, y, h.dtype)
    else:
        h = h + attention_apply(blk.attn, hn, positions, cfg, window=window)
    h = h + mlp_apply(blk.mlp, rmsnorm(blk.ln2, h, cfg.norm_eps))
    return h, kv


def _rwkv_block_seq(cfg, blk, h, collect_state):
    if collect_state:
        y, (tm_x, s_f) = ssm_lib.rwkv6_time_mix(
            blk.tmix, rmsnorm(blk.ln1, h, cfg.norm_eps), cfg, return_state=True)
        h = h + y
        y2, cm_x = ssm_lib.rwkv6_channel_mix(
            blk.cmix, rmsnorm(blk.ln2, h, cfg.norm_eps), return_state=True)
        h = h + y2
        return h, (tm_x.to(torch.bfloat16), cm_x.to(torch.bfloat16), s_f)
    h = h + ssm_lib.rwkv6_time_mix(blk.tmix, rmsnorm(blk.ln1, h, cfg.norm_eps),
                                   cfg)
    h = h + ssm_lib.rwkv6_channel_mix(blk.cmix, rmsnorm(blk.ln2, h, cfg.norm_eps))
    return h, None


@torch.inference_mode()
def forward(cfg, params: TransformerLM, batch, *, window: int = 0,
            collect_kv: bool = False, collect_state: bool = False):
    """Full-sequence forward.  batch keys: 'tokens' [B,S], 'positions'
    [B,S].  Returns (h_final [B,S,D], aux (0), (stacks, None)): the stacks
    are (k, v) [L,B,S,KV,hd] bf16 with ``collect_kv``, (tm_x, cm_x, s) with
    ``collect_state`` (RWKV6), else None."""
    check_served(cfg)
    h = embed_tokens(cfg, params, batch["tokens"])
    positions = batch["positions"]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    per_layer = []
    for blk in params.blocks:
        if cfg.ssm_kind == "rwkv6":
            h, st = _rwkv_block_seq(cfg, blk, h, collect_state)
        else:
            h, st = _std_block_seq(cfg, blk, h, positions, window=window,
                                   collect_kv=collect_kv)
        per_layer.append(st)
    stacks = None
    if per_layer[0] is not None:
        stacks = tuple(torch.stack(xs) for xs in zip(*per_layer))
    return rmsnorm(params.final_norm, h, cfg.norm_eps), aux, (stacks, None)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


@torch.inference_mode()
def prefill(cfg, params: TransformerLM, batch, *, window: int = 0):
    """Process the prompt; return (last-token logits [B,V] fp32, cache
    dict) with the cache as long as the prompt."""
    h, _, (stacks, _) = forward(cfg, params, batch, window=window,
                                collect_kv=not cfg.ssm_kind,
                                collect_state=bool(cfg.ssm_kind))
    logits = _logits(cfg, params, h[:, -1])
    if cfg.ssm_kind == "rwkv6":
        tm_x, cm_x, s_f = stacks
        return logits, {"tm_x": tm_x, "cm_x": cm_x, "s": s_f}
    return logits, {"k": stacks[0], "v": stacks[1]}


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------


def _ffn_decode(cfg, blk, h):
    return h + mlp_apply(blk.mlp, rmsnorm(blk.ln2, h, cfg.norm_eps))


def _decode_layer(cfg, blk, h, k_l, v_l, lanes, pos, cache_len, opts):
    """One layer for one new token a lane: q, k, v at the lanes' positions,
    k and v written into the layer's cache at (lanes, pos), attention over
    each lane's first cache_len entries, then the MLP."""
    hn = rmsnorm(blk.ln1, h, cfg.norm_eps)
    B = h.shape[0]
    positions = (torch.full((B, 1), pos, device=h.device) if isinstance(pos, int)
                 else pos.reshape(B, 1))
    q, k, v = attention_qkv(blk.attn, hn, cfg, positions=positions)
    k_l[lanes, pos] = k[:, 0].to(k_l.dtype)
    v_l[lanes, pos] = v[:, 0].to(v_l.dtype)
    n_rep = cfg.num_heads // cfg.num_kv_heads
    y = decode_attention(q, repeat_kv(k_l.to(h.dtype), n_rep),
                         repeat_kv(v_l.to(h.dtype), n_rep), cache_len,
                         window=opts.window, softcap=cfg.attn_logit_softcap)
    return _ffn_decode(cfg, blk, h + attention_out(blk.attn, y, h.dtype))


@torch.inference_mode()
def serve_step(cfg, params: TransformerLM, cache, tokens, pos: int,
               opts: ServeOptions = ServeOptions()):
    """One decode step.  tokens [B,1]; pos the current length (an int).
    Returns (logits [B,V] fp32, the cache, updated in place)."""
    check_served(cfg)
    if opts.seq_sharded_cache:
        raise NotImplementedError(
            "seq_sharded_cache (the long_500k flash-decode over a sharded "
            "cache) is not ported: the port serves on one card")
    pos = int(pos)
    h = embed_tokens(cfg, params, tokens)
    if cfg.ssm_kind == "rwkv6":
        tm, cm, s = cache["tm_x"], cache["cm_x"], cache["s"]
        for l, blk in enumerate(params.blocks):
            hn = rmsnorm(blk.ln1, h[:, 0], cfg.norm_eps)
            y, (tm_x2, s2) = ssm_lib.rwkv6_time_mix_step(blk.tmix, hn, cfg,
                                                         tm[l], s[l])
            h = h + y[:, None]
            hn2 = rmsnorm(blk.ln2, h, cfg.norm_eps)
            y2, cm_x2 = ssm_lib.rwkv6_channel_mix(blk.cmix, hn2, prev_x=cm[l],
                                                  return_state=True)
            h = h + y2
            tm[l], cm[l], s[l] = tm_x2, cm_x2, s2
    else:
        lanes = slice(None)
        for l, blk in enumerate(params.blocks):
            h = _decode_layer(cfg, blk, h, cache["k"][l], cache["v"][l], lanes,
                              pos, pos + 1, opts)
    h = rmsnorm(params.final_norm, h, cfg.norm_eps)
    return _logits(cfg, params, h[:, 0]), cache


@torch.inference_mode()
def serve_step_vec(cfg, params: TransformerLM, cache, tokens,
                   pos_vec: torch.Tensor, opts: ServeOptions = ServeOptions()):
    """Per-slot-position decode for continuous batching (dense GQA).
    tokens [B,1]; pos_vec [B] int: each lane writes its KV at its own
    position and attends to its own prefix.  Returns (logits, the cache,
    updated in place)."""
    check_served(cfg)
    if cfg.ssm_kind:
        raise NotImplementedError(
            "serve_step_vec supports the dense GQA families, as the "
            "reference's does")
    h = embed_tokens(cfg, params, tokens)
    pos_vec = pos_vec.to(h.device).long()
    lanes = torch.arange(tokens.shape[0], device=h.device)
    for l, blk in enumerate(params.blocks):
        h = _decode_layer(cfg, blk, h, cache["k"][l], cache["v"][l], lanes,
                          pos_vec, pos_vec + 1, opts)
    h = rmsnorm(params.final_norm, h, cfg.norm_eps)
    return _logits(cfg, params, h[:, 0]), cache
