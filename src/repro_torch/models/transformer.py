"""The language model for the dense GQA, MoE and RWKV6 families: parameter
construction, the full-sequence forward, the loss (training), the prefill
and the single-token decode (serving) of `repro/models/transformer.py`.
The dense blocks take each RoPE style (full, chatglm's half, qwen2-vl's
M-RoPE over [3,B,S] position triplets, a decode position broadcast to all
three rows) and either input mode (token ids, or precomputed embeddings
``batch["embeds"]`` [B,S,D] in place of them, qwen2-vl's stub frontend).
An MoE config (kimi-k2) has ``first_k_dense`` dense layers in
``head_blocks``, then MoE layers in ``blocks`` (`models/moe.py`'s
single-device path), as the reference's tree has them; its aux loss is
summed over the layers.

The model is a `TransformerLM` module: ``embed``, ``lm_head`` (untied
configs), ``final_norm``, ``head_blocks`` (MoE configs) and ``blocks``,
whose `Params` hold the reference's per-layer dicts stacked over layers
([L, ...] leaves, as the reference's scan carries them), so the parameter
``blocks.attn.wq`` is the reference's ``params["blocks"]["attn"]["wq"]``
and `param_tree` gives the reference's tree.  `model_layers` gives each
layer's views in order (`LayerParams`, one ``unbind`` a leaf: its backward
stacks the layers' gradients once), the KV cache's layer index.
`init_params` draws the port's own weights on the device it is given (the
card unless the caller asks for the CPU); `params_from_numpy` carries the
reference's tree over, so the tests compute with JAX's weights.

`forward` runs under autograd for training (`loss_fn`: the forward, the
final norm and `chunked_softmax_xent`); each block runs under `_remat`
(`torch.utils.checkpoint` for the "minimal" and "full" policies, as the
reference's `jax.checkpoint`).  The kernels on its path are differentiable
(flash attention in the dense blocks, WKV in the RWKV6 blocks: forward and
backward kernels on the card).  `prefill`, `serve_step` and
`serve_step_vec` run under `torch.inference_mode()`: the prefill reaches
the forward kernels through `layers.chunked_attention` and
`ssm._chunked_linear_attention`; decode reads the KV cache or the recurrent
state in plain torch, as the reference does.  `serve_step` and
`serve_step_vec` update the cache in place (a 32k-token cache is not copied
a token) and return it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import ssm as ssm_lib
from repro_torch.models.kvcache import check_served
from repro_torch.models.moe import moe_apply, moe_params
from repro_torch.models.layers import (
    LayerParams,
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
from repro_torch.utils import module_tree


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


def _block_params(b: ParamBuilder, cfg, *, moe: bool = False) -> Dict[str, Any]:
    p: Dict[str, Any] = {"ln1": rmsnorm_params(b, "ln1", cfg.d_model),
                         "ln2": rmsnorm_params(b, "ln2", cfg.d_model)}
    if cfg.ssm_kind == "rwkv6":
        p["tmix"] = ssm_lib.rwkv6_params(b, cfg)
        p["cmix"] = ssm_lib.rwkv6_channel_mix_params(b, cfg)
        return p
    p["attn"] = attention_params(b, cfg)
    if moe:
        p["moe"] = moe_params(b, cfg)
    else:
        p["mlp"] = mlp_params(b, cfg)
    return p


def build_params(cfg, b: ParamBuilder) -> Dict[str, Any]:
    """The reference's params tree (blocks stacked over layers; an MoE
    config's first ``first_k_dense`` layers dense, in ``head_blocks``)."""
    check_served(cfg)
    params: Dict[str, Any] = {}
    params["embed"] = b.param("embed", (cfg.vocab_size, cfg.d_model),
                              init="normal", scale=0.02)
    if not cfg.tie_embeddings:
        params["lm_head"] = b.param("lm_head", (cfg.d_model, cfg.vocab_size))
    params["final_norm"] = rmsnorm_params(b, "final_norm", cfg.d_model)
    n_dense = cfg.first_k_dense if cfg.num_experts else 0
    if n_dense:
        with b.scope("head_blocks"), b.stacked(n_dense):
            params["head_blocks"] = _block_params(b, cfg)
    with b.scope("blocks"), b.stacked(cfg.num_layers - n_dense):
        params["blocks"] = _block_params(b, cfg, moe=bool(cfg.num_experts))
    return params


class Layer:
    """One layer's views: an attribute per reference dict (``ln1``, ``attn``,
    ``mlp`` or ``moe`` ...), each a `LayerParams`."""

    def __init__(self, dicts: Dict[str, LayerParams]):
        self.__dict__.update(dicts)


class Blocks(nn.Module):
    """The stacked per-layer parameters, one `Params` a reference dict.
    ``list(blocks)`` is the layers' views, from one ``unbind`` a leaf."""

    def __init__(self, tree: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        for name, tensors in tree.items():
            self.add_module(name, Params(tensors))

    def __len__(self) -> int:
        return next(iter(self.parameters())).shape[0]

    def layers(self) -> List[Layer]:
        per = {name: mod.unbind_layers() for name, mod in self.named_children()}
        return [Layer({name: views[i] for name, views in per.items()})
                for i in range(len(self))]

    def __iter__(self):
        return iter(self.layers())

    def __getitem__(self, i: int) -> Layer:
        return self.layers()[i]


class TransformerLM(nn.Module):
    """The parameters of one model, built from the reference's tree (the
    tensors themselves, no copy)."""

    def __init__(self, cfg, tree: Dict[str, Any]):
        super().__init__()
        self.embed = nn.Parameter(tree["embed"])
        if "lm_head" in tree:
            self.lm_head = nn.Parameter(tree["lm_head"])
        self.final_norm = Params(tree["final_norm"])
        if "head_blocks" in tree:
            self.head_blocks = Blocks(tree["head_blocks"])
        self.blocks = Blocks(tree["blocks"])


def layer_stacks(params: TransformerLM) -> List[Blocks]:
    """The stacks in layer order: ``head_blocks`` (MoE configs), ``blocks``."""
    head = [params.head_blocks] if hasattr(params, "head_blocks") else []
    return head + [params.blocks]


def model_layers(params: TransformerLM) -> List[Layer]:
    """Every layer's views in order, the KV cache's layer index."""
    return [blk for stack in layer_stacks(params) for blk in stack]


def param_tree(params: TransformerLM) -> Dict[str, Any]:
    """The reference's params tree over the module's parameters (the
    Parameters themselves): ``blocks.attn.wq`` at
    ``tree["blocks"]["attn"]["wq"]``."""
    return module_tree(params)


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
    """[D, V]: the embedding's transpose when tied."""
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


def _ffn(cfg, blk, h):
    """The block's FFN half: (h + FFN(ln2(h)), the MoE layer's aux or
    None)."""
    hn = rmsnorm(blk.ln2, h, cfg.norm_eps)
    if hasattr(blk, "moe"):
        y, aux = moe_apply(blk.moe, hn, cfg)
        return h + y, aux
    return h + mlp_apply(blk.mlp, hn), None


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
    h, aux = _ffn(cfg, blk, h)
    return h, kv, aux


def _rwkv_block_seq(cfg, blk, h, collect_state):
    if collect_state:
        y, (tm_x, s_f) = ssm_lib.rwkv6_time_mix(
            blk.tmix, rmsnorm(blk.ln1, h, cfg.norm_eps), cfg, return_state=True)
        h = h + y
        y2, cm_x = ssm_lib.rwkv6_channel_mix(
            blk.cmix, rmsnorm(blk.ln2, h, cfg.norm_eps), return_state=True)
        h = h + y2
        st = (tm_x.to(torch.bfloat16), cm_x.to(torch.bfloat16), s_f)
    else:
        h = h + ssm_lib.rwkv6_time_mix(blk.tmix,
                                       rmsnorm(blk.ln1, h, cfg.norm_eps), cfg)
        h = h + ssm_lib.rwkv6_channel_mix(blk.cmix,
                                          rmsnorm(blk.ln2, h, cfg.norm_eps))
        st = None
    return h, st, None


def _remat(fn, policy: str):
    """The reference's `_remat` over one block: "none" runs fn as it is;
    "minimal" and "full" (and the reference's other policies) checkpoint it
    (`torch.utils.checkpoint`, non-reentrant: only the block's input is
    kept, its insides are recomputed in the backward), as `jax.checkpoint`
    saves nothing inside the body.  Outside autograd (serving) there is
    nothing to save and fn runs as it is."""
    if policy == "none":
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)

    return run


def forward(cfg, params: TransformerLM, batch, *, window: int = 0,
            collect_kv: bool = False, collect_state: bool = False):
    """Full-sequence forward (train, prefill).  batch keys: 'tokens' [B,S]
    or 'embeds' [B,S,D]; 'positions' [B,S] (or [3,B,S] for mrope).  Returns
    (h_final [B,S,D], aux (the MoE layers' aux summed, each stack's in
    turn; 0 without MoE), (stacks, None)): the stacks are (k, v)
    [L,B,S,KV,hd] bf16 with ``collect_kv``, (tm_x, cm_x, s) with
    ``collect_state`` (RWKV6), else None.  Differentiable; each block under
    `_remat` with the config's policy."""
    check_served(cfg)
    if "embeds" in batch:
        h = batch["embeds"].to(_dtype(cfg))
    else:
        h = embed_tokens(cfg, params, batch["tokens"])
    positions = batch["positions"]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    per_layer = []
    for stack in layer_stacks(params):
        auxs = []
        for blk in stack:
            if cfg.ssm_kind == "rwkv6":
                def body(hh, blk=blk):
                    return _rwkv_block_seq(cfg, blk, hh, collect_state)
            else:
                def body(hh, blk=blk):
                    return _std_block_seq(cfg, blk, hh, positions,
                                          window=window, collect_kv=collect_kv)
            h, st, layer_aux = _remat(body, cfg.remat_policy)(h)
            per_layer.append(st)
            if layer_aux is not None:
                auxs.append(layer_aux)
        if auxs:
            aux = aux + torch.stack(auxs).sum()
    stacks = None
    if per_layer[0] is not None:
        stacks = tuple(torch.stack(xs) for xs in zip(*per_layer))
    return rmsnorm(params.final_norm, h, cfg.norm_eps), aux, (stacks, None)


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------


def _xent_chunk(hc: torch.Tensor, head: torch.Tensor,
                lc: torch.Tensor) -> torch.Tensor:
    """The summed cross-entropy of one chunk: logits [B,c,V] in fp32 from
    operands rounded to the working dtype (the reference's einsum with
    preferred_element_type=f32)."""
    logits = hc.float() @ head.to(hc.dtype).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    return (lse - ll).sum()


def chunked_softmax_xent(cfg, h: torch.Tensor, head: torch.Tensor,
                         labels: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Mean cross-entropy without materializing [B,S,V]: the sequence in
    chunks of ``chunk`` tokens (all of S if it does not divide), each chunk
    under a checkpoint (its logits recomputed in the backward), summed in
    order, over B S."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        args = (h[:, c0:c0 + chunk], head, labels[:, c0:c0 + chunk])
        total = total + (checkpoint(_xent_chunk, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else _xent_chunk(*args))
    return total / (B * S)


def loss_fn(cfg, params: TransformerLM, batch, *, window: int = 0):
    """(loss, {"xent", "aux"}) of batch 'tokens', 'labels', 'positions'
    [B,S]: the forward, then `chunked_softmax_xent` against `lm_head`."""
    h, aux, _ = forward(cfg, params, batch, window=window)
    loss = chunked_softmax_xent(cfg, h, lm_head(cfg, params), batch["labels"])
    return loss + cfg.router_aux_coef * aux, {"xent": loss, "aux": aux}


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
    return _ffn(cfg, blk, h)[0]


def _decode_layer(cfg, blk, h, k_l, v_l, lanes, pos, cache_len, opts):
    """One layer for one new token a lane: q, k, v at the lanes' positions,
    k and v written into the layer's cache at (lanes, pos), attention over
    each lane's first cache_len entries, then the MLP."""
    hn = rmsnorm(blk.ln1, h, cfg.norm_eps)
    B = h.shape[0]
    positions = (torch.full((B, 1), pos, device=h.device) if isinstance(pos, int)
                 else pos.reshape(B, 1))
    if cfg.rope_style == "mrope":  # a text token: all three rows alike
        positions = positions[None].expand(3, B, 1)
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
        for l, blk in enumerate(model_layers(params)):
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
        for l, blk in enumerate(model_layers(params)):
            h = _decode_layer(cfg, blk, h, cache["k"][l], cache["v"][l], lanes,
                              pos, pos + 1, opts)
    h = rmsnorm(params.final_norm, h, cfg.norm_eps)
    return _logits(cfg, params, h[:, 0]), cache


@torch.inference_mode()
def serve_step_vec(cfg, params: TransformerLM, cache, tokens,
                   pos_vec: torch.Tensor, opts: ServeOptions = ServeOptions()):
    """Per-slot-position decode for continuous batching (dense GQA and MoE).
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
    for l, blk in enumerate(model_layers(params)):
        h = _decode_layer(cfg, blk, h, cache["k"][l], cache["v"][l], lanes,
                          pos_vec, pos_vec + 1, opts)
    h = rmsnorm(params.final_norm, h, cfg.norm_eps)
    return _logits(cfg, params, h[:, 0]), cache
