"""KV / state cache containers for decode: the dense GQA and RWKV6 layouts of
`repro/models/kvcache.py`.

A cache is a flat dict of tensors stacked over layers (leading L dim):

  attention : k, v        [L, B, T, KV, hd]  bf16
  rwkv6     : tm_x, cm_x  [L, B, D] bf16, s [L, B, H, K, K] fp32

The attention layout covers every layer of a config, an MoE config's
dense head layers first.  The other families' layouts (MLA, mamba2, the
hybrid's shared attention, encoder-decoder) belong to configs the port does
not serve: `check_served` refuses them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def check_served(cfg) -> None:
    """Raise for a config outside the families the port serves and trains
    (dense GQA, any RoPE style and either input mode, MoE over GQA
    attention, and RWKV6)."""
    refused = {"MLA": cfg.use_mla,
               "mamba2 / hybrid": cfg.ssm_kind == "mamba2" or cfg.attn_every > 0,
               "encoder-decoder": cfg.is_encoder_decoder}
    for what, hit in refused.items():
        if hit:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported; the port serves and trains "
                "the dense GQA, MoE and RWKV6 families (ROADMAP.md queue 1, "
                "item 15)")


def cache_spec(cfg, batch: int, max_len: int) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Returns {name: (shape, dtype)}."""
    check_served(cfg)
    L, B, T, D = cfg.num_layers, batch, max_len, cfg.d_model
    dt = torch.bfloat16
    if cfg.ssm_kind == "rwkv6":
        H, K = cfg.ssm_heads, cfg.ssm_state
        return {"tm_x": ((L, B, D), dt), "cm_x": ((L, B, D), dt),
                "s": ((L, B, H, K, K), torch.float32)}
    kv = ((L, B, T, cfg.num_kv_heads, cfg.head_dim), dt)
    return {"k": kv, "v": kv}


def init_cache(cfg, batch: int, max_len: int, *, device) -> Dict[str, torch.Tensor]:
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in cache_spec(cfg, batch, max_len).items()}


def cache_bytes(cfg, batch: int, max_len: int) -> int:
    total = 0
    for shape, dtype in cache_spec(cfg, batch, max_len).values():
        n = 1
        for d in shape:
            n *= d
        total += n * torch.empty((), dtype=dtype).element_size()
    return total
