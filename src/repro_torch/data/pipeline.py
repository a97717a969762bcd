"""The concrete half of the data pipeline (the port's copy of
`repro/data/pipeline.py`): the deterministic synthetic token stream and the
concrete train and serving batches.

Every array is drawn with the reference's numpy `default_rng` calls in the
reference's order, so for one seed the tokens and labels (and, for an
embeddings-input config, qwen2-vl's, the stub frontend's patch embeddings
[B,S,D] in bf16) are bitwise the reference's; M-RoPE configs get (3, B, S)
position triplets, all three rows the text position.  They become tensors
on the ``device`` the caller names (the card unless the caller asks for the
CPU).  The encoder-decoder batch waits with its family (ROADMAP.md queue 1,
item 15c).  The abstract half
(`input_specs`, `batch_logical_axes`) is sharding code and is not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the data pipeline puts batches on the card by default and CUDA is "
            "not available; pass device='cpu' to run on the CPU")
    return device


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def model_positions(cfg: ModelConfig, B: int, S: int, device) -> torch.Tensor:
    """[B,S] text positions, or under M-RoPE the (3, B, S) triplets of a
    text sequence (all three rows equal), as the reference builds them."""
    p = _positions(B, S, device)
    return p[None].expand(3, B, S) if cfg.rope_style == "mrope" else p


def _check_served(cfg: ModelConfig) -> None:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the pipeline's encoder-decoder inputs are not "
            "ported (ROADMAP.md queue 1, item 15c)")


def make_train_batch(cfg: ModelConfig, shape: ShapeConfig, *,
                     rng: np.random.Generator,
                     device="cuda") -> Dict[str, Any]:
    """tokens (or, for input_mode "embeddings", the stub frontend's embeds
    [B,S,D] bf16) and labels [B,S] int32 drawn from ``rng`` in the
    reference's order, positions [B,S] ([3,B,S] under mrope)."""
    _check_served(cfg)
    device = _device(device)
    B, S = shape.global_batch, shape.seq_len
    batch: Dict[str, Any] = {}
    if cfg.input_mode == "embeddings":
        embeds = rng.standard_normal((B, S, cfg.d_model), np.float32) * 0.02
        batch["embeds"] = torch.from_numpy(embeds).to(device, torch.bfloat16)
    else:
        tokens = rng.integers(0, cfg.vocab_size, (B, S))
        batch["tokens"] = torch.from_numpy(tokens.astype(np.int32)).to(device)
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    batch["labels"] = torch.from_numpy(labels.astype(np.int32)).to(device)
    batch["positions"] = model_positions(cfg, B, S, device)
    return batch


def make_prefill_batch(cfg: ModelConfig, shape: ShapeConfig, *,
                       rng: np.random.Generator, device="cuda") -> Dict[str, Any]:
    b = make_train_batch(cfg, shape, rng=rng, device=device)
    b.pop("labels")
    return b


def make_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
               device="cuda"):
    """A concrete batch of ``shape``'s kind from ``seed``: {"batch": ...}
    for train and prefill, {"cache", "tokens", "pos"} for decode (a zeroed
    cache of the shape's length, pos S - 1)."""
    rng = np.random.default_rng(seed)
    if shape.kind == "train":
        return {"batch": make_train_batch(cfg, shape, rng=rng, device=device)}
    if shape.kind == "prefill":
        return {"batch": make_prefill_batch(cfg, shape, rng=rng, device=device)}
    from repro_torch.models.kvcache import init_cache

    _check_served(cfg)
    device = _device(device)
    B, S = shape.global_batch, shape.seq_len
    cache = init_cache(cfg, B, S, device=device)
    tokens = rng.integers(0, cfg.vocab_size, (B, 1))
    return {"cache": cache,
            "tokens": torch.from_numpy(tokens.astype(np.int32)).to(device),
            "pos": S - 1}


def synthetic_token_stream(vocab_size: int, batch: int, seq_len: int,
                           seed: int = 0, pattern_len: int = 16,
                           noise: float = 0.02, device="cuda"
                           ) -> Iterator[Dict[str, torch.Tensor]]:
    """Deterministic LM data: each sequence tiles a random `pattern_len`-token
    pattern (plus a little noise), an induction-head task a transformer
    cracks within a few hundred steps, on a Zipf-skewed vocabulary (a
    unigram signal learnt within tens of steps).  labels = next token.
    tokens, labels [batch, seq_len] int32, positions [batch, seq_len]."""
    device = _device(device)
    rng = np.random.default_rng(seed)
    pattern_len = min(pattern_len, max(seq_len // 4, 2))
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / (ranks + 8.0)
    probs /= probs.sum()
    positions = _positions(batch, seq_len, device)
    while True:
        pat = rng.choice(vocab_size, size=(batch, pattern_len), p=probs)
        reps = (seq_len + 1) // pattern_len + 1
        seq = np.tile(pat, (1, reps))[:, : seq_len + 1]
        noise_tok = rng.integers(0, vocab_size, seq.shape)
        mask = rng.random(seq.shape) < noise
        seq = torch.from_numpy(np.where(mask, noise_tok, seq).astype(np.int32))
        yield {"tokens": seq[:, :-1].contiguous().to(device),
               "labels": seq[:, 1:].contiguous().to(device),
               "positions": positions}
