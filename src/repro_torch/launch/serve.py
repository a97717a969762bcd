"""LLM serving driver (the port's counterpart of `repro/launch/serve.py`):
`greedy_decode`, the batched-request decode loop the serving example uses,
and a small CLI.

Decode runs token by token through `models.transformer.serve_step`, the
prompt included, as the reference's loop does; a caller that wants the
prompt through the kernels calls `transformer.prefill` and decodes from the
cache it returns.  The sharded builders of the reference
(`make_sharded_serve_step` and its rules) have no counterpart on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import PORTED_ARCHS, get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.kvcache import init_cache
from repro_torch.utils import get_logger

log = get_logger("repro_torch.serve")


@torch.inference_mode()
def greedy_decode(cfg, params, prompt_tokens: torch.Tensor, max_new: int, *,
                  max_len: Optional[int] = None) -> torch.Tensor:
    """Single-card greedy decode: feed the prompt token by token, then
    generate ``max_new`` tokens, each the argmax of the last logits.
    prompt_tokens [B, S0] on the params' device; returns [B, max_new]
    int32."""
    B, S0 = prompt_tokens.shape
    max_len = max_len or (S0 + max_new)
    cache = init_cache(cfg, B, max_len, device=params.embed.device)
    tok = prompt_tokens[:, :1]
    out = []
    for i in range(S0 + max_new - 1):
        logits, cache = T.serve_step(cfg, params, cache, tok, i)
        if i + 1 < S0:
            tok = prompt_tokens[:, i + 1:i + 2]
        else:
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            out.append(tok)
    return torch.cat(out, 1)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b", choices=list(PORTED_ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0,
                    help="the seed of the model's random weights")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> torch.Tensor:
    """Greedy-decode a batch of all-ones prompts with the arch's smoke
    config and seeded weights; returns the tokens [batch, max_new]."""
    args = parse_args(argv)
    cfg = get_smoke_config(args.arch)
    params = T.init_params(cfg, args.seed, args.device)
    device = params.embed.device
    prompt = torch.ones((args.batch, args.prompt_len), dtype=torch.int32,
                        device=device)
    t0 = time.perf_counter()
    toks = greedy_decode(cfg, params, prompt, args.max_new)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log.info("decoded %s tokens on %s in %.2fs: %s", tuple(toks.shape), device,
             time.perf_counter() - t0, toks[0, :8].tolist())
    return toks


if __name__ == "__main__":
    main()
