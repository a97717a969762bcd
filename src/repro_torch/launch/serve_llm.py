"""Batched LLM serving (the port's counterpart of `examples/serve_llm.py`):
greedy-decode continuations of a batch of seeded prompts through the KV
cache or recurrent state, check that a second decode gives the same tokens,
then run staggered requests through continuous batching (dense GQA archs).

    PYTHONPATH=src python -m repro_torch.launch.serve_llm --arch llama3.2-1b --batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve_llm --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import PORTED_ARCHS, get_smoke_config
from repro_torch.launch.batching import ContinuousBatchingEngine, Request
from repro_torch.launch.serve import greedy_decode
from repro_torch.models import transformer as T
from repro_torch.utils import get_logger

log = get_logger("repro_torch.serve_llm")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b", choices=list(PORTED_ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0,
                    help="the seed of the model's random weights")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def _synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Returns the decoded tokens, the decode's seconds and tokens/s, and
    the continuous-batching stats (None for an RWKV arch)."""
    args = parse_args(argv)
    cfg = get_smoke_config(args.arch)
    params = T.init_params(cfg, args.seed, args.device)
    device = params.embed.device
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)).to(device)
    t0 = time.perf_counter()
    out = greedy_decode(cfg, params, prompts, args.max_new)
    _synchronize(device)
    dt = time.perf_counter() - t0
    n_tok = args.batch * (args.prompt_len + args.max_new)
    log.info("decoded %s on %s in %.2fs (%.1f tok/s, batch=%d)",
             tuple(out.shape), device, dt, n_tok / dt, args.batch)
    log.info("sample continuation ids: %s", out[0, :12].tolist())
    # determinism check: same prompts -> same tokens
    again = greedy_decode(cfg, params, prompts, args.max_new)
    if not torch.equal(out, again):
        raise RuntimeError("non-deterministic decode")
    log.info("determinism check passed")
    stats = None
    if not cfg.ssm_kind:
        # continuous batching: staggered arrivals share decode waves
        eng = ContinuousBatchingEngine(cfg, params, slots=args.batch, max_len=64)
        rng2 = np.random.default_rng(1)
        for uid in range(args.batch * 2):
            eng.submit(Request(uid=uid, prompt=rng2.integers(
                1, cfg.vocab_size, 8).astype(np.int32), max_new=8))
        stats = eng.run_until_drained()
        log.info("continuous batching: %d reqs, %d tokens, %d ticks, "
                 "occupancy %.2f", stats.requests_completed,
                 stats.tokens_generated, stats.ticks, stats.mean_occupancy)
    return dict(tokens=out, seconds=dt, tokens_per_s=n_tok / dt, batching=stats)


if __name__ == "__main__":
    main()
