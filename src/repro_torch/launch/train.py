"""The LLM training launcher (the port's copy of `repro/launch/train.py`):
the train step, the train state, the default optimizer and the CLI loop.

    python -m repro_torch.launch.train --arch llama3.2-1b --steps 50

The train state is ``{"params": TransformerLM, "opt": the optimizer's
state over `param_tree`, "step": a 0-dim int32 tensor on the host}``.  A
step is the reference's: `loss_fn` and its gradient (through the flash and
WKV backward kernels on the card), the global-norm clip, the optimizer's
update added into the parameters.  Unlike the reference's pure step, the
parameters, the gradients (clipped in place) and the optimizer state are
updated in place, leaf by leaf, so the card holds one copy of each (a
donated JAX state does the same); the returned state holds the same
tensors.  The mesh code (`make_train_state_specs`,
`make_sharded_train_step`) is not ported: the port trains on one card.

Runs on the card unless the caller asks for the CPU (``--device cpu``).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import synthetic_token_stream
from repro_torch.models import transformer as T
from repro_torch.optim import (
    Optimizer,
    clip_by_global_norm_,
    cosine_schedule,
    make_optimizer,
)
from repro_torch.utils import get_logger, human_count, tree_leaves, tree_map, tree_num_params

log = get_logger("repro_torch.train")


def make_train_step(cfg, optimizer: Optimizer, *, clip_norm: float = 1.0,
                    window: int = 0):
    """step(state, batch) -> (new_state, metrics {loss, xent, aux,
    grad_norm}, 0-dim tensors on the model's device)."""
    def train_step(state, batch):
        model = state["params"]
        tree = T.param_tree(model)
        loss, metrics = T.loss_fn(cfg, model, batch, window=window)
        # a leaf the loss does not read (the embedding table of a config fed
        # embeddings) gets a zero gradient, as JAX's grad gives it
        flat = iter(torch.autograd.grad(loss, tree_leaves(tree),
                                        materialize_grads=True))
        grads = tree_map(lambda p: next(flat), tree)
        del flat
        gnorm = clip_by_global_norm_(grads, clip_norm)
        opt2 = optimizer.apply_(grads, state["opt"], tree, state["step"])
        del grads
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss.detach(), grad_norm=gnorm)
        return {"params": model, "opt": opt2, "step": state["step"] + 1}, metrics

    return train_step


def init_train_state(cfg, optimizer: Optimizer, seed: int = 0, device="cuda"):
    """The port's seeded weights (`transformer.init_params`), the
    optimizer's zero state, step 0."""
    params = T.init_params(cfg, seed, device)
    return {"params": params, "opt": optimizer.init(T.param_tree(params)),
            "step": torch.zeros((), dtype=torch.int32)}


def default_optimizer(cfg, *, base_lr=3e-4, warmup=100, total=10000) -> Optimizer:
    return make_optimizer(cfg.optimizer, cosine_schedule(base_lr, warmup, total))


# ---------------------------------------------------------------------------
# CLI loop
# ---------------------------------------------------------------------------


def stub_frontend(cfg, batch):
    """The CLI loop's stream batch as the config takes it: for an
    embeddings-input config (qwen2-vl) the reference loop's stub frontend,
    each token a one-hot row (token mod d_model) in bf16 in place of the
    tokens; under M-RoPE the [B,S] positions as (3, B, S) text triplets
    (the reference's loop hands its mrope the [B,S] positions, which its
    `apply_rope` refuses)."""
    batch = dict(batch)
    if cfg.rope_style == "mrope":
        B, S = batch["positions"].shape
        batch["positions"] = batch["positions"][None].expand(3, B, S)
    if cfg.input_mode == "embeddings":
        tokens = batch.pop("tokens").long()
        batch["embeds"] = torch.nn.functional.one_hot(
            tokens % cfg.d_model, cfg.d_model).to(torch.bfloat16)
    return batch


def run_training(arch: str, steps: int, *, smoke: bool = True, batch: int = 8,
                 seq: int = 128, log_every: int = 10,
                 ckpt_dir: Optional[str] = None, device="cuda"):
    """Train ``arch`` (its smoke config unless ``smoke`` is False) for
    ``steps`` steps on the synthetic token stream; returns the losses."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    optimizer = default_optimizer(cfg, total=steps)
    state = init_train_state(cfg, optimizer, 0, device)
    log.info("arch=%s params=%s", cfg.name,
             human_count(tree_num_params(state["params"])))
    step_fn = make_train_step(cfg, optimizer)
    stream = synthetic_token_stream(cfg.vocab_size, batch, seq,
                                    device=state["params"].embed.device)
    t0 = time.time()
    losses = []
    for i in range(steps):
        state, metrics = step_fn(state, stub_frontend(cfg, next(stream)))
        losses.append(float(metrics["loss"]))
        if i % log_every == 0:
            log.info("step %d loss %.4f grad_norm %.3f (%.2fs)", i, losses[-1],
                     float(metrics["grad_norm"]), time.time() - t0)
        if ckpt_dir and (i + 1) % 100 == 0:
            save_checkpoint(ckpt_dir, i + 1, state)
    return losses


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    losses = run_training(args.arch, args.steps, smoke=not args.full_config,
                          batch=args.batch, seq=args.seq,
                          ckpt_dir=args.ckpt_dir, device=args.device)
    log.info("first loss %.4f final loss %.4f", losses[0], losses[-1])
    return losses


if __name__ == "__main__":
    main()
