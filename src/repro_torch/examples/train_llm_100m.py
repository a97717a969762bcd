"""End to end: train a llama-style model for a few hundred steps on
the synthetic induction-head stream and watch the loss fall (the port's copy
of `examples/train_llm_100m.py`).

  PYTHONPATH=src python -m repro_torch.examples.train_llm_100m --steps 300
  PYTHONPATH=src python -m repro_torch.examples.train_llm_100m --preset 100m

The 40m preset is the default; 100m (~108M parameters) runs the same path
at larger widths.  On the card unless ``--device cpu``.  Asserts the loss
fell at least 5 %.
"""
import argparse
import time

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import synthetic_token_stream
from repro_torch.launch.train import default_optimizer, init_train_state, make_train_step
from repro_torch.utils import get_logger, human_count, tree_num_params

log = get_logger("repro_torch.examples.llm100m")

PRESETS = {
    "40m": ModelConfig(
        name="llama-40m", family="dense", source="scaled-down llama3 family",
        num_layers=8, d_model=512, num_heads=8, num_kv_heads=4, head_dim=64,
        d_ff=2048, vocab_size=8192, rope_theta=5e5, remat_policy="none"),
    "100m": ModelConfig(
        name="llama-100m", family="dense", source="scaled-down llama3 family",
        num_layers=10, d_model=768, num_heads=12, num_kv_heads=4, head_dim=64,
        d_ff=2560, vocab_size=16384, rope_theta=5e5, remat_policy="none"),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--preset", default="40m", choices=list(PRESETS))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Returns the run's first and last loss, the drop and the wall time."""
    args = parse_args(argv)
    cfg = PRESETS[args.preset]
    opt = default_optimizer(cfg, base_lr=args.lr, warmup=20, total=args.steps)
    state = init_train_state(cfg, opt, 0, args.device)
    log.info("params: %s", human_count(tree_num_params(state["params"])))
    step = make_train_step(cfg, opt)
    stream = synthetic_token_stream(cfg.vocab_size, args.batch, args.seq, seed=0,
                                    device=args.device)
    t0 = time.time()
    first = loss = None
    for i in range(args.steps):
        state, m = step(state, next(stream))
        loss = float(m["loss"])
        first = first if first is not None else loss
        if i % 20 == 0 or i == args.steps - 1:
            tok_s = (i + 1) * args.batch * args.seq / (time.time() - t0)
            log.info("step %4d loss %.4f (%.0f tok/s)", i, loss, tok_s)
    log.info("loss %.4f -> %.4f (%.1f%% drop)", first, loss,
             100 * (1 - loss / first))
    assert loss < first * 0.95, "training did not learn"
    return dict(first=first, last=loss, drop=1 - loss / first,
                seconds=time.time() - t0, steps=args.steps,
                params=tree_num_params(state["params"]))


if __name__ == "__main__":
    main()
