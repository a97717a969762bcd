"""Full-graph GNN training entry point (the port's counterpart of the full-graph
engine branch of `examples/train_gnn_distributed.py`): `DistGNNEngine`'s
training step (synchronous, or under a historical-embedding protocol), timed
step by step, with the single-device oracle and the layer-wise inference
sweep as checks.  One process per rank
(`launch/common.py`): without ``--init-method`` it runs alone.

    PYTHONPATH=src python -m repro_torch.launch.train_gnn --oracle-check
    PYTHONPATH=src python -m repro_torch.launch.train_gnn --device cpu --oracle-check --infer
    PYTHONPATH=src python -m repro_torch.launch.train_gnn --model gat --device cpu --oracle-check
    PYTHONPATH=src python -m repro_torch.launch.train_gnn --device cpu --exec ring --protocol epoch_fixed --oracle-check
    PYTHONPATH=src python -m repro_torch.launch.train_gnn --device cpu --partition-family vertex_cut --oracle-check
    PYTHONPATH=src python -m repro_torch.launch.train_gnn --device cpu --partition-family hybrid --model gat --oracle-check
    # rank r of 4 gloo ranks on the CPU (start r = 0, 1, 2, 3 together):
    PYTHONPATH=src python -m repro_torch.launch.train_gnn --device cpu \
        --world-size 4 --rank r --init-method file:///tmp/rdv --oracle-check --infer
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.engine import DistGNNEngine, EngineConfig
from repro_torch.core.graph import sbm_graph
from repro_torch.launch.common import (
    add_group_args,
    device_of,
    join_group,
    leave_group,
    partition_config,
)
from repro_torch.utils import get_logger

log = get_logger("repro_torch.train_gnn")

# what the port runs today; the rest of the reference's choices arrive with
# later slices
PORTED_EXECUTION_MODELS = ("p2p", "broadcast", "ring")
PORTED_PROTOCOLS = ("sync", "epoch_fixed", "epoch_adaptive", "variation")
PORTED_GNN_MODELS = ("gcn", "sage", "gat", "gin")
ORACLE_TOL = 1e-4  # the repo's oracle bound for every step and sweep


def build_engine(args, g):
    """The engine on this rank's device; the process group, if any, must
    already be joined (`join_group`)."""
    cfg = EngineConfig(execution=args.exec, protocol=args.protocol,
                       model=args.model, **partition_config(args),
                       exchange_chunks=args.exchange_chunks,
                       hidden=args.hidden, num_layers=args.layers, lr=args.lr)
    return DistGNNEngine(g, cfg=cfg, device=device_of(args))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_training(eng, epochs: int, *, oracle_check: bool = False,
                 infer: bool = False) -> dict:
    """`epochs` steps of the engine's training step from `init_state()`,
    each timed on the host clock ending in a device synchronize, with the
    step's wire bytes accrued into CommStats as `eng.train` accrues them.
    Returns the losses, the rows each step pushed into the history (0
    under sync), the step walls (seconds), the final state and the last
    step's logits of every vertex (one all_gather after the run); with
    ``oracle_check`` also the reference run's losses and the largest
    per-step loss gap, and with ``infer`` the layer-wise sweep's gap to the
    reference sweep at the final params."""
    step = eng.make_step()
    state = eng.init_state()
    eng.comm_stats.reset()
    losses, pushed, walls, logits = [], [], [], None
    for _ in range(epochs):
        _sync(eng.device)
        t0 = time.perf_counter()
        state, metrics, logits = step(state)
        losses.append(float(metrics["loss"]))
        _sync(eng.device)
        walls.append(time.perf_counter() - t0)
        pushed.append(float(metrics["rows_pushed"]))
        eng.account_step()
    logits = eng.gather_rows(logits)
    out = dict(losses=losses, rows_pushed=pushed, walls=walls, state=state,
               logits=logits)
    for e in range(0, epochs, max(epochs // 4, 1)):
        log.info("epoch %3d loss %.4f (%.1f ms)", e, losses[e], walls[e] * 1e3)
    log.info("final: train_acc=%.3f test_acc=%.3f (halo bytes %d, replica "
             "sync bytes %d over %d steps; %d boundary rows pushed)",
             eng.accuracy(logits, "train"), eng.accuracy(logits, "test"),
             eng.comm_stats.halo_bytes, eng.comm_stats.replica_sync_bytes,
             epochs, sum(pushed))
    if oracle_check:
        ref_losses, _ = eng.train(epochs, reference=True)
        gap = max(abs(a - b) for a, b in zip(losses, ref_losses))
        log.info("oracle gap (max |loss_dist - loss_ref|) = %.2e", gap)
        if not gap <= ORACLE_TOL:
            raise RuntimeError(f"training diverged from the reference: {gap}")
        out.update(ref_losses=ref_losses, oracle_gap=gap)
    if infer:
        params = state["params"]
        emb = eng.global_embeddings(eng.infer_full_graph(params=params))
        ref = eng.global_embeddings(eng.infer_full_graph(params=params,
                                                         reference=True))
        err = float(np.max(np.abs(emb - ref)))
        log.info("layer-wise inference sweep: embeddings %s, oracle gap %.2e",
                 emb.shape, err)
        if not err <= ORACLE_TOL:
            raise RuntimeError(f"sweep diverged from the reference: {err}")
        out.update(infer_gap=err)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device the step runs on (cpu only when asked)")
    ap.add_argument("--exec", default=EngineConfig.execution,
                    choices=list(PORTED_EXECUTION_MODELS))
    add_group_args(ap)
    ap.add_argument("--protocol", default="sync", choices=list(PORTED_PROTOCOLS))
    ap.add_argument("--model", default="gcn", choices=list(PORTED_GNN_MODELS))
    ap.add_argument("--exchange-chunks", type=int, default=1)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vertices", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--oracle-check", action="store_true",
                    help="rerun on the single-device reference; fail past 1e-4")
    ap.add_argument("--infer", action="store_true",
                    help="run the layer-wise sweep at the final params and "
                         "check it against the reference sweep")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    join_group(args)
    try:
        g = sbm_graph(args.vertices, num_blocks=8, p_in=0.05, p_out=0.003,
                      seed=0)
        eng = build_engine(args, g)
        log.info("engine: model=%s exec=%s protocol=%s family=%s rank %d of "
                 "k=%d (nb=%d, K=%d) on %s", args.model, args.exec,
                 args.protocol, args.partition_family, eng.rank, eng.k,
                 eng.nb, eng.K, eng.device)
        return run_training(eng, args.epochs, oracle_check=args.oracle_check,
                            infer=args.infer)
    finally:
        leave_group(args)


if __name__ == "__main__":
    main()
