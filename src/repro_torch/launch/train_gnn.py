"""GNN training entry point (the port's counterpart of the engine branch of
`examples/train_gnn_distributed.py`): `DistGNNEngine`'s full-graph training
step (synchronous, or under a historical-embedding protocol), timed step by
step, or with ``--batching node_wise|layer_wise|subgraph`` the sampled
mini-batch epoch under a schedule (``--schedule``; ``--batch-size``,
``--fanouts``, ``--layer-sizes``, ``--walk-length``, the static feature cache
``--cache`` / ``--cache-capacity``; ``pipelined`` builds batches ahead on a
prefetch thread or, with ``--prefetch-mode process``, in a pool of
``--num-sample-workers`` sampling processes over a shared-memory ring,
``--prefetch-depth`` batches ahead), with the single-device oracle and the
layer-wise inference sweep as checks.  One process per rank
(`launch/common.py`): without ``--init-method`` it runs alone.

``--trace-out t.json`` enables the run-wide telemetry (`core/telemetry.py`)
and, after the run, writes a Chrome trace-event file (open it in Perfetto
or chrome://tracing: one row per device and lane) and the step log
``t.json.steps.jsonl``, and logs the per-stage seconds and each per-device
metric's max/mean imbalance.  Rank r > 0 of a group writes
``t.rank<r>.json`` and its step log beside it.

    PYTHONPATH=src python -m repro_torch.launch.train_gnn --oracle-check
    PYTHONPATH=src python -m repro_torch.launch.train_gnn --device cpu --oracle-check --infer
    PYTHONPATH=src python -m repro_torch.launch.train_gnn --model gat --device cpu --oracle-check
    PYTHONPATH=src python -m repro_torch.launch.train_gnn --device cpu --exec ring --protocol epoch_fixed --oracle-check
    PYTHONPATH=src python -m repro_torch.launch.train_gnn --device cpu --partition-family vertex_cut --oracle-check
    PYTHONPATH=src python -m repro_torch.launch.train_gnn --device cpu --partition-family hybrid --model gat --oracle-check
    PYTHONPATH=src python -m repro_torch.launch.train_gnn --device cpu --batching node_wise --cache static_degree --cache-capacity 32 --oracle-check --infer
    PYTHONPATH=src python -m repro_torch.launch.train_gnn --device cpu --batching node_wise --schedule pipelined --prefetch-mode process --oracle-check
    PYTHONPATH=src python -m repro_torch.launch.train_gnn --device cpu --batching node_wise --schedule pipelined --trace-out /tmp/t.json
    # rank r of 4 gloo ranks on the CPU (start r = 0, 1, 2, 3 together):
    PYTHONPATH=src python -m repro_torch.launch.train_gnn --device cpu \
        --world-size 4 --rank r --init-method file:///tmp/rdv --oracle-check --infer
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.engine import (
    BATCHING_MODES,
    ENGINE_CACHE_POLICIES,
    PREFETCH_MODES,
    DistGNNEngine,
    EngineConfig,
)
from repro_torch.core.graph import sbm_graph
from repro_torch.launch.common import (
    add_group_args,
    device_of,
    join_group,
    leave_group,
    partition_config,
    per_layer,
)
from repro_torch.utils import get_logger

log = get_logger("repro_torch.train_gnn")

# what the port runs today; the rest of the reference's choices arrive with
# later slices
PORTED_EXECUTION_MODELS = ("p2p", "broadcast", "ring")
PORTED_PROTOCOLS = ("sync", "epoch_fixed", "epoch_adaptive", "variation")
PORTED_GNN_MODELS = ("gcn", "sage", "gat", "gin")
SCHEDULE_CHOICES = ("conventional", "factored", "operator_parallel",
                    "pipelined")
ORACLE_TOL = 1e-4  # the repo's oracle bound for every step and sweep


def build_engine(args, g):
    """The engine on this rank's device; the process group, if any, must
    already be joined (`join_group`)."""
    cfg = EngineConfig(execution=args.exec, protocol=args.protocol,
                       model=args.model, **partition_config(args),
                       exchange_chunks=args.exchange_chunks,
                       hidden=args.hidden, num_layers=args.layers, lr=args.lr,
                       batching=args.batching, batch_size=args.batch_size,
                       fanouts=per_layer(args.fanouts, 4, args.layers),
                       layer_sizes=per_layer(args.layer_sizes, 32,
                                             args.layers),
                       walk_length=args.walk_length, cache_policy=args.cache,
                       cache_capacity=args.cache_capacity,
                       prefetch_depth=args.prefetch_depth,
                       prefetch_mode=args.prefetch_mode,
                       num_sample_workers=args.num_sample_workers)
    return DistGNNEngine(g, cfg=cfg, device=device_of(args))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sweep_gap(eng, params) -> float:
    """The layer-wise sweep at ``params`` against the reference sweep: the
    largest gap, which must be within ORACLE_TOL."""
    emb = eng.global_embeddings(eng.infer_full_graph(params=params))
    ref = eng.global_embeddings(eng.infer_full_graph(params=params,
                                                     reference=True))
    err = float(np.max(np.abs(emb - ref)))
    log.info("layer-wise inference sweep: embeddings %s, oracle gap %.2e",
             emb.shape, err)
    if not err <= ORACLE_TOL:
        raise RuntimeError(f"sweep diverged from the reference: {err}")
    return err


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
    tel = eng.telemetry
    losses, pushed, walls, logits = [], [], [], None
    for i in range(epochs):
        _sync(eng.device)
        t0 = time.perf_counter()
        with tel.span("train", step=i):
            state, metrics, logits = step(state)
            losses.append(float(metrics["loss"]))
        _sync(eng.device)
        walls.append(time.perf_counter() - t0)
        pushed.append(float(metrics["rows_pushed"]))
        eng.account_step(i)
        tel.log_step(step=i, loss=losses[-1], wall_s=walls[-1],
                     comm_total_bytes=eng.comm_stats.total())
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
        out.update(infer_gap=sweep_gap(eng, state["params"]))
    return out


def run_minibatch(eng, epochs: int, *, schedule: str = "conventional",
                  oracle_check: bool = False, infer: bool = False) -> dict:
    """One mini-batch epoch of `epochs` batches under ``schedule``
    (`run_epoch_minibatch`; ``pipelined`` with the engine's prefetch mode,
    depth and workers), CommStats reset first.  Returns the losses, the final state, the StageTimes, the
    CommStats of the epoch and the accuracy of the final params on the last
    batch; with ``oracle_check`` also the reference run's losses and the
    largest per-step loss gap, and with ``infer`` the layer-wise sweep's
    gap to the reference sweep at the final params."""
    state, losses, times = eng.run_epoch_minibatch(epochs, schedule=schedule)
    s = eng.comm_stats
    comm = dataclasses.asdict(s)
    for e in range(0, epochs, max(epochs // 4, 1)):
        log.info("batch %3d loss %.4f", e, losses[e])
    log.info("schedule=%s: wall %.3fs (sample %.3f, extract %.3f, train "
             "%.3f s)", schedule, times.wall, times.sample, times.extract,
             times.train)
    log.info("feature fetch: %.3f MB pulled, %.3f MB served by the %r cache "
             "(%.1f%% of the bytes asked for)", s.pull_bytes / 1e6,
             s.cache_hit_bytes / 1e6, eng.cfg.cache_policy,
             100.0 * s.cache_hit_bytes / max(s.requested(), 1))
    batch = eng.sample_minibatch(epochs - 1)
    _, _, logits = eng.make_minibatch_step()(state, batch)
    acc = eng.minibatch_accuracy(logits, batch)
    log.info("final: batch train_acc=%.3f", acc)
    out = dict(losses=losses, state=state, times=times, comm=comm, acc=acc)
    if oracle_check:
        ref_losses, _ = eng.train(epochs, reference=True)
        gap = max(abs(a - b) for a, b in zip(losses, ref_losses))
        log.info("oracle gap (max |loss_dist - loss_ref|) = %.2e", gap)
        if not gap <= ORACLE_TOL:
            raise RuntimeError(f"training diverged from the reference: {gap}")
        out.update(ref_losses=ref_losses, oracle_gap=gap)
    if infer:
        out.update(infer_gap=sweep_gap(eng, state["params"]))
    return out


def trace_paths(path: str, rank: int) -> Tuple[str, str]:
    """The trace and step-log files of ``--trace-out path`` on ``rank``:
    rank 0 writes ``path``, rank r > 0 ``<root>.rank<r><ext>``; each step
    log is its trace's name + ``.steps.jsonl``."""
    if rank > 0:
        root, ext = os.path.splitext(path)
        path = f"{root}.rank{rank}{ext}"
    return path, path + ".steps.jsonl"


def write_trace(eng, path: str) -> dict:
    """Write the engine's telemetry after a run: the Chrome trace and the
    step log (`trace_paths`), with the card's memory facts attached as the
    step's executable facts (the port compiles no executable); logs the
    per-stage seconds and the imbalance of every per-device metric.
    Returns the paths and the run summary."""
    tel = eng.telemetry
    if eng.device.type == "cuda":
        tel.attach_executable(
            "train_step" if eng.cfg.batching == "full_graph"
            else "minibatch_train_step",
            dict(max_memory_allocated=torch.cuda.max_memory_allocated(
                eng.device),
                memory_reserved=torch.cuda.memory_reserved(eng.device)))
    trace, steps = trace_paths(path, eng.rank)
    os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
    tel.write_chrome_trace(trace)
    tel.write_step_log(steps)
    summary = tel.run_summary()
    secs = summary["spans"]["seconds_by_name"]
    log.info("telemetry: %s", " ".join(f"{n}={s:.3f}s"
                                       for n, s in sorted(secs.items())))
    for name, rec in sorted(summary["imbalance"]["metrics"].items()):
        log.info("  imbalance %s: max/mean=%.2f", name, rec["max_over_mean"])
    log.info("  trace -> %s (%d spans), step log -> %s", trace,
             summary["spans"]["count"], steps)
    return dict(trace=trace, steps=steps, summary=summary)


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
    ap.add_argument("--batching", default="full_graph",
                    choices=list(BATCHING_MODES),
                    help="full_graph partition batches or sampled "
                         "mini-batches (the edge-cut family)")
    ap.add_argument("--batch-size", type=int, default=16,
                    help="per-rank mini-batch targets / walk roots")
    ap.add_argument("--fanouts", default=None,
                    help="node_wise: comma-separated fanouts, target layer "
                         "first (default 4 a layer)")
    ap.add_argument("--layer-sizes", default=None,
                    help="layer_wise: comma-separated sample sizes "
                         "(default 32 a layer)")
    ap.add_argument("--walk-length", type=int, default=4,
                    help="subgraph: random-walk length")
    ap.add_argument("--cache", default="none",
                    choices=list(ENGINE_CACHE_POLICIES),
                    help="the resident feature cache policy")
    ap.add_argument("--cache-capacity", type=int, default=0,
                    help="remote feature rows cached per rank")
    ap.add_argument("--schedule", default="conventional",
                    choices=list(SCHEDULE_CHOICES),
                    help="mini-batch stage schedule (survey §6.1); "
                         "pipelined runs the producer lane for real (prefetch "
                         "thread or sampling processes, steps dispatched "
                         "without a per-step sync)")
    ap.add_argument("--prefetch-mode", default="thread",
                    choices=list(PREFETCH_MODES),
                    help="pipelined schedule's producer: 'thread' shares "
                         "the trainer's GIL; 'process' runs sampling in a "
                         "pool of worker processes over a shared-memory "
                         "batch ring (/dev/shm must hold depth slots and "
                         "the graph's CSR)")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="pipelined schedule: batches built ahead of the "
                         "device step")
    ap.add_argument("--num-sample-workers", type=int, default=2,
                    help="worker processes for --prefetch-mode process")
    ap.add_argument("--oracle-check", action="store_true",
                    help="rerun on the single-device reference; fail past 1e-4")
    ap.add_argument("--infer", action="store_true",
                    help="run the layer-wise sweep at the final params and "
                         "check it against the reference sweep")
    ap.add_argument("--trace-out", default=None, metavar="t.json",
                    help="enable run-wide telemetry and write a Chrome "
                         "trace-event file here (open in Perfetto / "
                         "chrome://tracing) plus <t.json>.steps.jsonl; logs "
                         "per-stage seconds and per-device imbalance ratios")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    join_group(args)
    eng = None
    try:
        g = sbm_graph(args.vertices, num_blocks=8, p_in=0.05, p_out=0.003,
                      seed=0)
        eng = build_engine(args, g)
        log.info("engine: model=%s exec=%s protocol=%s family=%s rank %d of "
                 "k=%d (nb=%d, K=%d) on %s", args.model, args.exec,
                 args.protocol, args.partition_family, eng.rank, eng.k,
                 eng.nb, eng.K, eng.device)
        if args.trace_out:
            eng.enable_telemetry()
        if args.batching != "full_graph":
            out = run_minibatch(eng, args.epochs, schedule=args.schedule,
                                oracle_check=args.oracle_check,
                                infer=args.infer)
        else:
            out = run_training(eng, args.epochs,
                               oracle_check=args.oracle_check,
                               infer=args.infer)
        if args.trace_out:
            out["trace"] = write_trace(eng, args.trace_out)
        return out
    finally:
        if eng is not None:
            eng.close_prefetch_pool()
        leave_group(args)


if __name__ == "__main__":
    main()
