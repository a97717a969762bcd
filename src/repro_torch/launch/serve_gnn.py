"""GNN serving driver (the port's counterpart of `repro/launch/serve_gnn.py`):
the two inference tiers over a trained engine.

* THROUGHPUT: ``DistGNNEngine.infer_full_graph``, one O(L) layer-wise sweep
  that produces final-layer embeddings for EVERY vertex (`run_sweep`).
* LATENCY: ``GNNQueryEngine`` (`core/serving.py`), a persistent K-target
  query server on the padded node-wise sampler path: static round shapes,
  request coalescing, the resident feature cache as the hot set.
  `run_query_stream` reports qps and p50/p99 per-query latency over a
  seeded stream of ``--queries`` queries of ``--targets-per-query``
  targets (the edge-cut family; the replica families have no mini-batch
  path and skip it).

As in the reference, the params come from ``--train-steps`` steps of
training first: the edge-cut engine is a node_wise mini-batch engine
(``--batch-size``, ``--fanouts``, the static feature cache ``--cache`` /
``--cache-capacity``) trained by `run_epoch_minibatch`; the replica
families train full-graph steps.  ``--train-steps 0`` sweeps the seeded
initial params (`init_gnn_params`, the same on every rank).  One process
per rank (`launch/common.py`): without ``--init-method`` it runs alone;
over k ranks every rank draws the same query stream and answers it.

    PYTHONPATH=src python -m repro_torch.launch.serve_gnn --oracle-check
    PYTHONPATH=src python -m repro_torch.launch.serve_gnn --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_gnn --device cpu --train-steps 3 --cache none
    PYTHONPATH=src python -m repro_torch.launch.serve_gnn --device cpu --queries 64 --targets-per-query 8
    PYTHONPATH=src python -m repro_torch.launch.serve_gnn --model gat --device cpu --oracle-check
    PYTHONPATH=src python -m repro_torch.launch.serve_gnn --device cpu --partition-family vertex_cut --vertex-cut libra --oracle-check
    # rank r of 4 gloo ranks on the CPU (start r = 0, 1, 2, 3 together):
    PYTHONPATH=src python -m repro_torch.launch.serve_gnn --device cpu \
        --world-size 4 --rank r --init-method file:///tmp/rdv --oracle-check
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.engine import (
    ENGINE_CACHE_POLICIES,
    DistGNNEngine,
    EngineConfig,
)
from repro_torch.core.graph import sbm_graph
from repro_torch.core.serving import GNNQueryEngine
from repro_torch.launch.common import (
    add_group_args,
    device_of,
    join_group,
    leave_group,
    partition_config,
    per_layer,
)
from repro_torch.core.models.gnn import init_gnn_params
from repro_torch.utils import get_logger

log = get_logger("repro_torch.serve_gnn")

# what the port runs today; the rest of the reference's choices arrive with
# later slices
PORTED_EXECUTION_MODELS = ("p2p", "broadcast", "ring")
PORTED_GNN_MODELS = ("gcn", "sage", "gat", "gin")


def build_engine(args, g):
    """The engine on this rank's device; the process group, if any, must
    already be joined (`join_group`).  The edge-cut family serves from a
    node_wise mini-batch engine (its training mode; the sweep runs the
    full-graph exchange either way), the replica families from a
    full-graph one, as in the reference."""
    edge = args.partition_family == "edge_cut"
    cfg = EngineConfig(execution=args.exec, model=args.model,
                       **partition_config(args),
                       exchange_chunks=args.exchange_chunks,
                       hidden=args.hidden, num_layers=args.layers,
                       seed=args.seed,
                       batching="node_wise" if edge else "full_graph",
                       batch_size=args.batch_size,
                       fanouts=per_layer(args.fanouts, 4, args.layers),
                       cache_policy=args.cache if edge else "none",
                       cache_capacity=args.cache_capacity if edge else 0)
    return DistGNNEngine(g, cfg=cfg, device=device_of(args))


def train_params(eng, steps: int) -> dict:
    """The params to serve: ``steps`` training steps from the engine's
    initial state (mini-batch steps through `run_epoch_minibatch` on a
    mini-batch engine, full-graph steps otherwise), or with no step the
    initial params themselves.  Returns the params and the losses."""
    if steps <= 0:
        return dict(params=init_gnn_params(
            eng.cfg.model, eng.dims,
            torch.Generator().manual_seed(eng.cfg.seed), eng.device),
            losses=[])
    if eng.cfg.batching != "full_graph":
        state, losses, _ = eng.run_epoch_minibatch(steps)
    else:
        step, state, losses = eng.make_step(), eng.init_state(), []
        for _ in range(steps):
            state, metrics, _ = step(state)
            losses.append(float(metrics["loss"]))
    log.info("trained %d %s steps: loss %.4f -> %.4f", steps,
             eng.cfg.batching, losses[0], losses[-1])
    return dict(params=state["params"], losses=losses)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_sweep(eng, params, *, oracle_check=False):
    """Throughput tier: one timed layer-wise full-graph sweep.  Returns the
    embeddings of every vertex in original vertex order (host numpy, on
    every rank) and the wall seconds (the sweep ends in a device
    synchronize)."""
    _sync(eng.device)
    t0 = time.perf_counter()
    H = eng.infer_full_graph(params=params)
    _sync(eng.device)
    wall = time.perf_counter() - t0
    emb = eng.global_embeddings(H)
    bytes_model = eng.inference_bytes_per_sweep()
    log.info("layer-wise sweep on %s: %d vertices -> [%d, %d] embeddings in "
             "%.3fs (%.3f MB/sweep on the wire, CommStats.inference_bytes="
             "%.3f MB)", eng.device, eng.g.num_vertices, emb.shape[0],
             emb.shape[1], wall, bytes_model / 1e6,
             eng.comm_stats.inference_bytes / 1e6)
    if oracle_check:
        ref = eng.global_embeddings(eng.infer_full_graph(params=params,
                                                         reference=True))
        err = float(np.max(np.abs(emb - ref)))
        log.info("sweep oracle gap (max |sweep - ref|) = %.2e", err)
        if not err <= 1e-4:
            raise RuntimeError(f"sweep diverged from reference: {err}")
    return emb, wall


def run_query_stream(qe, *, num_queries, targets_per_query, seed=0):
    """Latency tier: a warm-up query, then a stream of ``num_queries``
    single-request queries of ``targets_per_query`` distinct targets drawn
    from a generator seeded with ``seed`` (the same stream on every rank),
    through the query engine; coalescing is exercised by the query tier.
    Every round must have had one shape signature.  Returns the stats."""
    rng = np.random.default_rng(seed)
    V = qe.engine.g.num_vertices
    qe.query(rng.choice(V, size=targets_per_query, replace=False))  # warmup
    qe.stats.latencies_s.clear()
    qe.stats.queries = 0
    for _ in range(num_queries):
        qe.query(rng.choice(V, size=targets_per_query, replace=False))
    s = qe.stats
    log.info("query stream: %d queries x %d targets -> %.1f qps, "
             "p50=%.2fms p99=%.2fms (%d serve rounds, %d round shapes)",
             num_queries, targets_per_query, s.qps(),
             s.percentile_ms(50), s.percentile_ms(99), s.rounds,
             qe.round_shapes())
    if qe.round_shapes() != 1:
        raise RuntimeError(f"serve rounds took {qe.round_shapes()} shape "
                           "signatures, not one")
    return s


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device the sweep runs on (cpu only when asked)")
    ap.add_argument("--exec", default=EngineConfig.execution,
                    choices=list(PORTED_EXECUTION_MODELS))
    add_group_args(ap)
    ap.add_argument("--model", default="gcn", choices=list(PORTED_GNN_MODELS))
    ap.add_argument("--exchange-chunks", type=int, default=1)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vertices", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0, help="params generator seed")
    ap.add_argument("--train-steps", type=int, default=10,
                    help="training steps before the sweep (node_wise "
                         "mini-batch steps on the edge-cut engine); 0 sweeps "
                         "the initial params")
    ap.add_argument("--batch-size", type=int, default=16,
                    help="per-rank mini-batch targets")
    ap.add_argument("--fanouts", default=None,
                    help="comma-separated node_wise fanouts, target layer "
                         "first (default 4 a layer)")
    ap.add_argument("--cache", default="static_degree",
                    choices=list(ENGINE_CACHE_POLICIES),
                    help="the mini-batch engine's resident feature cache")
    ap.add_argument("--cache-capacity", type=int, default=32,
                    help="remote feature rows cached per rank")
    ap.add_argument("--queries", type=int, default=16,
                    help="latency tier: queries in the stream (node_wise "
                         "engines; 0 skips it)")
    ap.add_argument("--targets-per-query", type=int, default=8)
    ap.add_argument("--oracle-check", action="store_true")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    join_group(args)
    try:
        g = sbm_graph(args.vertices, num_blocks=8, p_in=0.05, p_out=0.003,
                      seed=0)
        eng = build_engine(args, g)
        log.info("engine: model=%s exec=%s family=%s rank %d of k=%d (nb=%d, "
                 "K=%d) on %s", args.model, args.exec, args.partition_family,
                 eng.rank, eng.k, eng.nb, eng.K, eng.device)
        params = train_params(eng, args.train_steps)["params"]
        swept = run_sweep(eng, params, oracle_check=args.oracle_check)
        if eng.cfg.batching != "node_wise":
            log.info("query tier skipped: the replica families have no "
                     "mini-batch path (the latency tier is edge-cut)")
        elif args.queries > 0:
            run_query_stream(GNNQueryEngine(eng, params),
                             num_queries=args.queries,
                             targets_per_query=args.targets_per_query)
        return swept
    finally:
        leave_group(args)


if __name__ == "__main__":
    main()
