"""GNN serving driver (the port's counterpart of `repro/launch/serve_gnn.py`):
the THROUGHPUT tier, ``DistGNNEngine.infer_full_graph``, one O(L)
layer-wise sweep that produces final-layer embeddings for EVERY vertex.

Params come from `init_gnn_params` (seeded, for the chosen model, the same
on every rank); the reference's ``--train-steps`` trains mini-batch and
arrives with the mini-batch slice, and the latency tier (`GNNQueryEngine`)
with a later one.  One process per rank (`launch/common.py`): without
``--init-method`` it runs alone.

    PYTHONPATH=src python -m repro_torch.launch.serve_gnn --oracle-check
    PYTHONPATH=src python -m repro_torch.launch.serve_gnn --device cpu
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

from repro_torch.core.engine import DistGNNEngine, EngineConfig
from repro_torch.core.graph import sbm_graph
from repro_torch.launch.common import (
    add_group_args,
    device_of,
    join_group,
    leave_group,
    partition_config,
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
    already be joined (`join_group`)."""
    cfg = EngineConfig(execution=args.exec, model=args.model,
                       **partition_config(args),
                       exchange_chunks=args.exchange_chunks,
                       hidden=args.hidden, num_layers=args.layers)
    return DistGNNEngine(g, cfg=cfg, device=device_of(args))


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
        params = init_gnn_params(args.model, eng.dims,
                                 torch.Generator().manual_seed(args.seed),
                                 eng.device)
        return run_sweep(eng, params, oracle_check=args.oracle_check)
    finally:
        leave_group(args)


if __name__ == "__main__":
    main()
