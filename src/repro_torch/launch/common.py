"""What the GNN entry points share: the process-group options, the partition
options and the device each rank runs on.

One process per rank.  ``--world-size``, ``--rank`` and ``--init-method``
(``file://<path>`` or ``tcp://<host>:<port>``) join the process group before
the engine is built; the engine then runs on every rank of it.  Without
``--init-method`` the process runs alone, with no group.  The device is
``cuda:<rank>`` unless the caller asks for another (``--device cpu``), and
the backend follows it: NCCL on the card, gloo on the CPU.
``--partition-family`` picks edge_cut (``--partitioner``, or the reference
driver's ``--partition``), vertex_cut
(``--vertex-cut``) or hybrid (``--partitioner`` for the masters,
``--hub-threshold`` for the hubs), with the reference's defaults.

    # four gloo ranks on the CPU, one per shell:
    PYTHONPATH=src python -m repro_torch.launch.train_gnn --device cpu \\
        --world-size 4 --rank 0 --init-method file:///tmp/rdv --oracle-check
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.engine import EngineConfig
from repro_torch.core.execution import collectives
from repro_torch.core.engine import PARTITION_FAMILIES
from repro_torch.core.partition.edge_cut import PARTITIONERS
from repro_torch.core.partition.vertex_cut import VERTEX_CUTS


def add_group_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--world-size", type=int, default=1,
                    help="ranks of the process group (one process each)")
    ap.add_argument("--rank", type=int, default=0,
                    help="this process's rank in [0, world size)")
    ap.add_argument("--init-method", default=None,
                    help="the group's rendezvous, file://<path> or "
                         "tcp://<host>:<port>; none: run alone, no group")
    ap.add_argument("--partitioner", "--partition", dest="partitioner",
                    default=EngineConfig.partitioner,
                    choices=list(PARTITIONERS),
                    help="the edge-cut partitioner that assigns vertices to "
                         "ranks, the hybrid family's masters too (metis_like "
                         "is a host loop: pass hash on graphs of millions of "
                         "vertices); --partition is the reference driver's "
                         "name for it")
    ap.add_argument("--partition-family", default=EngineConfig.partition_family,
                    choices=list(PARTITION_FAMILIES),
                    help="edge-cut halo exchange, vertex-cut replica sync "
                         "(replicated vertices, master-masked loss), or the "
                         "PowerLyra-style hybrid degree-threshold cut (hubs "
                         "replicate, the rest stay edge-cut-local)")
    ap.add_argument("--vertex-cut", default=EngineConfig.vertex_cut,
                    choices=list(VERTEX_CUTS),
                    help="the vertex cut (with --partition-family "
                         "vertex_cut; libra is a host loop over every edge)")
    ap.add_argument("--hub-threshold", type=float,
                    default=EngineConfig.hub_threshold,
                    help="hybrid: in-degree at/above which a vertex is a "
                         "replicated hub (default: the 95th percentile; inf "
                         "-> pure edge-cut dataflow, 0 -> pure vertex cut)")


def partition_config(args) -> dict:
    """The EngineConfig fields the partition options set."""
    return dict(partition_family=args.partition_family,
                partitioner=args.partitioner, vertex_cut=args.vertex_cut,
                hub_threshold=args.hub_threshold)


def per_layer(arg, default: int, layers: int) -> tuple:
    """A comma-separated per-layer option (``--fanouts``, ``--layer-sizes``)
    as a tuple; ``default`` a layer when not given (the reference's "4,4"
    and "32,32" at its two layers)."""
    if arg is None:
        return (default,) * layers
    return tuple(int(x) for x in arg.split(","))


def check_parts(args) -> int:
    """The world size of the joined group (1 without one), which ``--parts``
    must name: 0 (the default) means the world size, as the reference's 0
    means every device; any other value that is not it raises."""
    k = collectives.world_size()
    if args.parts not in (0, k):
        raise ValueError(f"--parts {args.parts} does not match the process "
                         f"group's {k} rank(s): one partition a rank (0 = the "
                         "world size)")
    return k


def device_of(args) -> torch.device:
    """``cuda:<rank>`` for ``--device cuda`` (the default), else the device
    asked for."""
    if args.device == "cuda":
        return torch.device("cuda", args.rank)
    return torch.device(args.device)


def join_group(args) -> None:
    """Join the process group the options name; without ``--init-method``
    only a world of one rank may run."""
    if args.init_method is None:
        if args.world_size != 1 or args.rank != 0:
            raise ValueError("--world-size and --rank need --init-method")
        return
    collectives.init_group(args.init_method, args.world_size, args.rank,
                           device_of(args))


def leave_group(args) -> None:
    if args.init_method is not None:
        collectives.destroy_group()
