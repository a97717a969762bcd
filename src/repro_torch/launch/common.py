"""What the GNN entry points share: the process-group options and the device
each rank runs on.

One process per rank.  ``--world-size``, ``--rank`` and ``--init-method``
(``file://<path>`` or ``tcp://<host>:<port>``) join the process group before
the engine is built; the engine then runs on every rank of it.  Without
``--init-method`` the process runs alone, with no group.  The device is
``cuda:<rank>`` unless the caller asks for another (``--device cpu``), and
the backend follows it: NCCL on the card, gloo on the CPU.

    # four gloo ranks on the CPU, one per shell:
    PYTHONPATH=src python -m repro_torch.launch.train_gnn --device cpu \\
        --world-size 4 --rank 0 --init-method file:///tmp/rdv --oracle-check
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.execution import collectives
from repro_torch.core.partition.edge_cut import PARTITIONERS


def add_group_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--world-size", type=int, default=1,
                    help="ranks of the process group (one process each)")
    ap.add_argument("--rank", type=int, default=0,
                    help="this process's rank in [0, world size)")
    ap.add_argument("--init-method", default=None,
                    help="the group's rendezvous, file://<path> or "
                         "tcp://<host>:<port>; none: run alone, no group")
    ap.add_argument("--partitioner", default="hash", choices=list(PARTITIONERS),
                    help="the edge-cut partitioner that assigns vertices to "
                         "ranks")


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
