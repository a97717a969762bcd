"""A torchrun-style launcher for `launch/train_gnn.py`: one process a rank,
the rendezvous read from the environment torchrun sets (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) or given as
``--init-method``; every other option is `train_gnn`'s, engine path
(``--exec p2p|broadcast|ring``, the protocols, the partition families, the
mini-batch modes) or legacy path (``--no-engine --exec spmm_1d|...``).

    # four gloo ranks on the CPU
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.examples.train_gnn_distributed \\
        --device cpu --exec p2p --oracle-check
    # or by hand, one shell a rank r = 0..3
    RANK=r WORLD_SIZE=4 MASTER_ADDR=localhost MASTER_PORT=29511 PYTHONPATH=src \\
        python -m repro_torch.examples.train_gnn_distributed --device cpu --oracle-check
    # one card, no group
    PYTHONPATH=src python -m repro_torch.examples.train_gnn_distributed

Without those variables and without ``--init-method`` the process runs
alone.  On the card rank r takes ``cuda:<r>`` (the launcher's ranks share
one host).
"""
import argparse
import os

from repro_torch.launch import train_gnn


def rendezvous(env=None, init_method=None) -> list:
    """`train_gnn`'s group options from ``init_method`` or torchrun's
    environment: [] for a process alone."""
    env = os.environ if env is None else env
    world, rank = int(env.get("WORLD_SIZE", "1")), int(env.get("RANK", "0"))
    if init_method is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if init_method is None:
        if world != 1:
            raise ValueError(f"WORLD_SIZE {world} needs MASTER_ADDR and "
                             "MASTER_PORT or --init-method")
        return []
    return ["--world-size", str(world), "--rank", str(rank),
            "--init-method", init_method]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--init-method", default=None,
                    help="the rendezvous (tcp://<host>:<port> or "
                         "file://<path>); default: torchrun's environment")
    args, rest = ap.parse_known_args(argv)
    return train_gnn.main([*rest, *rendezvous(init_method=args.init_method)])


if __name__ == "__main__":
    main()
