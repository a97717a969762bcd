"""Ablation (survey §7.2, Table 3): convergence against staleness bound
against communication, across the three staleness models, the port's copy
of `examples/staleness_ablation.py`: `full_graph_train` over sync and seven
(protocol, bound) rows on one 300-vertex community graph.

  PYTHONPATH=src python -m repro_torch.examples.staleness_ablation [--device cpu]

Runs on the card unless asked for the CPU; ``--epochs`` (the reference's
60 by default) cuts the run.  Returns the sync result and one
(protocol, bound, result) row each; a row's ``bytes_pushed`` is the
boundary rows its protocol refreshed, times the width, times 4 bytes.
"""
import argparse

from repro_torch.core import full_graph_train, sbm_graph

# (protocol, bound) rows, in the reference's order
ROWS = (
    ("epoch_fixed", dict(staleness=1)),
    ("epoch_fixed", dict(staleness=2)),
    ("epoch_fixed", dict(staleness=4)),
    ("epoch_fixed", dict(staleness=8)),
    ("epoch_adaptive", dict(staleness=4)),
    ("variation", dict(eps_v=0.01)),
    ("variation", dict(eps_v=0.1)),
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--epochs", type=int, default=60)
    args = ap.parse_args(argv)
    g = sbm_graph(300, num_blocks=4, p_in=0.08, p_out=0.004, seed=0)
    print(f"{'protocol':28s} {'test_acc':>8s} {'final_loss':>10s} {'MB pushed':>10s}")
    sync = full_graph_train(g, epochs=args.epochs, device=args.device)
    print(f"{'sync (baseline)':28s} {sync.test_acc:8.3f} {sync.losses[-1]:10.4f} "
          f"{'n/a':>10s}")
    rows = []
    for proto, kw in ROWS:
        r = full_graph_train(g, protocol=proto, epochs=args.epochs,
                             device=args.device, **kw)
        rows.append((proto, kw, r))
        print(f"{f'{proto}({kw})':28s} {r.test_acc:8.3f} {r.losses[-1]:10.4f} "
              f"{r.bytes_pushed / 1e6:10.2f}")
    print("\nexpected pattern (the survey's claim): small bounds track sync "
          "accuracy with fewer bytes; large bounds degrade accuracy.")
    return dict(sync=sync, rows=rows)


if __name__ == "__main__":
    main()
