"""Quickstart: the survey's pipeline end to end on one machine (the port's
copy of `examples/quickstart.py`).

1. Build a synthetic community graph.
2. Partition it with the GNN-aware streaming partitioner (survey §4.2).
3. Train a GCN full-graph with the sync protocol, then with bounded-staleness
   historical embeddings (§7.2), and compare accuracy + bytes pushed.
4. Train a transformer smoke config for a few steps with the same framework
   (`launch/train.run_training`).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

from repro_torch.core import full_graph_train, sbm_graph
from repro_torch.core.partition import PARTITIONERS


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    out = {}
    print("== 1. data ==")
    g = sbm_graph(300, num_blocks=4, p_in=0.08, p_out=0.004, seed=0)
    print(f"graph: {g.num_vertices} vertices, {g.num_edges} edges")

    print("== 2. partition (survey §4.2) ==")
    for name in ("hash", "ldg", "metis_like"):
        part = PARTITIONERS[name](g, 4)
        print(f"  {name:12s} edge-cut={part.edge_cut_fraction(g):.3f} "
              f"balance={part.vertex_balance():.2f}")

    print("== 3. full-graph GNN training: sync vs bounded staleness (§6/§7) ==")
    sync = full_graph_train(g, epochs=60, device=args.device)
    out["sync"] = sync.test_acc
    print(f"  sync         test_acc={sync.test_acc:.3f}")
    for proto, kw in (("epoch_fixed", dict(staleness=2)),
                      ("variation", dict(eps_v=0.05))):
        r = full_graph_train(g, protocol=proto, epochs=60, device=args.device, **kw)
        out[proto] = r.test_acc
        print(f"  {proto:12s} test_acc={r.test_acc:.3f} "
              f"bytes_pushed={r.bytes_pushed / 1e6:.2f}MB")

    print("== 4. transformer smoke training (shared substrate) ==")
    from repro_torch.launch.train import run_training

    losses = run_training("llama3.2-1b", steps=20, batch=4, seq=64, log_every=10,
                          device=args.device)
    out["llm_losses"] = losses
    print(f"  llama3.2-1b smoke: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    print("done.")
    return out


if __name__ == "__main__":
    main()
