"""The partition families' wire bytes (the layout-and-bytes half of
`repro/launch/dryrun_gnn.py`): `bench_partition_families` writes
``BENCH_partition_families.json`` under ``--out``, the per-step bytes of
the survey's §4 families from the port's standalone cost models
(`core/partition/cost_models.py`) over its layouts (`HybridLayout`,
`build_vertex_layout`, `PARTITIONERS`, `VERTEX_CUTS`): the same graphs,
chip counts, thresholds, built-in cross-check and two assertions as the
reference's, so its numbers equal the reference's entry for entry.  All
host work (numpy); nothing runs on a device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_gnn --bench-partition-families --out /tmp/d

Left out, with no torch meaning: the compile half (the reference lowers
the full-graph GCN step onto the 256- and 512-chip production meshes and
reads the compiled HLO's memory, cost and collective bytes) and
``--autotune`` (its validation runs two engine steps on 8 forced host
devices in one process; the port's `autotune` validates at k ranks of a
process group, and waits in ROADMAP.md).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from repro_torch.configs.gcn_paper import CONFIG as GNN_CFG
from repro_torch.utils import get_logger

log = get_logger("repro_torch.dryrun_gnn")


def _partition_families_entry(g, gname, chips, dims):
    """One BENCH_partition_families config row: edge-cut (metis_like /
    hash) against vertex-cut (random / cartesian2d / libra) against the
    hybrid degree-threshold sweep ({p90, p95, p99, inf} over metis_like
    masters), total and bottleneck bytes from the standalone cost models."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.partition.cost_models import (
        edge_cut_halo_bytes_per_step,
        edge_cut_halo_device_bytes,
        hybrid_bytes_per_step,
        replica_sync_bytes_per_step,
        replica_sync_device_bytes,
    )
    from repro_torch.core.partition.edge_cut import PARTITIONERS
    from repro_torch.core.partition.hybrid_cut import HybridLayout
    from repro_torch.core.partition.vertex_cut import VERTEX_CUTS
    from repro_torch.core.partition.vertex_layout import build_vertex_layout

    deg = g.degree().astype(np.float64)
    thresholds = dict(p90=float(np.percentile(deg, 90)),
                      p95=float(np.percentile(deg, 95)),
                      p99=float(np.percentile(deg, 99)), inf=np.inf)
    entry = dict(graph=gname, chips=chips, vertices=g.num_vertices,
                 edge_cut={}, vertex_cut={}, hybrid={})
    for pname in ("metis_like", "hash"):
        part = PARTITIONERS[pname](g, chips)
        dev = edge_cut_halo_device_bytes(g, part, dims)
        entry["edge_cut"][pname] = dict(
            total_bytes=edge_cut_halo_bytes_per_step(g, part, dims),
            bottleneck_bytes=int(dev.max()),
            vertex_balance=part.vertex_balance())
    for vname in VERTEX_CUTS:
        vc = VERTEX_CUTS[vname](g, chips)
        lay = build_vertex_layout(g, vc, chips)
        dev = replica_sync_device_bytes(lay, vc.masters, dims)
        entry["vertex_cut"][vname] = dict(
            replication_factor=lay.replication_factor(),
            total_bytes=replica_sync_bytes_per_step(
                lay.rep_count, chips, lay.nv, "p2p", dims),
            bottleneck_bytes=int(dev.max()))
    for tname, thr in thresholds.items():
        lay = HybridLayout(g, chips, EngineConfig(
            partition_family="hybrid", hub_threshold=thr, execution="p2p"))
        dev = lay.device_bytes_per_step("gcn", dims)
        entry["hybrid"][tname] = dict(
            threshold=thr, num_hubs=int(lay.cut.hub.sum()),
            total_bytes=hybrid_bytes_per_step(
                lay.halo_rows_exec if lay.halo_active else 0,
                lay._vc_rows_per_layer if lay.sync_active else 0, dims),
            bottleneck_bytes=int(dev.max()))
    # built-in cross-check: threshold inf IS the edge-cut dataflow over the
    # same metis_like masters, so the two accountings must agree
    assert (entry["hybrid"]["inf"]["bottleneck_bytes"]
            == entry["edge_cut"]["metis_like"]["bottleneck_bytes"]), entry
    ec = min(v["bottleneck_bytes"] for v in entry["edge_cut"].values())
    vc = min(v["bottleneck_bytes"] for v in entry["vertex_cut"].values())
    hy = min(v["bottleneck_bytes"] for v in entry["hybrid"].values())
    entry["best_edge_cut_bottleneck"] = ec
    entry["best_vertex_cut_bottleneck"] = vc
    entry["best_hybrid_bottleneck"] = hy
    entry["vertex_cut_wins_bottleneck"] = vc < ec
    entry["hybrid_wins_bottleneck"] = hy <= min(ec, vc)
    log.info("%s V=%d %d chips: bottleneck edge-cut %.3f MB vs vertex-cut "
             "%.3f MB vs hybrid %.3f MB (%s)", gname, g.num_vertices, chips,
             ec / 1e6, vc / 1e6, hy / 1e6,
             "hybrid wins" if hy <= min(ec, vc)
             else ("vertex-cut wins" if vc < ec else "edge-cut wins"))
    return entry


def bench_partition_families(out_dir, dims, vertices=2048):
    """Write BENCH_partition_families.json under ``out_dir``: per-step wire
    bytes of the §4 partition families (edge-cut halo exchange, vertex-cut
    replica sync with p2p GAS accounting, the hybrid threshold sweep) on
    {uniform, power-law} graphs of min(vertices, 2048) vertices at {8, 64,
    256} chips, plus one double-size power-law point at 256 chips.
    ``total_bytes`` is every row that crosses the wire a step,
    ``bottleneck_bytes`` the largest per-device (send + recv) bytes.  The
    reference's two claims are asserted after the file is written: at the
    base power-law 256-chip point the best vertex cut beats the best edge
    cut, and at the double-size point the best hybrid threshold beats both
    pure families.  Returns the file's path."""
    from repro_torch.core.graph import er_graph, powerlaw_graph

    V = min(vertices, 2048)
    result = dict(vertices=V, avg_degree=16, dims=dims, configs=[])
    for gname, gfn in (("uniform", er_graph), ("power_law", powerlaw_graph)):
        g = gfn(V, avg_degree=16, seed=0)
        for chips in (8, 64, 256):
            result["configs"].append(
                _partition_families_entry(g, gname, chips, dims))
    # the hybrid regime point: double the vertices at the most chips
    g2 = powerlaw_graph(2 * V, avg_degree=16, seed=0)
    hyb = _partition_families_entry(g2, "power_law", 256, dims)
    result["configs"].append(hyb)
    # the file before the assertions: a failed claim leaves the per-config
    # bytes behind
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "BENCH_partition_families.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=float)
    log.info("OK partition-families bench -> %s", path)
    plaw = [e for e in result["configs"]
            if e["graph"] == "power_law" and e["chips"] == 256
            and e["vertices"] == V][0]
    assert plaw["vertex_cut_wins_bottleneck"], (
        "vertex-cut must beat edge-cut critical-path comm volume on the "
        f"power-law 256-chip config: {plaw}")
    assert hyb["hybrid_wins_bottleneck"], (
        "the best hybrid threshold must beat BOTH pure families' "
        "critical-path comm volume on the double-size power-law 256-chip "
        f"config: {hyb}")
    return path


def gcn_dims(cfg=GNN_CFG) -> list:
    """The gcn-paper layer widths: [features, hidden x (layers - 1),
    classes]."""
    return ([cfg.feature_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
            + [cfg.num_classes])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bench-partition-families", action="store_true",
                    help="write BENCH_partition_families.json (edge-cut halo "
                         "vs vertex-cut replica sync vs the hybrid threshold "
                         "sweep across graphs x chips)")
    ap.add_argument("--engine-vertices", type=int, default=1 << 14,
                    help="the graphs' vertices (capped at 2048, as the "
                         "reference caps them)")
    ap.add_argument("--out", required=True,
                    help="the folder the JSON file is written to")
    args = ap.parse_args(argv)
    if not args.bench_partition_families:
        ap.error("the port's dry run has the partition-families bench only "
                 "(--bench-partition-families): the compile half has no "
                 "torch meaning")
    return bench_partition_families(args.out, gcn_dims(),
                                    vertices=args.engine_vertices)


if __name__ == "__main__":
    main()
