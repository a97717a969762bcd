"""The port's host layer against the reference: synthetic graphs bitwise
equal for one seed, every partitioner's assignment and quality metrics
equal, the bucketing helpers equal, and the vectorised edge-cut layout build
array-for-array equal to the reference's loop build (labels and loss
weights included; the p2p plan at 1, 2 and 4 buckets; the ring plan and the
boundary mask at k = 1, 3 and 4), at k = 1 and k = 4 (numpy build only).
The replica families likewise: the three vertex cuts assignment for
assignment, the replica layout and the replica-sync plan of every execution
model array for array, the hybrid layout and its halo tables at four hub
thresholds, and the vertex-cut and hybrid cost models number for number."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import utils as jutils
from repro.configs import gcn_paper as jgcn_paper
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.execution import bucketing as jbucketing
from repro.core.feature_store import FeatureStore as JFeatureStore
from repro.core.graph import er_graph as jer_graph, sbm_graph as jsbm_graph
from repro.core.partition import cost_models as jcost
from repro.core.partition import edge_cut as jedge_cut
from repro.core.partition.edge_cut import PARTITIONERS as JPARTITIONERS
from repro.core.execution import replica_sync as jreplica_sync
from repro.core.partition import hybrid_cut as jhybrid_cut
from repro.core.partition import vertex_cut as jvertex_cut
from repro.core.partition import vertex_layout as jvertex_layout
from repro.core.partition.layout_api import EdgeCutLayout as JEdgeCutLayout
from repro.core.partition.layout_api import (
    VertexCutFamilyLayout as JVertexCutFamilyLayout,
)
from repro_torch import utils
from repro_torch.configs import gcn_paper
from repro_torch.core.engine import EngineConfig
from repro_torch.core.execution import bucketing
from repro_torch.core.feature_store import FeatureStore
from repro_torch.core.graph import er_graph, sbm_graph
from repro_torch.core.partition import cost_models, edge_cut
from repro_torch.core.partition.edge_cut import PARTITIONERS
from repro_torch.core.execution import replica_sync
from repro_torch.core.partition import hybrid_cut, vertex_cut, vertex_layout
from repro_torch.core.partition.layout_api import (
    EdgeCutLayout,
    VertexCutFamilyLayout,
    get_layout_builder,
)

GRAPHS = {
    "er": (er_graph, jer_graph,
           dict(num_vertices=300, avg_degree=3, feature_dim=12,
                num_classes=5, seed=3)),
    "sbm": (sbm_graph, jsbm_graph,
            dict(num_vertices=96, num_blocks=4, p_in=0.1, p_out=0.01,
                 feature_dim=8, seed=0)),
}
GRAPH_FIELDS = ("indptr", "indices", "features", "labels", "train_mask",
                "val_mask", "test_mask")


def test_config_and_utils_copies_equal():
    for ours, theirs in ((gcn_paper.CONFIG, jgcn_paper.CONFIG),
                         (gcn_paper.smoke_config(), jgcn_paper.smoke_config())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for a in (0, 1, 127, 128, 129):
        assert utils.round_up(a, 128) == jutils.round_up(a, 128)
        assert utils.cdiv(a, 7) == jutils.cdiv(a, 7)


def _graphs(name):
    make, jmake, kw = GRAPHS[name]
    return make(**kw), jmake(**kw)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_generators_bitwise_equal(name):
    g, jg = _graphs(name)
    assert g.num_vertices == jg.num_vertices
    for field in GRAPH_FIELDS:
        a, b = getattr(g, field), getattr(jg, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


@pytest.mark.parametrize("partitioner", ["hash", "range", "ldg", "pagraph",
                                         "block", "bytegnn", "metis_like"])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_partitioners_equal(partitioner, k):
    """Every partitioner gives the reference's assignment, on the er graph
    (300 vertices: metis_like coarsens once) and the sbm graph, with the
    same quality metrics (the port's vectorised, the reference's loops)."""
    assert sorted(PARTITIONERS) == sorted(JPARTITIONERS)
    for name in sorted(GRAPHS):
        g, jg = _graphs(name)
        part = PARTITIONERS[partitioner](g, k)
        jpart = JPARTITIONERS[partitioner](jg, k)
        a, b = part.assignment, jpart.assignment
        assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert part.communication_volume(g) == jpart.communication_volume(jg)
        assert part.edge_cut_fraction(g) == jpart.edge_cut_fraction(jg)
        assert (part.vertex_balance(), part.train_balance(g)) == (
            jpart.vertex_balance(), jpart.train_balance(jg))
        for i in range(k):
            ours, theirs = part.boundary_vertices(g, i), jpart.boundary_vertices(
                jg, i)
            assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
        assert all(np.array_equal(x, y) for x, y in zip(part.parts(),
                                                         jpart.parts()))


def test_range_partition_by_cost_and_scores_equal():
    g, jg = _graphs("er")
    cost = g.degree().astype(np.float64) + 1.0
    for k in (1, 3, 4):
        assert np.array_equal(
            edge_cut.range_partition_by_cost(g, k, cost).assignment,
            jedge_cut.range_partition_by_cost(jg, k, cost).assignment)
    rng = np.random.default_rng(0)
    sets = [set(rng.choice(300, 20).tolist()) for _ in range(4)]
    nbrs, sizes = rng.choice(300, 30), np.array([5.0, 0.0, 9.0, 3.0])
    counts = np.array([1.0, 4.0, 0.0, 2.0])
    assert np.array_equal(cost_models.pagraph_score(nbrs, sets, sizes, 2.5),
                          jcost.pagraph_score(nbrs, sets, sizes, 2.5))
    assert np.array_equal(
        cost_models.bgl_score(nbrs, sets, sizes, counts, 6.0, 2.0),
        jcost.bgl_score(nbrs, sets, sizes, counts, 6.0, 2.0))
    args = (counts, sizes, counts[::-1], counts + 1, sizes / 2, (3.0, 0.5, 2.0))
    assert np.array_equal(cost_models.bytegnn_score(*args),
                          jcost.bytegnn_score(*args))


def test_bucketing_helpers_equal():
    for cap in (0, 1, 2, 3, 5, 8, 13, 34, 48, 100):
        for buckets in (1, 2, 3, 4, 8):
            assert (bucketing.bucketed_cap_widths(cap, buckets)
                    == jbucketing.bucketed_cap_widths(cap, buckets))
    t, s = np.arange(40) % 13, np.arange(40) % 4
    for width, k, base in ((13, 4, 7), (4, 4, 0), (1, 3, 5)):
        assert np.array_equal(bucketing.halo_slot(t, s, width, k, base),
                              jbucketing.halo_slot(t, s, width, k, base))
    rng = np.random.default_rng(1)
    need = [[np.sort(rng.choice(50, int(rng.integers(0, 9)), replace=False))
             for _ in range(3)] for _ in range(3)]
    for widths in ([8], [4, 4], [2, 2, 2, 2]):
        ours = bucketing.bucketed_send_table(need, 3, widths)
        theirs = jbucketing.bucketed_send_table(need, 3, widths)
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


@pytest.mark.parametrize("partitioner", ["hash", "range"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_edge_cut_layout_equal(name, k, partitioner):
    g, jg = _graphs(name)
    lay = EdgeCutLayout(g, k, EngineConfig(execution="broadcast",
                                           partitioner=partitioner))
    jlay = JEdgeCutLayout(jg, k, JEngineConfig(execution="broadcast",
                                               partitioner=partitioner))
    assert (lay.nb, lay.Vp, lay.K) == (jlay.nb, jlay.Vp, jlay.K)
    for ours, theirs in ((lay.new_of_old, jlay.new_of_old),
                         (lay.ids_global, jlay.ids_global),
                         (lay.mask, np.asarray(jlay.mask)),
                         (lay.deg, np.asarray(jlay.deg)),
                         (lay.X.numpy(), np.asarray(jlay.X)),
                         (lay.ids_exec, np.asarray(jlay.ids_exec)),
                         (lay.y, np.asarray(jlay.y)),
                         (lay.train_w, np.asarray(jlay.train_w)),
                         (lay.test_w, np.asarray(jlay.test_w))):
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    for model, dims in (("gcn", [12, 8, 5]), ("gat", [12, 8, 8, 5])):
        assert (lay.wire_fields_per_step(model, dims)
                == jlay.wire_fields_per_step(model, dims))
    H = np.random.default_rng(0).standard_normal((lay.Vp, 4)).astype(np.float32)
    assert np.array_equal(lay.global_embeddings(H), jlay.global_embeddings(H))


@pytest.mark.parametrize("buckets", [1, 2, 4])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_p2p_layout_equal(name, k, buckets):
    """The p2p plan, vectorised, against the reference's loops: the cap,
    the installment widths, the [k, B, k, w] send table, the ids remapped
    into [own | halo | zero], the halo rows (the partition's communication
    volume) and the wire bytes; the send mask marks each pair's need rows."""
    g, jg = _graphs(name)
    lay = EdgeCutLayout(g, k, EngineConfig(p2p_buckets=buckets))
    jlay = JEdgeCutLayout(jg, k, JEngineConfig(execution="p2p",
                                               partitioner="metis_like",
                                               p2p_buckets=buckets))
    assert (lay.cap, lay.p2p_widths, lay._halo_rows) == (
        jlay.cap, jlay.p2p_widths, jlay._halo_rows)
    assert lay._halo_rows == lay.part.communication_volume(g)
    for ours, theirs in ((lay.send_rows, np.asarray(jlay.send_rows)),
                         (lay.ids_exec, np.asarray(jlay.ids_exec)),
                         (lay.ids_global, jlay.ids_global),
                         (lay.mask, np.asarray(jlay.mask))):
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    B, w = len(lay.p2p_widths), lay.p2p_widths[0]
    assert lay.table_rows == lay.nb + B * k * w + 1
    assert lay.send_mask.shape == lay.send_rows.shape
    assert int(lay.send_mask.sum()) == lay._halo_rows
    assert not lay.send_rows[lay.send_mask == 0].any()
    for model, dims in (("gcn", [12, 8, 5]), ("gat", [12, 8, 8, 5])):
        assert (lay.wire_fields_per_step(model, dims)
                == jlay.wire_fields_per_step(model, dims))


@pytest.mark.parametrize("partitioner", ["hash", "metis_like"])
@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ring_layout_and_boundary_mask_equal(name, k, partitioner):
    """The ring plan, vectorised, against the reference's loop over source
    blocks: ids_exec and mask_exec [k(dev), k(src), nb, K] (pad slots id 0
    with mask 0), the exchange constants, a table of nb rows and the wire
    bytes; and the boundary mask (rows read by another part) the protocols
    read, equal under every execution model."""
    g, jg = _graphs(name)
    lay = EdgeCutLayout(g, k, EngineConfig(execution="ring",
                                           partitioner=partitioner))
    jlay = JEdgeCutLayout(jg, k, JEngineConfig(execution="ring",
                                               partitioner=partitioner))
    nb, K = lay.nb, lay.K
    consts, jconsts = lay.exchange_consts(), jlay.exchange_consts()
    assert sorted(consts) == sorted(jconsts) == ["ids", "mask"]
    for ours, theirs in ((lay.ids_exec, np.asarray(jlay.ids_exec)),
                         (lay.mask_exec, np.asarray(jlay.mask_exec)),
                         (consts["ids"], np.asarray(jconsts["ids"])),
                         (consts["mask"], np.asarray(jconsts["mask"])),
                         (lay.bmask, np.asarray(jlay.bmask))):
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    assert lay.ids_exec.shape == (k, k, nb, K) and lay.table_rows == nb
    assert not lay.ids_exec[lay.mask_exec == 0].any()
    # every real slot lands in exactly one source block
    assert np.array_equal(lay.mask_exec.sum(1).reshape(k * nb, K), lay.mask)
    assert lay.bmask.any() == (k > 1 and lay.part.communication_volume(g) > 0)
    for model, dims in (("gcn", [12, 8, 5]), ("gat", [12, 8, 8, 5])):
        assert (lay.wire_fields_per_step(model, dims)
                == jlay.wire_fields_per_step(model, dims))
    for execution in ("broadcast", "p2p"):
        other = EdgeCutLayout(g, k, EngineConfig(execution=execution,
                                                 partitioner=partitioner))
        assert np.array_equal(other.bmask, lay.bmask)


def test_layout_for_an_unported_plan_raises():
    """Every partition family is ported; what the reference refuses the
    port refuses alike, at the builder: an unknown family, and a replica
    family under a mini-batch mode (the reference's mini-batch path runs
    on the edge cut only)."""
    with pytest.raises(ValueError, match="unknown partition family"):
        get_layout_builder("nope")
    for family in ("vertex_cut", "hybrid"):
        builder = get_layout_builder(family)
        assert builder.family == family
        with pytest.raises(ValueError, match="full_graph"):
            builder.validate(EngineConfig(partition_family=family,
                                          batching="node_wise"))


def _equal_arrays(pairs):
    for name, ours, theirs in pairs:
        theirs = np.asarray(theirs)
        assert ours.dtype == theirs.dtype, (name, ours.dtype, theirs.dtype)
        assert np.array_equal(ours, theirs), name


@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("cut", ["random", "cartesian2d", "libra"])
def test_vertex_cuts_equal(cut, k):
    """Each vertex cut gives the reference's edge owners and masters for one
    seed, with the same replica counts and replication factor (libra, a
    loop over every edge, on the sbm graph only)."""
    assert sorted(vertex_cut.VERTEX_CUTS) == sorted(jvertex_cut.VERTEX_CUTS)
    assert vertex_cut.grid_for(k) == jvertex_cut.grid_for(k)
    for name in (["sbm"] if cut == "libra" else sorted(GRAPHS)):
        g, jg = _graphs(name)
        for seed in (0, 3):
            vc = vertex_cut.VERTEX_CUTS[cut](g, k, seed=seed)
            jvc = jvertex_cut.VERTEX_CUTS[cut](jg, k, seed=seed)
            assert vc.num_parts == jvc.num_parts == k
            _equal_arrays([("edge_owner", vc.edge_owner, jvc.edge_owner),
                           ("masters", vc.masters, jvc.masters)])
            for inc in (False, True):
                _equal_arrays([("replica_counts",
                                vc.replica_counts(g, include_masters=inc),
                                jvc.replica_counts(jg, include_masters=inc))])
            assert vc.replication_factor(g) == jvc.replication_factor(jg)
    src, dst = vertex_cut.edge_endpoints(g)
    jsrc, jdst = jvertex_cut.edge_endpoints(jg)
    _equal_arrays([("src", src, jsrc), ("dst", dst, jdst)])
    assert np.array_equal(g.out_degree(), jg.out_degree())


LAYOUT_FIELDS = ("vert_ids", "slot_of", "master_mask", "rep_count",
                 "ids_owned", "mask_owned", "deg", "bmask", "X", "y",
                 "train_w", "test_w", "master_counts")


def _same_layout(lay, jlay):
    assert (lay.k, lay.nv, lay.Kc, lay.Rm, lay.sorted_masters) == (
        jlay.k, jlay.nv, jlay.Kc, jlay.Rm, jlay.sorted_masters)
    _equal_arrays([(f, getattr(lay, f), getattr(jlay, f))
                   for f in LAYOUT_FIELDS])
    assert lay.replication_factor() == jlay.replication_factor()


@pytest.mark.parametrize("sorted_masters", [False, True])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("cut", ["random", "cartesian2d"])
def test_vertex_layout_equal(cut, k, sorted_masters):
    for name in sorted(GRAPHS):
        g, jg = _graphs(name)
        lay = vertex_layout.build_vertex_layout(
            g, vertex_cut.VERTEX_CUTS[cut](g, k), k, sorted_masters)
        jlay = jvertex_layout.build_vertex_layout(
            jg, jvertex_cut.VERTEX_CUTS[cut](jg, k), k, sorted_masters)
        _same_layout(lay, jlay)


PLAN_KEYS = {"broadcast": ("rep_ids", "rep_mask"), "ring": ("ring_ids",),
             "p2p": ("send1", "gather_ids", "gather_mask", "send2",
                     "scatter_ids")}


def _same_plan(plan, jplan, execution):
    """The plan's tables, rows_per_layer and caps equal the reference's;
    p2p's send masks mark exactly the need entries (rows_per_layer of them
    over the two phases, no send id on a pad entry)."""
    assert plan["rows_per_layer"] == jplan["rows_per_layer"]
    assert plan.get("caps") == jplan.get("caps")
    _equal_arrays([(key, plan[key], jplan[key])
                   for key in PLAN_KEYS[execution]])
    if execution == "p2p":
        for n in ("1", "2"):
            send, mask = plan["send" + n], plan[f"send{n}_mask"]
            assert mask.shape == send.shape
            assert not send[mask == 0].any()
        assert (int(plan["send1_mask"].sum() + plan["send2_mask"].sum())
                == plan["rows_per_layer"])


@pytest.mark.parametrize("buckets", [1, 2])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("execution", ["broadcast", "ring", "p2p"])
def test_replica_sync_plan_equal(execution, k, buckets):
    """`build_replica_sync_plan` (p2p's lists vectorised) against the
    reference's loops, for the random and the libra cut (libra on the sbm
    graph), and with sorted masters."""
    for name, cut, sm in (("er", "random", False), ("sbm", "libra", False),
                          ("sbm", "random", True)):
        g, jg = _graphs(name)
        vc = vertex_cut.VERTEX_CUTS[cut](g, k)
        jvc = jvertex_cut.VERTEX_CUTS[cut](jg, k)
        lay = vertex_layout.build_vertex_layout(g, vc, k, sm)
        jlay = jvertex_layout.build_vertex_layout(jg, jvc, k, sm)
        rf, rp = replica_sync._vertex_replica_tables(lay)
        jrf, jrp = jreplica_sync._vertex_replica_tables(jlay)
        _equal_arrays([("rep_flat", rf, jrf), ("rep_part", rp, jrp)])
        plan = replica_sync.build_replica_sync_plan(lay, vc.masters,
                                                    execution, buckets)
        jplan = jreplica_sync.build_replica_sync_plan(jlay, jvc.masters,
                                                      execution, buckets)
        _same_plan(plan, jplan, execution)
        if execution == "p2p" and k > 1:
            assert plan["rows_per_layer"] == 2 * int(
                np.maximum(lay.rep_count - 1, 0).sum()) > 0
    with pytest.raises(ValueError, match="execution must be one of"):
        replica_sync.build_replica_sync_plan(lay, vc.masters, "spmm_1d")


@pytest.mark.parametrize("execution", ["broadcast", "ring", "p2p"])
@pytest.mark.parametrize("k", [1, 4])
def test_vertex_cut_family_layout_equal(k, execution):
    """The engine-facing vertex-cut layout: the flattened replica space,
    the reference ELL, the sync plan's flattened tables, the rank-leading
    keys, the wire bytes and the master-row embeddings."""
    g, jg = _graphs("er")
    for cut, sm in (("cartesian2d", False), ("random", True)):
        cfg = EngineConfig(partition_family="vertex_cut", vertex_cut=cut,
                           execution=execution, sorted_masters=sm,
                           p2p_buckets=2)
        jcfg = JEngineConfig(partition_family="vertex_cut", vertex_cut=cut,
                             execution=execution, sorted_masters=sm,
                             p2p_buckets=2)
        lay = VertexCutFamilyLayout(g, k, cfg)
        jlay = JVertexCutFamilyLayout(jg, k, jcfg)
        assert (lay.nb, lay.nv, lay.Vp, lay.K) == (jlay.nb, jlay.nv, jlay.Vp,
                                                    jlay.K)
        assert lay.table_rows == lay.nv + 1
        assert set(jlay.squeeze_keys) <= set(lay.squeeze_keys)
        consts, jconsts = lay.exchange_consts(), jlay.exchange_consts()
        assert set(jconsts) <= set(consts)
        _equal_arrays([(key, consts[key], jconsts[key]) for key in jconsts]
                      + [(f, getattr(lay, f), getattr(jlay, f)) for f in (
                          "ids_global", "mask", "deg", "y", "train_w",
                          "test_w", "bmask", "ref_vert_ids")]
                      + [("X", lay.X.numpy(), jlay.X)])
        assert lay._vc_rows_per_layer == jlay._vc_rows_per_layer
        for model, dims in (("gcn", [12, 8, 5]), ("gat", [12, 8, 8, 5])):
            assert (lay.wire_fields_per_step(model, dims)
                    == jlay.wire_fields_per_step(model, dims))
        H = np.random.default_rng(0).standard_normal(
            (lay.Vp, 4)).astype(np.float32)
        assert np.array_equal(lay.global_embeddings(H),
                              jlay.global_embeddings(H))


HUB_THRESHOLDS = [None, 6.0, np.inf, 0.0]


@pytest.mark.parametrize("execution", ["broadcast", "ring", "p2p"])
@pytest.mark.parametrize("threshold", HUB_THRESHOLDS,
                         ids=["auto", "six", "inf", "zero"])
def test_hybrid_layout_equal(threshold, execution):
    """The hybrid cut and layout at four hub thresholds, 4 parts: the cut,
    the inner replica layout, the halo need lists, the owned-edge ELL
    with its halo columns and the reference ELL, the boundary mask, the
    sync plan, the execution's halo table, the flags, the wire bytes.
    Threshold inf: no replica, the halo is the edge-cut p2p halo (the
    partition's communication volume); 0: no halo."""
    k = 4
    for name, partitioner, buckets in (("er", "metis_like", 2),
                                       ("sbm", "hash", 1)):
        g, jg = _graphs(name)
        cfg = EngineConfig(partition_family="hybrid", execution=execution,
                           partitioner=partitioner, hub_threshold=threshold,
                           p2p_buckets=buckets)
        jcfg = JEngineConfig(partition_family="hybrid", execution=execution,
                             partitioner=partitioner,
                             hub_threshold=threshold, p2p_buckets=buckets)
        lay = hybrid_cut.HybridLayout(g, k, cfg)
        jlay = jhybrid_cut.HybridLayout(jg, k, jcfg)
        cut, jcut = lay.cut, jlay.cut
        assert cut.threshold == jcut.threshold
        _equal_arrays([("hub", cut.hub, jcut.hub),
                       ("masters", cut.masters, jcut.masters),
                       ("edge_owner", cut.edge_owner, jcut.edge_owner)])
        _same_layout(lay.layout, jlay.layout)
        for d in range(k):
            _equal_arrays([(f"need {d} {s}", lay.halo_need[d][s],
                            jlay.halo_need[d][s]) for s in range(k)])
        assert (lay.halo_rows, lay.halo_rows_exec, lay.halo_widths,
                lay.halo_active, lay.sync_active) == (
            jlay.halo_rows, jlay.halo_rows_exec, jlay.halo_widths,
            jlay.halo_active, jlay.sync_active)
        consts, jconsts = lay.exchange_consts(), jlay.exchange_consts()
        assert set(jconsts) <= set(consts)
        assert set(jlay.squeeze_keys) <= set(lay.squeeze_keys)
        _equal_arrays([(key, consts[key], jconsts[key]) for key in jconsts]
                      + [(f, getattr(lay, f), getattr(jlay, f)) for f in (
                          "ids_global", "mask", "deg", "bmask", "train_w")])
        halo_key = dict(p2p="halo_send", broadcast="halo_src",
                        ring="halo_ring")[execution]
        Hbuf = consts[halo_key][0].size if lay.halo_active else 0
        if execution == "ring" and lay.halo_active:
            Hbuf = consts[halo_key].shape[-1]
        assert lay.table_rows == lay.nv + Hbuf + 1
        if execution == "p2p" and lay.halo_active:
            assert int(consts["halo_send_mask"].sum()) == lay.halo_rows
        if threshold == np.inf:
            assert not lay.sync_active and lay.halo_active
            assert lay.halo_rows == lay.part.communication_volume(g)
        if threshold == 0.0:
            assert lay.sync_active and not lay.halo_active
        for model, dims in (("gcn", [12, 8, 5]), ("gat", [12, 8, 8, 5])):
            assert (lay.wire_fields_per_step(model, dims)
                    == jlay.wire_fields_per_step(model, dims))
        H = np.random.default_rng(0).standard_normal(
            (lay.Vp, 4)).astype(np.float32)
        assert np.array_equal(lay.global_embeddings(H),
                              jlay.global_embeddings(H))
    assert hybrid_cut.auto_hub_threshold(g) == jhybrid_cut.auto_hub_threshold(jg)
    for thr in (-1.0, np.nan):
        with pytest.raises(ValueError, match="hub_threshold"):
            hybrid_cut.HybridLayout.validate(
                EngineConfig(partition_family="hybrid", hub_threshold=thr))


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("execution", ["broadcast", "ring", "p2p"])
def test_cost_models_equal(execution, k):
    for model, family in (("gcn", "edge_cut"), ("gat", "edge_cut"),
                          ("gat", "vertex_cut")):
        dims = [16, 8, 8, 3]
        assert (cost_models.model_exchange_widths(model, dims, family)
                == jcost.model_exchange_widths(model, dims, family))
    g, jg = _graphs("sbm")
    part = PARTITIONERS["metis_like"](g, k)
    jpart = JPARTITIONERS["metis_like"](jg, k)
    p2p = execution == "p2p"
    for model in ("gcn", "gat"):
        ours = cost_models.inference_bytes_per_sweep(
            execution, [16, 8, 3], model=model, k=k, nb=37,
            **(dict(g=g, part=part) if p2p else {}))
        assert ours == jcost.inference_bytes_per_sweep(
            execution, [16, 8, 3], model=model, k=k, nb=37,
            **(dict(g=jg, part=jpart) if p2p else {}))
        assert (cost_models.edge_cut_halo_bytes_per_step(g, part, [16, 8, 3],
                                                         model=model)
                == jcost.edge_cut_halo_bytes_per_step(jg, jpart, [16, 8, 3],
                                                      model=model))
    if p2p and k > 1:
        assert ours > 0
    dims = [16, 8, 3]
    lay = vertex_layout.build_vertex_layout(
        g, vertex_cut.VERTEX_CUTS["random"](g, k), k)
    for model in ("gcn", "gat"):
        kw = dict(model=model, family="vertex_cut", k=k, nv=lay.nv,
                  rep_counts=lay.rep_count)
        assert (cost_models.inference_bytes_per_sweep(execution, dims, **kw)
                == jcost.inference_bytes_per_sweep(execution, dims, **kw))
        assert (cost_models.replica_sync_bytes_per_step(
            lay.rep_count, k, lay.nv, execution, dims, model=model)
                == jcost.replica_sync_bytes_per_step(
            lay.rep_count, k, lay.nv, execution, dims, model=model))
        assert (cost_models.hybrid_exchange_widths(model, [16, 8, 8, 3])
                == jcost.hybrid_exchange_widths(model, [16, 8, 8, 3]))
        for halo, sync in ((0, 0), (37, 0), (0, 11), (37, 11)):
            assert (cost_models.hybrid_bytes_per_step(halo, sync, dims, model)
                    == jcost.hybrid_bytes_per_step(halo, sync, dims, model))


def test_feature_store_update_rows_is_live():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((2, 5, 3)).astype(np.float32)
    store, jstore = FeatureStore(table, torch.device("cpu")), JFeatureStore(table)
    view = store.device_table()
    ids, rows = np.array([7, 1]), rng.standard_normal((2, 3)).astype(np.float32)
    store.update_rows(ids, rows)
    jstore.update_rows(ids, rows)
    assert (store.num_rows, store.dim) == (jstore.num_rows, jstore.dim)
    assert np.array_equal(view.numpy(), np.asarray(jstore.device_table()))
