"""The port's mini-batch host layer against the reference, with no engine:
the graph helpers the samplers read (`Graph.subgraph`, `to_dense_adj`,
`powerlaw_graph`), the three samplers, `MiniBatch.relabel` and
`self_indices`, `frontier_caps` and `pad_minibatch` array for array for one
`np.random.Generator` state; the four cache policies and `device_cache_ids`
on a power-law graph, `FIFOCache`, `simulate_hit_ratio` and
`proximity_ordering`; pull-based, CSP and skewed sampling with their bytes,
`feature_fetch_bytes` and `p2p_frontier_halo_cap` at k in {1, 4};
`HostBatchBuilder`'s sampled batches, extracted arrays and CommStats deltas
for every execution model with and without the static cache at k in
{1, 4}, both builders fed the same plan; and the feature store's hot-row
overlay."""
import dataclasses

import numpy as np
import pytest

from repro.core.feature_store import FeatureStore as JFeatureStore
from repro.core.graph import powerlaw_graph as jpowerlaw_graph
from repro.core.graph import sbm_graph as jsbm_graph
from repro.core.partition.edge_cut import PARTITIONERS as JPARTITIONERS
from repro.core.sampling import cache as jcache
from repro.core.sampling import distributed as jdistributed
from repro.core.sampling import partition_batch as jpartition_batch
from repro.core.sampling import samplers as jsamplers
from repro.core.sampling.host_batch import HostBatchBuilder as JHostBatchBuilder
from repro_torch.core.engine import EngineConfig
from repro_torch.core.execution.bucketing import bucketed_cap_widths
from repro_torch.core.feature_store import FeatureStore
from repro_torch.core.graph import powerlaw_graph, sbm_graph
from repro_torch.core.partition.edge_cut import PARTITIONERS
from repro_torch.core.partition.layout_api import EdgeCutLayout
from repro_torch.core.sampling import cache, distributed, partition_batch, samplers
from repro_torch.core.sampling.host_batch import HostBatchBuilder

SBM = dict(num_vertices=96, num_blocks=8, p_in=0.08, p_out=0.01)
POWERLAW = dict(num_vertices=120, avg_degree=8, seed=2)
GRAPH_FIELDS = ("indptr", "indices", "features", "labels", "train_mask",
                "val_mask", "test_mask")


@pytest.fixture(scope="module")
def graphs():
    return dict(sbm=(sbm_graph(**SBM), jsbm_graph(**SBM)),
                powerlaw=(powerlaw_graph(**POWERLAW),
                          jpowerlaw_graph(**POWERLAW)))


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape,
                                                       a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def _same_batch(mb, jmb, what=""):
    _same(mb.targets, jmb.targets, f"{what} targets")
    assert len(mb.layer_vertices) == len(jmb.layer_vertices)
    for l, (a, b) in enumerate(zip(mb.layer_vertices, jmb.layer_vertices)):
        _same(a, b, f"{what} layer_vertices {l}")
    assert len(mb.layer_adj) == len(jmb.layer_adj)
    for l, (a, b) in enumerate(zip(mb.layer_adj, jmb.layer_adj)):
        _same(a, b, f"{what} layer_adj {l}")
    for field in ("input_features", "labels"):
        _same(getattr(mb, field), getattr(jmb, field), f"{what} {field}")


def test_powerlaw_graph_and_subgraph_helpers(graphs):
    for name, (g, jg) in graphs.items():
        for field in GRAPH_FIELDS:
            _same(getattr(g, field), getattr(jg, field), f"{name} {field}")
        verts = np.sort(np.random.default_rng(0).choice(
            g.num_vertices, 30, replace=False))
        (sub, remap), (jsub, jremap) = g.subgraph(verts), jg.subgraph(verts)
        _same(remap, jremap)
        for field in ("indptr", "indices", "features", "labels",
                      "train_mask"):
            _same(getattr(sub, field), getattr(jsub, field), field)
        assert sub.num_vertices == jsub.num_vertices == 30
        for normalized in (True, False):
            _same(sub.to_dense_adj(normalized), jsub.to_dense_adj(normalized))
    # an induced subgraph with no edge
    g, jg = graphs["sbm"]
    lone = np.asarray([0])
    _same(g.subgraph(lone)[0].indices, jg.subgraph(lone)[0].indices)


@pytest.mark.parametrize("graph", ["sbm", "powerlaw"])
def test_samplers_match_the_reference(graphs, graph):
    g, jg = graphs[graph]
    targets = np.sort(np.random.default_rng(5).choice(
        g.num_vertices, 8, replace=False))
    cases = [
        (samplers.node_wise_sample, jsamplers.node_wise_sample, (3, 2)),
        (samplers.layer_wise_sample, jsamplers.layer_wise_sample, (16, 12)),
    ]
    for ours, theirs, arg in cases:
        mb = ours(g, targets, arg, np.random.default_rng(11))
        jmb = theirs(jg, targets, arg, np.random.default_rng(11))
        _same_batch(mb, jmb, ours.__name__)
        for a, b in zip(mb.self_indices(), jmb.self_indices()):
            _same(a, b, "self_indices")
        rel, jrel = mb.relabel(), jmb.relabel()
        _same_batch(rel, jrel, "relabel")
        for lv, orig in zip(rel.layer_vertices, mb.layer_vertices):
            _same(mb.layer_vertices[0][lv], orig, "relabel round trip")
        _same(mb.accessed_vertices(), jmb.accessed_vertices())
    for layers in (2, 3):
        mb = samplers.subgraph_sample(g, targets, 3, np.random.default_rng(4),
                                      num_layers=layers)
        jmb = jsamplers.subgraph_sample(jg, targets, 3,
                                        np.random.default_rng(4),
                                        num_layers=layers)
        _same_batch(mb, jmb, "subgraph")
        assert mb.num_input_vertices == jmb.num_input_vertices


def test_frontier_caps_and_pad_minibatch(graphs):
    g, jg = graphs["sbm"]
    for batching, kw in (("node_wise", dict(fanouts=(3, 2))),
                         ("layer_wise", dict(layer_sizes=(16, 12))),
                         ("subgraph", dict(walk_length=3))):
        for V in (0, g.num_vertices, 40):
            assert samplers.frontier_caps(batching, 2, 8, num_vertices=V,
                                          **kw) == jsamplers.frontier_caps(
                batching, 2, 8, num_vertices=V, **kw)
    for bad in (dict(batching="node_wise", fanouts=(3,)),
                dict(batching="layer_wise", layer_sizes=(3, 4, 5)),
                dict(batching="nope")):
        for fn in (samplers.frontier_caps, jsamplers.frontier_caps):
            with pytest.raises(ValueError):
                fn(num_layers=2, batch_size=8, **bad)
    targets = np.arange(0, 40, 5)
    mb = samplers.node_wise_sample(g, targets, (3, 2),
                                   np.random.default_rng(2))
    jmb = jsamplers.node_wise_sample(jg, targets, (3, 2),
                                     np.random.default_rng(2))
    caps = samplers.frontier_caps("node_wise", 2, 8, fanouts=(3, 2),
                                  num_vertices=g.num_vertices)
    padded, jpadded = (samplers.pad_minibatch(mb, caps),
                       jsamplers.pad_minibatch(jmb, caps))
    assert padded.keys() == jpadded.keys()
    for key in ("frontier", "fmask", "tgt", "tmask"):
        _same(padded[key], jpadded[key], key)
    for key in ("adj", "self_idx"):
        for a, b in zip(padded[key], jpadded[key]):
            _same(a, b, key)
    with pytest.raises(ValueError, match="caps"):
        samplers.pad_minibatch(mb, caps[:-1])
    with pytest.raises(ValueError, match="exceeds cap"):
        samplers.pad_minibatch(mb, [1] * len(caps))


def test_cache_policies_and_device_cache_ids(graphs):
    g, jg = graphs["powerlaw"]
    for name in cache.CACHE_POLICIES:
        _same(cache.CACHE_POLICIES[name](g, 20),
              jcache.CACHE_POLICIES[name](jg, 20), name)
    assert tuple(cache.CACHE_POLICIES) == tuple(jcache.CACHE_POLICIES)
    _same(cache.presampling_cache(g, 15, fanouts=(3, 3), batch_size=16,
                                  epochs=2, seed=3),
          jcache.presampling_cache(jg, 15, fanouts=(3, 3), batch_size=16,
                                   epochs=2, seed=3))
    total, per_hop = cache.analysis_propagation(g, fanouts=(3, 2))
    jtotal, jper_hop = jcache.analysis_propagation(jg, fanouts=(3, 2))
    _same(total, jtotal)
    for a, b in zip(per_hop, jper_hop):
        _same(a, b)
    for k in (1, 4):
        assign = PARTITIONERS["hash"](g, k).assignment
        _same(assign, JPARTITIONERS["hash"](jg, k).assignment)
        for worker in range(k):
            for policy in ("none", *cache.CACHE_POLICIES):
                for cap in (0, 12, 10_000):
                    ours = cache.device_cache_ids(g, assign, worker, policy,
                                                  cap)
                    _same(ours, jcache.device_cache_ids(
                        jg, assign, worker, policy, cap), (policy, cap))
                    assert not np.any(assign[ours] == worker)


def test_fifo_hit_ratio_and_proximity_ordering(graphs):
    g, jg = graphs["powerlaw"]
    rng = np.random.default_rng(9)
    stream = [rng.integers(0, g.num_vertices, 17) for _ in range(12)]
    for capacity in (0, 1, 8, 40):
        ours, theirs = cache.FIFOCache(capacity), jcache.FIFOCache(capacity)
        assert ours.run(stream) == theirs.run(stream)
        assert list(ours._set) == list(theirs._set)
    ids = cache.static_degree_cache(g, 25)
    assert cache.simulate_hit_ratio(ids, stream) == jcache.simulate_hit_ratio(
        ids, stream)
    assert cache.simulate_hit_ratio(ids, []) == 0.0
    train = np.where(g.train_mask)[0]
    for seed, shift in ((0, True), (3, False)):
        _same(cache.proximity_ordering(g, train, seed=seed, shift=shift),
              jcache.proximity_ordering(jg, train, seed=seed, shift=shift))


@pytest.mark.parametrize("k", [1, 4])
def test_distributed_sampling_and_byte_models(graphs, k):
    g, jg = graphs["powerlaw"]
    part, jpart = PARTITIONERS["hash"](g, k), JPARTITIONERS["hash"](jg, k)
    targets = np.arange(0, g.num_vertices, 7)
    D = g.features.shape[1]
    for worker in range(k):
        for fn, jfn in ((distributed.pull_based_sample,
                         jdistributed.pull_based_sample),
                        (distributed.csp_sample, jdistributed.csp_sample)):
            out, stats = fn(g, part, worker, targets, 3,
                            np.random.default_rng(worker))
            jout, jstats = jfn(jg, jpart, worker, targets, 3,
                               np.random.default_rng(worker))
            assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
            for a, b in zip(out, jout):
                _same(a, b, fn.__name__)
        out, stats, loc = distributed.skewed_weighted_sample(
            g, part, worker, targets, 3, 4.0, np.random.default_rng(1))
        jout, jstats, jloc = jdistributed.skewed_weighted_sample(
            jg, jpart, worker, targets, 3, 4.0, np.random.default_rng(1))
        assert loc == jloc
        assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
        for a, b in zip(out, jout):
            _same(a, b, "skewed")
        cached = cache.device_cache_ids(g, part.assignment, worker,
                                        "static_degree", 10)
        for ids in (frozenset(), cached, frozenset(int(v) for v in cached)):
            stats, jstats = distributed.CommStats(), jdistributed.CommStats()
            miss = distributed.feature_fetch_bytes(part, worker, targets, D,
                                                   cached_ids=ids,
                                                   stats=stats)
            assert miss == jdistributed.feature_fetch_bytes(
                jpart, worker, targets, D, cached_ids=ids, stats=jstats)
            assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
            assert stats.requested() == distributed.feature_fetch_bytes(
                part, worker, targets, D)
    for hops in (1, 2, 3):
        for cap0 in (1, 30, 10_000):
            assert partition_batch.p2p_frontier_halo_cap(
                g, part, hops, cap0) == jpartition_batch.p2p_frontier_halo_cap(
                jg, jpart, hops, cap0)
    for worker in range(k):
        for size in (4, 1000):
            for train_only in (True, False):
                _same(partition_batch.partition_targets(
                    g, part, worker, size, np.random.default_rng(3),
                    train_only),
                    jpartition_batch.partition_targets(
                    jg, jpart, worker, size, np.random.default_rng(3),
                    train_only))


BUILDER_CASES = [(k, execution, policy, batching)
                 for k in (1, 4) for execution in ("broadcast", "ring", "p2p")
                 for policy in ("none", "static_degree")
                 for batching in ("node_wise", "layer_wise", "subgraph")
                 if batching == "node_wise" or policy == "none"]


@pytest.mark.parametrize("k,execution,policy,batching", BUILDER_CASES)
def test_host_batch_builder_matches_the_reference(graphs, k, execution,
                                                  policy, batching):
    """Both builders fed one plan (the port's layout and caps, which the
    layout and sampler tiers hold to the reference's): two steps' sampled
    batches, extracted arrays and per-rank meta (CommStats deltas,
    occupancy, cache hits) equal, and the arrays of the shapes
    `array_layout` names."""
    g, jg = graphs["powerlaw"]
    cfg = EngineConfig(execution=execution, partitioner="hash", p2p_buckets=2)
    lay = EdgeCutLayout(g, k, cfg)
    caps = tuple(samplers.frontier_caps(
        batching, 2, 6, fanouts=(3, 2), layer_sizes=(16, 12), walk_length=3,
        num_vertices=g.num_vertices))
    fcap, widths = caps[0], None
    if execution == "p2p":
        fcap = partition_batch.p2p_frontier_halo_cap(
            g, lay.part, 3 if batching == "subgraph" else 2, caps[0])
        widths = tuple(bucketed_cap_widths(fcap, 2))
    capacity = 12 if policy != "none" else 0
    ids = [cache.device_cache_ids(g, lay.part.assignment, d, policy, capacity)
           for d in range(k)]
    plan = dict(batching=batching, execution=execution, seed=3, batch_size=6,
                fanouts=(3, 2), layer_sizes=(16, 12), walk_length=3,
                num_layers=2, k=k, nb=lay.nb, caps=caps, fcap=fcap,
                fcap_widths=widths, Ccap=max(capacity, 1),
                feature_dim=g.features.shape[1],
                assignment=lay.part.assignment, new_of_old=lay.new_of_old,
                labels=g.labels, train_mask=g.train_mask,
                cache_slots=[{int(v): j for j, v in enumerate(a)} for a in ids],
                cache_sets=[frozenset(int(v) for v in a) for a in ids])
    ours = HostBatchBuilder(graph=g, **plan)
    theirs = JHostBatchBuilder(graph=jg, trainable_features=False, tcap=0,
                               overlay_rows=tuple(len(a) for a in ids), **plan)
    hits = 0
    for step in (0, 1):
        mbs, jmbs = ours.sample(step), theirs.sample(step)
        assert len(mbs) == len(jmbs) == k
        for mb, jmb in zip(mbs, jmbs):
            _same_batch(mb, jmb, f"step {step}")
        arrays, meta = ours.extract(mbs)
        jarrays, jmeta = theirs.extract(jmbs, step=step)
        assert arrays.keys() == jarrays.keys()
        for key in arrays:
            _same(arrays[key], jarrays[key], key)
        assert meta == jmeta
        layout = ours.array_layout()
        assert layout == theirs.array_layout()
        assert {key: (a.shape, a.dtype) for key, a in arrays.items()} == layout
        hits += sum(d["cache_hits"] for d in meta["per_device"])
    assert (hits > 0) == (k > 1 and policy != "none")


def test_feature_store_overlay_matches_the_reference():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((4, 6, 3)).astype(np.float32)
    ours, theirs = FeatureStore(table, "cpu"), JFeatureStore(table)
    ids = np.asarray([0, 5, 6, 23, 24, -1])
    _same(ours.lookup(ids), theirs.lookup(ids))
    _same(ours.owner_of(ids[:4]), theirs.owner_of(ids[:4]))
    _same(ours.slot_of(ids[:4]), theirs.slot_of(ids[:4]))
    overlay = [np.asarray([7, 13]), np.asarray([]), np.asarray([1, 2, 19]),
               np.asarray([0])]
    for store in (ours, theirs):
        with pytest.raises(ValueError, match="no overlay"):
            store.overlay_table()
        with pytest.raises(ValueError, match="own rows"):
            store.attach_overlay([np.asarray([1])] + overlay[1:], 3)
        with pytest.raises(ValueError, match="capacity"):
            store.attach_overlay(overlay, 2)
        with pytest.raises(ValueError, match="id lists"):
            store.attach_overlay(overlay[:3], 3)
        store.attach_overlay(overlay, 3)
    _same(ours.overlay_table(), theirs.overlay_table())
    # a write shows in the overlay only after a refresh, as the reference's
    ours.update_rows([13], np.ones((1, 3), np.float32))
    theirs.update_rows([13], np.ones((1, 3), np.float32))
    _same(ours.overlay_table(), theirs.overlay_table())
    ours.refresh_overlay()
    theirs.refresh_overlay()
    _same(ours.overlay_table(), theirs.overlay_table())
    assert ours.overlay_table()[0, 1].tolist() == [1.0, 1.0, 1.0]
