"""The port's single-device trainers and their host layer against the
reference on the CPU.

`repro_torch.core.training`'s `full_graph_train` (gcn, sage, gat and gin
under sync; gcn under epoch_fixed, epoch_adaptive, variation and PipeGCN),
`minibatch_train` (cache 0 and 60) and `llcg_train` (server_correct on and
off, expand_hops 0 and 1) on `tests/test_gnn_training.py`'s graph, each
from the reference's own initial weights (`init_gnn_params` of the port's
training module replaced by the reference's draw for the same seed,
carried over with `params_from_numpy`), held to `repro.core.training`'s
run: the losses within 1e-4 element for element, `bytes_pushed` and the
cache hit ratio equal, the accuracies within one vertex, and a second run
of the port bit for bit.  Beside them, array for array or number for
number: the chunked aggregates (`execution/chunk.py`) and
`full_graph_forward` with an aggregate, the protocols' cost model
(`protocols/sync.py`), the feature shardings
(`partition/feature_partition.py`), `partition_minibatch`,
`expanded_partition_minibatch` and `LLCGSchedule`, `boundary_mask_for`,
the device-built dense adjacency and the padded mini-batch; the entry
points' default device; and the lazy package exports, which import no
torch.
"""
import dataclasses
import functools
import inspect
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.training as ref_training
from repro.core.execution import chunk as ref_chunk
from repro.core.graph import from_edges as ref_from_edges
from repro.core.graph import powerlaw_graph as ref_powerlaw_graph
from repro.core.graph import sbm_graph as ref_sbm_graph
from repro.core.models.gnn import full_graph_forward as ref_full_graph_forward
from repro.core.models.gnn import init_gnn_params as ref_init_gnn_params
from repro.core.partition import PARTITIONERS as REF_PARTITIONERS
from repro.core.partition import feature_partition as ref_fp
from repro.core.protocols import sync as ref_sync
from repro.core.sampling import partition_batch as ref_pb
from repro.core.sampling.samplers import node_wise_sample as ref_node_wise
from repro_torch.core import training
from repro_torch.core.execution import chunk
from repro_torch.core.graph import from_edges, powerlaw_graph, sbm_graph
from repro_torch.core.models.gnn import full_graph_forward, params_from_numpy
from repro_torch.core.partition import PARTITIONERS
from repro_torch.core.partition import feature_partition as fp
from repro_torch.core.protocols import sync
from repro_torch.core.sampling import partition_batch as pb
from repro_torch.core.sampling.samplers import node_wise_sample

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
CPU = torch.device("cpu")
ORACLE_TOL = 1e-4
# `tests/test_gnn_training.py`'s graph
GRAPH = dict(num_vertices=200, num_blocks=4, p_in=0.08, p_out=0.005, seed=1)
EPOCHS = 6
MB_EPOCHS = 3
LLCG = dict(rounds=3, local_steps=2, lr=0.3)


@pytest.fixture(scope="module")
def graphs():
    return ref_sbm_graph(**GRAPH), sbm_graph(**GRAPH)


@pytest.fixture(scope="module")
def skewed():
    kw = dict(num_vertices=160, avg_degree=6, seed=1)
    return ref_powerlaw_graph(**kw), powerlaw_graph(**kw)


def _carried(model, dims, generator, device):
    """The reference's initial weights for the generator's seed."""
    tree = ref_init_gnn_params(model, dims,
                               jax.random.PRNGKey(generator.initial_seed()))
    return params_from_numpy(jax.tree.map(np.asarray, tree), device)


@pytest.fixture
def carried(monkeypatch):
    monkeypatch.setattr(training, "init_gnn_params", _carried)


def _held(ours, theirs, g, again):
    """Losses within the oracle bound, bytes and hit ratio equal, each
    accuracy within one vertex of its mask, the rerun bitwise."""
    assert len(ours.losses) == len(theirs.losses)
    np.testing.assert_allclose(ours.losses, theirs.losses, atol=ORACLE_TOL,
                               rtol=0)
    assert np.isfinite(ours.losses).all()
    assert dataclasses.asdict(again) == dataclasses.asdict(ours)
    for field, mask in (("train_acc", g.train_mask), ("test_acc", g.test_mask),
                        ("bytes_pushed", None), ("cache_hit_ratio", None)):
        if not hasattr(theirs, field):
            continue
        if mask is None:
            assert getattr(ours, field) == getattr(theirs, field), field
        else:
            assert (abs(getattr(ours, field) - getattr(theirs, field))
                    <= 1.0 / mask.sum() + 1e-7), field


FULL_CASES = (
    [pytest.param(dict(model=m), id=f"sync-{m}")
     for m in ("gcn", "sage", "gat", "gin")]
    + [pytest.param(dict(protocol="epoch_fixed", staleness=2),
                    id="epoch_fixed"),
       pytest.param(dict(protocol="epoch_adaptive", staleness=3),
                    id="epoch_adaptive"),
       pytest.param(dict(protocol="variation", eps_v=0.05), id="variation"),
       pytest.param(dict(protocol="pipegcn", lr=0.3), id="pipegcn")])


@pytest.mark.parametrize("kw", FULL_CASES)
def test_full_graph_train_matches_reference(graphs, carried, kw):
    jg, g = graphs
    theirs = ref_training.full_graph_train(jg, epochs=EPOCHS, **kw)
    ours = training.full_graph_train(g, epochs=EPOCHS, device=CPU, **kw)
    again = training.full_graph_train(g, epochs=EPOCHS, device=CPU, **kw)
    _held(ours, theirs, g, again)
    if kw.get("protocol", "sync") != "sync":
        assert ours.bytes_pushed > 0


@pytest.mark.parametrize("cache", [0, 60])
def test_minibatch_train_matches_reference(graphs, carried, cache):
    jg, g = graphs
    theirs = ref_training.minibatch_train(jg, epochs=MB_EPOCHS,
                                          cache_capacity=cache)
    ours = training.minibatch_train(g, epochs=MB_EPOCHS, cache_capacity=cache,
                                    device=CPU)
    again = training.minibatch_train(g, epochs=MB_EPOCHS, cache_capacity=cache,
                                     device=CPU)
    _held(ours, theirs, g, again)
    assert (ours.cache_hit_ratio > 0) == (cache > 0)


@pytest.mark.parametrize("expand_hops", [0, 1])
@pytest.mark.parametrize("server_correct", [True, False])
def test_llcg_train_matches_reference(graphs, carried, server_correct,
                                      expand_hops):
    jg, g = graphs
    kw = dict(LLCG, server_correct=server_correct, expand_hops=expand_hops)
    theirs = ref_training.llcg_train(jg, **kw)
    ours = training.llcg_train(g, device=CPU, **kw)
    again = training.llcg_train(g, device=CPU, **kw)
    _held(ours, theirs, g, again)
    per_round = LLCG["local_steps"] + int(server_correct)
    assert len(ours.losses) == LLCG["rounds"] * per_round


def test_trainers_draw_their_own_weights(graphs):
    """Without the carried weights the port draws its own from the seed:
    the same seed the same run, another seed another."""
    _, g = graphs
    a = training.full_graph_train(g, epochs=3, device=CPU, seed=0)
    b = training.full_graph_train(g, epochs=3, device=CPU, seed=0)
    c = training.full_graph_train(g, epochs=3, device=CPU, seed=1)
    assert a.losses == b.losses and a.losses != c.losses


def test_entry_points_default_to_cuda(graphs, monkeypatch):
    _, g = graphs
    entries = (training.full_graph_train, training.minibatch_train,
               training.llcg_train)
    for fn in entries:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in entries:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(g)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_chunk_aggregates_match_reference(n):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((32, 64)).astype(np.float32)
    H = rng.standard_normal((64, 16)).astype(np.float32)
    At, Ht = torch.from_numpy(A), torch.from_numpy(H)
    one = chunk.one_shot_aggregate(At, Ht)
    np.testing.assert_array_equal(one.numpy(), (At @ Ht).numpy())
    for ours, theirs in (
            (chunk.sequential_chunk_aggregate(At, Ht, n),
             ref_chunk.sequential_chunk_aggregate(jnp.asarray(A),
                                                  jnp.asarray(H), n)),
            (chunk.parallel_chunk_aggregate(At, Ht, n),
             ref_chunk.parallel_chunk_aggregate(jnp.asarray(A),
                                                jnp.asarray(H), n))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(ours.numpy(), one.numpy(), atol=1e-5,
                                   rtol=0)


def test_chunk_aggregates_refuse_ragged_chunks():
    A, H = torch.zeros((4, 6)), torch.zeros((6, 2))
    for fn in (chunk.sequential_chunk_aggregate,
               chunk.parallel_chunk_aggregate):
        with pytest.raises(AssertionError):
            fn(A, H, 4)


@pytest.mark.parametrize("model", ["gcn", "sage", "gat", "gin"])
def test_full_graph_forward_with_aggregate(graphs, model):
    """`full_graph_forward` with the sequential chunk aggregate against
    the reference's, and against its own one-shot forward."""
    jg, g = graphs
    dims = [g.features.shape[1], 8, int(g.labels.max()) + 1]
    tree = ref_init_gnn_params(model, dims, jax.random.PRNGKey(3))
    params = params_from_numpy(jax.tree.map(np.asarray, tree), CPU)
    A = jg.to_dense_adj()
    agg = functools.partial(chunk.sequential_chunk_aggregate, num_chunks=4)
    ref_agg = functools.partial(ref_chunk.sequential_chunk_aggregate,
                                num_chunks=4)
    ours = full_graph_forward(model, params, torch.from_numpy(A),
                              torch.from_numpy(g.features), aggregate=agg)
    theirs = ref_full_graph_forward(model, tree, jnp.asarray(A),
                                    jnp.asarray(jg.features),
                                    aggregate=ref_agg)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                               atol=ORACLE_TOL, rtol=0)
    plain = full_graph_forward(model, params, torch.from_numpy(A),
                               torch.from_numpy(g.features))
    np.testing.assert_allclose(ours.detach().numpy(), plain.detach().numpy(),
                               atol=1e-5, rtol=0)


def _partitions(jg, g):
    for name, k, kw in (("metis_like", 4, {"seed": 0}), ("hash", 3, {"seed": 0}),
                        ("range", 1, {})):
        yield REF_PARTITIONERS[name](jg, k, **kw), PARTITIONERS[name](g, k, **kw)


def test_protocol_costs_match_reference(graphs, skewed):
    assert sync.FEAT_BYTES == ref_sync.FEAT_BYTES
    assert set(sync.PROTOCOL_COSTS) == set(ref_sync.PROTOCOL_COSTS)
    n = 0
    for jg, g in (graphs, skewed):
        for jpart, part in _partitions(jg, g):
            for name, fn in sync.PROTOCOL_COSTS.items():
                for D in (16, 32):
                    ours = dataclasses.asdict(fn(g, part, D))
                    theirs = dataclasses.asdict(
                        ref_sync.PROTOCOL_COSTS[name](jg, jpart, D))
                    assert ours == theirs, (name, D, ours, theirs)
                    n += 1
            assert (dataclasses.asdict(sync.pipeline_cost(g, part, 8, 3))
                    == dataclasses.asdict(ref_sync.pipeline_cost(jg, jpart,
                                                                 8, 3)))
            assert (dataclasses.asdict(sync.shared_memory_cost(g, part, 8, 0.5))
                    == dataclasses.asdict(
                        ref_sync.shared_memory_cost(jg, jpart, 8, 0.5)))
    assert n == 2 * 3 * 5 * 2


def _equal_shards(ours, theirs):
    assert ours.kind == theirs.kind
    assert len(ours.shards) == len(theirs.shards)
    for a, b in zip(ours.shards, theirs.shards):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (ours.index_maps is None) == (theirs.index_maps is None)
    for a, b in zip(ours.index_maps or (), theirs.index_maps or ()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ours.total_bytes() == theirs.total_bytes()


def test_feature_partition_matches_reference(graphs, skewed):
    for jg, g in (graphs, skewed):
        for jpart, part in _partitions(jg, g):
            _equal_shards(fp.row_partition(g, part),
                          ref_fp.row_partition(jg, jpart))
            _equal_shards(fp.row_partition_with_halo(g, part),
                          ref_fp.row_partition_with_halo(jg, jpart))
        for k in (1, 3, 4):
            _equal_shards(fp.column_partition(g, k),
                          ref_fp.column_partition(jg, k))
            _equal_shards(fp.replicated(g, k), ref_fp.replicated(jg, k))
        for r, c in ((1, 1), (2, 3), (4, 2)):
            _equal_shards(fp.twod_partition(g, r, c),
                          ref_fp.twod_partition(jg, r, c))


def _equal_minibatch(ours, theirs):
    for field in ("targets", "input_features", "labels"):
        a, b = getattr(ours, field), getattr(theirs, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    for name in ("layer_vertices", "layer_adj"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y), name


def test_partition_batches_match_reference(graphs, skewed):
    for jg, g in (graphs, skewed):
        for jpart, part in _partitions(jg, g):
            for w in range(part.num_parts):
                _equal_minibatch(pb.partition_minibatch(g, part, w),
                                 ref_pb.partition_minibatch(jg, jpart, w))
                for hops in (1, 2):
                    _equal_minibatch(
                        pb.expanded_partition_minibatch(g, part, w, hops=hops,
                                                        num_layers=3),
                        ref_pb.expanded_partition_minibatch(
                            jg, jpart, w, hops=hops, num_layers=3))
    for kw in ({}, dict(local_steps=2, rounds=3), dict(local_steps=0)):
        assert pb.LLCGSchedule(**kw).plan() == ref_pb.LLCGSchedule(**kw).plan()


def test_boundary_mask_matches_reference(graphs, skewed):
    for jg, g in (graphs, skewed):
        for jpart, part in _partitions(jg, g):
            ours = training.boundary_mask_for(g, part)
            theirs = ref_training.boundary_mask_for(jg, jpart)
            assert ours.dtype == theirs.dtype
            assert np.array_equal(ours, theirs)
            assert ours.any() == (part.num_parts > 1)


def test_dense_adj_equals_the_host_array(graphs):
    """The trainers' device-built adjacency is `to_dense_adj` bit for bit:
    on the SBM graph and on a graph with repeated edges and a self loop."""
    src, dst = np.array([0, 0, 1, 2, 3, 3, 4]), np.array([1, 1, 2, 2, 0, 4, 3])
    pairs = (graphs, (ref_from_edges(src, dst, 6), from_edges(src, dst, 6)))
    for jg, g in pairs:
        ours = training.dense_adj(g, CPU).numpy()
        theirs = jg.to_dense_adj()
        assert ours.dtype == theirs.dtype
        assert np.array_equal(ours, theirs)
        assert np.array_equal(ours, g.to_dense_adj())


def test_device_batch_matches_reference(graphs):
    jg, g = graphs
    targets = np.where(g.train_mask)[0][:13]
    mb = node_wise_sample(g, targets, (5, 5), np.random.default_rng(4))
    jmb = ref_node_wise(jg, targets, (5, 5), np.random.default_rng(4))
    adjs, self_idx, X, yb, wb = training._device_batch(mb, CPU)
    jadjs, jself, jX, jyb, jwb = ref_training._device_batch(jmb)
    assert len(adjs) == len(jadjs) == 2
    for ours, theirs in [*zip(adjs, jadjs), *zip(self_idx, jself),
                         (X, jX), (yb, jyb), (wb, jwb)]:
        assert np.array_equal(ours.numpy(), np.asarray(theirs))
    assert wb.shape == (16,) and float(wb.sum()) == 13.0
    assert training._pad_pow2(1) == 8 and training._pad_pow2(9) == 16


_LAZY_CODE = """
import importlib, json, sys
pkgs = ["repro_torch.core", "repro_torch.core.execution",
        "repro_torch.core.protocols", "repro_torch.core.partition"]
for p in pkgs:
    importlib.import_module(p)
eager = "torch" in sys.modules
# the sampling workers' numpy-only submodules
import repro_torch.core.sampling.partition_batch
import repro_torch.core.execution.bucketing
import repro_torch.core.protocols.sync
import repro_torch.core.partition.feature_partition
eager = eager or "torch" in sys.modules
names = {}
for p in pkgs:
    mod = sys.modules[p]
    names[p] = sorted(mod.__all__)
    for n in mod.__all__:
        obj = getattr(mod, n)
        src = importlib.import_module(mod._EXPORTS[n])
        assert getattr(src, n) is obj, (p, n)
    try:
        getattr(mod, "no_such_name")
    except AttributeError:
        pass
    else:
        raise AssertionError(p)
from repro_torch.core.execution import collectives  # a submodule still imports
print(json.dumps({"eager": eager, "names": names}))
"""


def test_lazy_exports():
    """The four packages export lazily: importing them (and the numpy-only
    submodules the sampling workers import) imports no torch; every name
    resolves to its submodule's object; core's names are the
    reference's."""
    import json

    import repro.core

    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_LAZY_CODE)],
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["eager"] is False
    names = out["names"]
    assert names["repro_torch.core"] == sorted(repro.core.__all__)
    from repro.core import execution as ref_execution

    # the port's SpMM models take a process grid; it has no
    # gathered_table_peak_bytes
    assert (set(names["repro_torch.core.execution"])
            == set(ref_execution.__all__) - {"gathered_table_peak_bytes"}
            | {"ProcessGrid", "process_grid"})
    assert {"PROTOCOL_COSTS", "ProtocolCost", "broadcast_cost",
            "STALENESS_MODELS", "pipegcn_mix"} <= set(
                names["repro_torch.core.protocols"])
    assert {"FeatureShards", "row_partition", "twod_partition",
            "PARTITIONERS", "VERTEX_CUTS"} <= set(
                names["repro_torch.core.partition"])
