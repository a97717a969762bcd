"""The port's replica families on one rank: `repro_torch`'s vertex cut
(cartesian2d, the engine default) and PowerLyra hybrid cut for gcn, sage,
gin and gat under broadcast, the ring and p2p, on the CPU against the JAX
engine on a 1-device Auto-axis mesh (Pallas interpret): the training step,
the reference step, the sweep and the reference sweep within 1e-4 for
every param key, from the reference's own initial weights, on a graph with
isolated vertices, at exchange_chunks 1 and 2 (the JAX engine at 1: the
chunks do not change its numbers); CommStats equal.  Also:
`reference_combine` and `reference_combine_max` against `repro`'s function
by function; the family anchor (under sync the vertex-cut and hybrid
references compute the global GNN, so their losses equal the edge-cut
reference's within 1e-4; gcn's bit for bit at one rank); and the port's
counterpart of the reference's config guards.  The combines' collectives
run in `test_torch_distributed.py` on four gloo ranks."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.core.engine import DistGNNEngine as JDistGNNEngine
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.execution import replica_sync as jreplica_sync
from repro.core.graph import er_graph as jer_graph
from repro_torch.core.engine import DistGNNEngine, EngineConfig
from repro_torch.core.execution import replica_sync
from repro_torch.core.graph import er_graph
from repro_torch.core.models.gnn import PARAM_KEYS, params_from_numpy
from repro_torch.core.partition.edge_cut import hash_partition

ORACLE_TOL = 1e-4  # the repo's oracle bound for every step and sweep
CPU = torch.device("cpu")
# dims [24, 16, 16, 5]; average in-degree 3 leaves some vertices isolated
GRAPH = dict(num_vertices=120, avg_degree=3, feature_dim=24, num_classes=5,
             seed=1)
STEPS = 2
MODELS = ("gcn", "sage", "gin", "gat")
FAMILIES = ("vertex_cut", "hybrid")
EXECUTIONS = ("broadcast", "ring", "p2p")


def _cfg(make, family, model, execution, chunks=1, **kw):
    return make(partition_family=family, execution=execution,
                partitioner="hash", model=model, hidden=16, num_layers=3,
                exchange_chunks=chunks, **kw)


def _close(ours, theirs, what=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               atol=ORACLE_TOL, rtol=0, err_msg=what)


@pytest.mark.parametrize("execution", EXECUTIONS)
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("family", FAMILIES)
def test_replica_step_and_sweep_match_jax(family, model, execution):
    g, jg = er_graph(**GRAPH), jer_graph(**GRAPH)
    assert (g.degree() == 0).any(), "the graph should have isolated vertices"
    mesh = jax.make_mesh((1,), ("w",), axis_types=(AxisType.Auto,))
    jeng = JDistGNNEngine(jg, mesh=mesh, cfg=_cfg(
        JEngineConfig, family, model, execution, interpret=True))
    jstate0 = jeng.init_state()
    jparams = jax.tree.map(jnp.asarray, jstate0["params"])
    jstep, jref_step = jeng.make_step(), jeng.make_reference_step()
    jrun, jstate, jref_state = [], jstate0, jstate0
    for _ in range(STEPS):
        jstate, jm, jlogits = jstep(jstate)
        jref_state, jrm, jref_logits = jref_step(jref_state)
        jrun.append((float(jm["loss"]), float(jrm["loss"]), jlogits,
                     jref_logits))
    jemb = jeng.global_embeddings(jeng.infer_full_graph(params=jparams))
    jref = jeng.global_embeddings(jeng.infer_full_graph(params=jparams,
                                                        reference=True))
    jeng.train(2)
    params = params_from_numpy(jax.tree.map(np.asarray, jstate0["params"]),
                               CPU)
    for chunks in (1, 2):
        eng = DistGNNEngine(g, _cfg(EngineConfig, family, model, execution,
                                    chunks), device=CPU)
        assert (eng.nb, eng.Vp, eng.K) == (jeng.nb, jeng.Vp, jeng.K)
        state = ref_state = eng.init_state(params=params)
        step, ref_step = eng.make_step(), eng.make_reference_step()
        for i, (jl, jrl, jlogits, jref_logits) in enumerate(jrun):
            state, metrics, logits = step(state)
            ref_state, ref_metrics, ref_logits = ref_step(ref_state)
            loss = float(metrics["loss"])
            for other in (ref_metrics["loss"], jl, jrl):
                assert abs(loss - float(other)) <= ORACLE_TOL, (i, loss, other)
            _close(logits, jlogits, f"logits {i}")
            _close(ref_logits, jref_logits, f"reference logits {i}")
        for ours, ref, theirs, jr in zip(state["params"]["layers"],
                                         ref_state["params"]["layers"],
                                         jstate["params"]["layers"],
                                         jref_state["params"]["layers"]):
            for key in PARAM_KEYS[model]:
                _close(ours[key], theirs[key], key)
                _close(ref[key], jr[key], key)
        emb = eng.global_embeddings(eng.infer_full_graph(params=params))
        ref = eng.global_embeddings(eng.infer_full_graph(params=params,
                                                         reference=True))
        assert emb.shape == (g.num_vertices, 5) and np.isfinite(emb).all()
        _close(emb, jemb, "sweep")
        _close(ref, jref, "reference sweep")
        eng.train(2)
        assert (dataclasses.asdict(eng.comm_stats)
                == dataclasses.asdict(jeng.comm_stats))


def test_reference_combines_match_repro():
    """`reference_combine` and `reference_combine_max` against `repro`'s
    on a [k, nv, D] partial with pad slots and repeated vertices (the max
    combine on values >= 0, its contract)."""
    rng = np.random.default_rng(0)
    k, nv, D, V = 3, 7, 5, 9
    vert_ids = rng.integers(0, V + 1, (k, nv))
    vert_ids[:, -1] = V  # a pad slot on every rank
    partial = rng.standard_normal((k, nv, D)).astype(np.float32)
    ours = replica_sync.reference_combine(torch.from_numpy(partial),
                                          torch.from_numpy(vert_ids), V)
    theirs = jreplica_sync.reference_combine(
        jnp.asarray(partial), jnp.asarray(vert_ids, jnp.int32), V)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-6,
                               rtol=0)
    nonneg = np.abs(partial)
    ours = replica_sync.reference_combine_max(torch.from_numpy(nonneg),
                                              torch.from_numpy(vert_ids), V)
    theirs = jreplica_sync.reference_combine_max(
        jnp.asarray(nonneg), jnp.asarray(vert_ids, jnp.int32), V)
    assert np.array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("model", ("gcn", "gat"))
def test_family_anchor_to_edge_cut(model):
    """Under sync the replica families' references compute the global
    GNN: from the same weights their losses equal the edge-cut
    reference's within 1e-4, and so do the distributed runs.  gcn at one
    rank is the edge-cut run bit for bit (the same owned-edge ELL, and the
    combine of one replica is a copy); gat is not, its stabilizer is
    floored at 0."""
    g = er_graph(**GRAPH)
    base = DistGNNEngine(g, _cfg(EngineConfig, "edge_cut", model, "p2p"),
                         device=CPU)
    params = base.init_state()["params"]
    runs = {}
    for family in ("edge_cut",) + FAMILIES:
        eng = DistGNNEngine(g, _cfg(EngineConfig, family, model, "p2p"),
                            device=CPU)
        out = []
        for step in (eng.make_step(), eng.make_reference_step()):
            state, losses = eng.init_state(params=params), []
            for _ in range(3):
                state, metrics, _ = step(state)
                losses.append(float(metrics["loss"]))
            out.append(losses)
        runs[family] = out
    for family in FAMILIES:
        for ours, theirs in zip(runs[family], runs["edge_cut"]):
            gap = max(abs(a - b) for a, b in zip(ours, theirs))
            assert gap <= ORACLE_TOL, (family, gap)
            if model == "gcn":
                assert ours == theirs, family


def test_replica_families_reject_bad_config():
    """The counterpart of the reference's `test_vertex_cut_rejects_bad_config`
    and `test_hybrid_rejects_bad_config`: an unknown family or vertex cut,
    a mini-batch mode, an edge-cut `partition=` under vertex_cut, and a
    negative or NaN hub threshold raise ValueError."""
    g = er_graph(32, avg_degree=4, seed=0)
    bad = [dict(partition_family="nope"),
           dict(partition_family="vertex_cut", vertex_cut="nope"),
           dict(partition_family="vertex_cut", batching="node_wise"),
           dict(partition_family="hybrid", hub_threshold=-1.0),
           dict(partition_family="hybrid", hub_threshold=np.nan),
           dict(partition_family="hybrid", batching="node_wise")]
    for kw in bad:
        with pytest.raises(ValueError):
            DistGNNEngine(g, EngineConfig(**kw), device=CPU)
    with pytest.raises(ValueError, match="edge-cut Partition"):
        DistGNNEngine(g, EngineConfig(partition_family="vertex_cut"),
                      hash_partition(g, 1), device=CPU)
