"""The port's ring execution model on one rank: `repro_torch`'s ring for gcn,
sage, gin and gat (gat through its one-pass online-softmax ring) on the CPU
against the JAX engine's ring on a 1-device Auto-axis mesh (Pallas
interpret): the training step, the reference step and the sweep within 1e-4
for every param key, from the reference's own initial weights, on a graph
with isolated vertices; CommStats equal.  Also: at one rank the ring's one
round reads the rank's own block with the broadcast path's kernels over the
same rows, so it gives the broadcast path's bits; the ring ignores
exchange_chunks; and on the CPU the ring launches no kernel and issues no
rotation.  The rotation itself runs in `test_torch_distributed.py` on four
gloo ranks."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.core.engine import DistGNNEngine as JDistGNNEngine
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.graph import er_graph as jer_graph
from repro_torch.core.engine import DistGNNEngine, EngineConfig
from repro_torch.core.execution import collectives
from repro_torch.core.graph import er_graph
from repro_torch.core.models.gnn import PARAM_KEYS, params_from_numpy
from repro_torch.kernels.ops import ell_attend_dw, ell_spmm, ell_spmm_transpose

ORACLE_TOL = 1e-4  # the repo's oracle bound for every step and sweep
CPU = torch.device("cpu")
# dims [24, 16, 16, 5]; average in-degree 3 leaves some vertices isolated
GRAPH = dict(num_vertices=120, avg_degree=3, feature_dim=24, num_classes=5,
             seed=1)
STEPS = 3
MODELS = ("gcn", "sage", "gin", "gat")


def _engine(g, model, execution="ring", chunks=1):
    return DistGNNEngine(g, EngineConfig(
        execution=execution, partitioner="hash", model=model, hidden=16,
        num_layers=3, exchange_chunks=chunks), device=CPU)


def _close(ours: torch.Tensor, theirs) -> None:
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               atol=ORACLE_TOL, rtol=0)


@pytest.mark.parametrize("model", MODELS)
def test_ring_step_and_sweep_match_jax(model):
    g, jg = er_graph(**GRAPH), jer_graph(**GRAPH)
    assert (g.degree() == 0).any(), "the graph should have isolated vertices"
    eng = _engine(g, model)
    mesh = jax.make_mesh((1,), ("w",), axis_types=(AxisType.Auto,))
    jeng = JDistGNNEngine(jg, mesh=mesh, cfg=JEngineConfig(
        execution="ring", protocol="sync", partitioner="hash", model=model,
        hidden=16, num_layers=3, interpret=True))
    assert eng.playout.table_rows == eng.nb == jeng.nb
    jstate = jeng.init_state()
    params = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]), CPU)
    state = ref_state = eng.init_state(params=params)
    jref_state = jstate
    step, ref_step = eng.make_step(), eng.make_reference_step()
    jstep, jref_step = jeng.make_step(), jeng.make_reference_step()
    for i in range(STEPS):
        state, metrics, logits = step(state)
        ref_state, ref_metrics, ref_logits = ref_step(ref_state)
        jstate, jmetrics, jlogits = jstep(jstate)
        jref_state, jref_metrics, jref_logits = jref_step(jref_state)
        loss = float(metrics["loss"])
        for other in (ref_metrics["loss"], jmetrics["loss"],
                      jref_metrics["loss"]):
            assert abs(loss - float(other)) <= ORACLE_TOL, (i, loss, other)
        _close(logits, jlogits)
        _close(ref_logits, jref_logits)
        assert float(metrics["rows_pushed"]) == 0.0
    for ours, ref, theirs, jref in zip(state["params"]["layers"],
                                       ref_state["params"]["layers"],
                                       jstate["params"]["layers"],
                                       jref_state["params"]["layers"]):
        for key in PARAM_KEYS[model]:
            _close(ours[key], theirs[key])
            _close(ref[key], jref[key])
    emb = eng.global_embeddings(eng.infer_full_graph(params=params))
    ref = eng.global_embeddings(eng.infer_full_graph(params=params,
                                                     reference=True))
    jparams = jax.tree.map(jax.numpy.asarray, jeng.init_state()["params"])
    jemb = jeng.global_embeddings(jeng.infer_full_graph(params=jparams))
    jref = jeng.global_embeddings(jeng.infer_full_graph(params=jparams,
                                                        reference=True))
    assert emb.shape == (g.num_vertices, 5) and np.isfinite(emb).all()
    _close(emb, jemb)
    _close(ref, jref)
    eng.train(2)
    jeng.train(2)
    assert (dataclasses.asdict(eng.comm_stats)
            == dataclasses.asdict(jeng.comm_stats))


@pytest.mark.parametrize("model", MODELS)
def test_ring_equals_broadcast_on_one_rank(model):
    """One rank: the ring's single round multiplies the rank's own block
    with the broadcast ids, except that a pad slot names row 0 under mask 0
    where broadcast names the zero row.  Both paths skip masked slots in
    the forward and the transpose plan, and dw's product with row 0 on a
    pad slot is zeroed by the softmax's (e > -1e29) factor, as the zero
    row's is; gat's running max of one round is the broadcast max, and
    round 0 starts num and den from its own terms.  So the step, the sweep
    and the new params are the broadcast path's bits (checked: equal)."""
    g = er_graph(**GRAPH)
    outs = []
    for execution in ("broadcast", "ring"):
        eng = _engine(g, model, execution)
        state = eng.init_state()
        state2, metrics, logits = eng.make_step()(state)
        sweep = eng.infer_full_graph(params=state["params"])
        outs.append([metrics["loss"], logits, sweep] + [
            p[key] for p in state2["params"]["layers"]
            for key in PARAM_KEYS[model]])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("model", ("gcn", "gat"))
def test_ring_ignores_exchange_chunks_and_launches_nothing_on_the_cpu(model):
    g = er_graph(**GRAPH)
    runs = []
    for chunks in (1, 2):
        eng = _engine(g, model, chunks=chunks)
        collectives.zero_calls()
        launches = (ell_spmm.launches, ell_spmm_transpose.launches,
                    ell_attend_dw.launches)
        losses, logits = eng.train(2)
        assert (ell_spmm.launches, ell_spmm_transpose.launches,
                ell_attend_dw.launches) == launches
        assert collectives.read_calls()["ppermute"] == 0
        runs.append((losses, logits))
    assert runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])
