"""The port's GAT slice as a whole: `repro_torch`'s synchronous full-graph
GAT training step and layer-wise GAT sweep on the CPU against the JAX
engine's distributed step and sweep (Pallas SDDMM and ELL in interpret mode
with their gradient rules, one device on an Auto-axis mesh) and its
single-device references, from the reference's own initial weights carried
over; CommStats and inference bytes; determinism; the entry points; the GAT
parameters; and an unknown model refused."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.core.engine import DistGNNEngine as JDistGNNEngine
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.graph import er_graph as jer_graph
from repro.core.models.gnn import init_gnn_params as jinit_gnn_params
from repro_torch.core.engine import DistGNNEngine, EngineConfig
from repro_torch.core.graph import er_graph, sbm_graph
from repro_torch.core.models.gnn import init_gnn_params, params_from_numpy
from repro_torch.kernels.ops import (
    ell_attend_dw,
    ell_slot_transpose,
    ell_spmm,
    ell_spmm_transpose,
    sddmm,
)
from repro_torch.launch import serve_gnn, train_gnn

ORACLE_TOL = 1e-4  # the repo's oracle bound for every step and sweep
CPU = torch.device("cpu")
# dims [24, 16, 16, 5]; average in-degree 3 leaves some vertices isolated
GRAPH = dict(num_vertices=120, avg_degree=3, feature_dim=24, num_classes=5,
             seed=1)
STEPS = 3
GAT_KEYS = ("w", "a_src", "a_dst")


def _engines(chunks):
    g, jg = er_graph(**GRAPH), jer_graph(**GRAPH)
    eng = DistGNNEngine(g, EngineConfig(execution="broadcast",
                                        partitioner="hash", model="gat",
                                        hidden=16, num_layers=3,
                                        exchange_chunks=chunks), device=CPU)
    mesh = jax.make_mesh((1,), ("w",), axis_types=(AxisType.Auto,))
    jeng = JDistGNNEngine(jg, mesh=mesh, cfg=JEngineConfig(
        execution="broadcast", protocol="sync", partitioner="hash",
        model="gat", hidden=16, num_layers=3, exchange_chunks=chunks,
        interpret=True))
    return g, eng, jeng


def _close(ours: torch.Tensor, theirs) -> None:
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                               atol=ORACLE_TOL, rtol=0)


@pytest.mark.parametrize("chunks", [1, 2])
def test_gat_step_matches_jax_step_and_reference_step(chunks):
    g, eng, jeng = _engines(chunks)
    assert (g.degree() == 0).any(), "the graph should have isolated vertices"
    assert eng.dims == jeng.dims == [24, 16, 16, 5]
    jstate = jeng.init_state()
    params = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]), CPU)
    assert all(set(p) == set(GAT_KEYS) for p in params["layers"])
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
        for other in (jlogits, jref_logits):
            _close(logits, other)
        _close(ref_logits, jref_logits)
    for ours, ref, theirs, jref, init in zip(state["params"]["layers"],
                                             ref_state["params"]["layers"],
                                             jstate["params"]["layers"],
                                             jref_state["params"]["layers"],
                                             params["layers"]):
        assert set(ours) == set(ref) == set(theirs) == set(GAT_KEYS)
        for key in GAT_KEYS:
            assert not torch.equal(ours[key], init[key]), key  # it trained
            for other in (theirs[key], jref[key]):
                _close(ours[key], other)
            _close(ref[key], jref[key])


@pytest.mark.parametrize("chunks", [1, 2])
def test_gat_sweep_matches_jax_sweep_and_reference(chunks):
    g, eng, jeng = _engines(chunks)
    jparams = jinit_gnn_params("gat", jeng.dims, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    emb = eng.global_embeddings(eng.infer_full_graph(params=params))
    ref = eng.global_embeddings(eng.infer_full_graph(params=params,
                                                     reference=True))
    jemb = jeng.global_embeddings(jeng.infer_full_graph(params=jparams))
    jref = jeng.global_embeddings(jeng.infer_full_graph(params=jparams,
                                                        reference=True))
    assert emb.shape == (g.num_vertices, 5) and np.isfinite(emb).all()
    for other in (jemb, jref, ref):
        np.testing.assert_allclose(emb, other, atol=ORACLE_TOL, rtol=0)
    # degree-0 vertices fall back to their own transformed row
    deg0 = g.degree() == 0
    assert deg0.any()
    np.testing.assert_allclose(emb[deg0], jref[deg0], atol=ORACLE_TOL, rtol=0)


def test_gat_comm_stats_and_inference_bytes_equal_jax():
    _, eng, jeng = _engines(1)
    assert eng.inference_bytes_per_sweep() == jeng.inference_bytes_per_sweep()
    jeng.train(2)
    eng.train(2)
    assert dataclasses.asdict(eng.comm_stats) == dataclasses.asdict(
        jeng.comm_stats)
    jparams = jinit_gnn_params("gat", jeng.dims, jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    eng.infer_full_graph(params=params)
    jeng.infer_full_graph(params=jparams)
    assert eng.comm_stats.inference_bytes == jeng.comm_stats.inference_bytes


def test_gat_training_and_sweeps_are_bitwise_deterministic():
    _, eng, _ = _engines(2)
    l1, logits1 = eng.train(3)
    l2, logits2 = eng.train(3)
    assert l1 == l2 and torch.equal(logits1, logits2)
    state = eng.init_state()
    step = eng.make_step()
    a, b = step(state), step(state)  # one state stepped twice
    for pa, pb in zip(a[0]["params"]["layers"], b[0]["params"]["layers"]):
        assert all(torch.equal(pa[key], pb[key]) for key in GAT_KEYS)
    params = state["params"]
    s1 = eng.infer_full_graph(params=params)
    s2 = eng.infer_full_graph(params=params)
    assert torch.equal(s1, s2)


def test_gat_single_device_paths_agree_and_learn():
    """The step and the reference step agree and the loss falls at every
    step at the launcher's learning rate."""
    g = sbm_graph(64, num_blocks=4, p_in=0.1, p_out=0.01, seed=1)
    eng = DistGNNEngine(g, EngineConfig(model="gat", hidden=16, lr=0.3),
                        device=CPU)
    ld, _ = eng.train(8)
    lr_, _ = eng.train(8, reference=True)
    assert max(abs(a - b) for a, b in zip(ld, lr_)) < ORACLE_TOL
    assert all(b < a for a, b in zip(ld, ld[1:])), ld


def test_cpu_gat_launches_no_kernel():
    _, eng, _ = _engines(2)
    counters = (ell_spmm, ell_spmm_transpose, ell_attend_dw, sddmm,
                ell_slot_transpose)
    before = [f.launches for f in counters]
    eng.train(1)
    eng.train(1, reference=True)
    eng.infer_full_graph(params=eng.init_state()["params"], reference=True)
    assert [f.launches for f in counters] == before


def test_train_gnn_main_gat_on_cpu():
    out = train_gnn.main(["--model", "gat", "--device", "cpu", "--vertices",
                          "96", "--layers", "3", "--hidden", "16",
                          "--exchange-chunks", "2", "--epochs", "5", "--lr",
                          "0.3", "--oracle-check", "--infer"])
    assert np.isfinite(out["losses"]).all() and out["losses"][-1] < out["losses"][0]
    assert out["oracle_gap"] <= ORACLE_TOL and out["infer_gap"] <= ORACLE_TOL
    assert set(out["state"]["params"]["layers"][0]) == set(GAT_KEYS)


def test_serve_gnn_main_gat_on_cpu():
    emb, wall = serve_gnn.main(["--model", "gat", "--device", "cpu",
                                "--vertices", "64", "--layers", "3",
                                "--exchange-chunks", "2", "--oracle-check"])
    assert emb.shape == (64, 8) and np.isfinite(emb).all() and wall > 0


def test_gat_params_distribution_and_carry_over():
    dims = [64, 48, 8]
    p1 = init_gnn_params("gat", dims, torch.Generator().manual_seed(3), CPU)
    p2 = init_gnn_params("gat", dims, torch.Generator().manual_seed(3), CPU)
    for a, b, (di, do) in zip(p1["layers"], p2["layers"],
                              zip(dims[:-1], dims[1:])):
        assert set(a) == set(GAT_KEYS)
        assert tuple(a["w"].shape) == (di, do)
        assert tuple(a["a_src"].shape) == tuple(a["a_dst"].shape) == (do,)
        assert all(torch.equal(a[key], b[key]) for key in GAT_KEYS)
        assert abs(float(a["w"].std()) * di ** 0.5 - 1.0) < 0.15
    a = torch.cat([p["a_src"] for p in p1["layers"] * 20])
    assert 0.3 < float(a.std()) * 48 ** 0.5 < 2.0
    # the reference's own GAT tree carries over key for key
    jparams = jinit_gnn_params("gat", dims, jax.random.PRNGKey(0))
    ported = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    for ours, theirs in zip(ported["layers"], jparams["layers"]):
        assert set(ours) == set(theirs)
        for key in theirs:
            assert np.array_equal(ours[key].numpy(), np.asarray(theirs[key]))


def test_unknown_model_is_rejected():
    g = er_graph(**GRAPH)
    with pytest.raises(ValueError, match="model must be one of"):
        DistGNNEngine(g, EngineConfig(model="gatv2"), device=CPU)
    with pytest.raises(ValueError, match="model must be one of"):
        init_gnn_params("gatv2", [8, 4], torch.Generator(), CPU)
