"""The port's sage and gin models on one rank: `repro_torch`'s synchronous
full-graph training step and layer-wise sweep on the CPU against the JAX
engine's distributed step and sweep (Pallas ELL in interpret mode with its
scatter-add gradient, one device on an Auto-axis mesh) and its single-device
references, from the reference's own initial weights carried over (gin's
0-d eps among them); determinism; no kernel launch on the CPU; the
parameters; exchange widths and CommStats equal to gcn's (self-feature
locality); and the entry points."""
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
from repro.core.partition import cost_models as jcost
from repro_torch.core.engine import DistGNNEngine, EngineConfig
from repro_torch.core.graph import er_graph, sbm_graph
from repro_torch.core.models.gnn import (
    PARAM_KEYS,
    init_gnn_params,
    params_from_numpy,
)
from repro_torch.core.partition import cost_models
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
MODELS = ("sage", "gin")


def _engines(model, chunks):
    g, jg = er_graph(**GRAPH), jer_graph(**GRAPH)
    eng = DistGNNEngine(g, EngineConfig(model=model, hidden=16, num_layers=3,
                                        exchange_chunks=chunks), device=CPU)
    mesh = jax.make_mesh((1,), ("w",), axis_types=(AxisType.Auto,))
    jeng = JDistGNNEngine(jg, mesh=mesh, cfg=JEngineConfig(
        execution="broadcast", protocol="sync", partitioner="hash",
        model=model, hidden=16, num_layers=3, exchange_chunks=chunks,
        interpret=True))
    return g, eng, jeng


def _close(ours: torch.Tensor, theirs) -> None:
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                               atol=ORACLE_TOL, rtol=0)


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("model", MODELS)
def test_step_matches_jax_step_and_reference_step(model, chunks):
    g, eng, jeng = _engines(model, chunks)
    assert (g.degree() == 0).any(), "the graph should have isolated vertices"
    assert eng.dims == jeng.dims == [24, 16, 16, 5]
    keys = PARAM_KEYS[model]
    jstate = jeng.init_state()
    params = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]), CPU)
    assert all(set(p) == set(keys) for p in params["layers"])
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
        assert set(ours) == set(ref) == set(theirs) == set(keys)
        for key in keys:
            assert ours[key].shape == init[key].shape, key
            if key != "b":  # the last layer's bias may barely move
                assert not torch.equal(ours[key], init[key]), key
            for other in (theirs[key], jref[key]):
                _close(ours[key], other)
            _close(ref[key], jref[key])


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("model", MODELS)
def test_sweep_matches_jax_sweep_and_reference(model, chunks):
    g, eng, jeng = _engines(model, chunks)
    jparams = jinit_gnn_params(model, jeng.dims, jax.random.PRNGKey(0))
    if model == "gin":  # a non-zero eps, so the self term is weighed
        jparams = {"layers": [dict(p, eps=p["eps"] + 0.25 * (l + 1))
                              for l, p in enumerate(jparams["layers"])]}
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
    deg0 = g.degree() == 0
    assert deg0.any()
    np.testing.assert_allclose(emb[deg0], jref[deg0], atol=ORACLE_TOL, rtol=0)


@pytest.mark.parametrize("model", MODELS)
def test_training_and_sweeps_are_bitwise_deterministic(model):
    _, eng, _ = _engines(model, 2)
    l1, logits1 = eng.train(3)
    l2, logits2 = eng.train(3)
    assert l1 == l2 and torch.equal(logits1, logits2)
    state = eng.init_state()
    step = eng.make_step()
    a, b = step(state), step(state)  # one state stepped twice
    for pa, pb in zip(a[0]["params"]["layers"], b[0]["params"]["layers"]):
        assert all(torch.equal(pa[key], pb[key]) for key in PARAM_KEYS[model])
    params = state["params"]
    assert torch.equal(eng.infer_full_graph(params=params),
                       eng.infer_full_graph(params=params))


@pytest.mark.parametrize("model", MODELS)
def test_single_device_paths_agree_and_learn(model):
    """The step and the reference step agree and the loss falls at every
    step."""
    g = sbm_graph(64, num_blocks=4, p_in=0.1, p_out=0.01, seed=1)
    eng = DistGNNEngine(g, EngineConfig(model=model, hidden=16, lr=0.3),
                        device=CPU)
    ld, _ = eng.train(8)
    lr_, _ = eng.train(8, reference=True)
    assert max(abs(a - b) for a, b in zip(ld, lr_)) < ORACLE_TOL
    assert all(b < a for a, b in zip(ld, ld[1:])), ld


@pytest.mark.parametrize("model", MODELS)
def test_cpu_runs_launch_no_kernel(model):
    _, eng, _ = _engines(model, 2)
    counters = (ell_spmm, ell_spmm_transpose, ell_attend_dw, sddmm,
                ell_slot_transpose)
    before = [f.launches for f in counters]
    eng.train(1)
    eng.train(1, reference=True)
    params = eng.init_state()["params"]
    eng.infer_full_graph(params=params)
    eng.infer_full_graph(params=params, reference=True)
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("model", MODELS)
def test_params_keys_shapes_distribution_and_carry_over(model):
    dims = [64, 48, 8]
    keys = PARAM_KEYS[model]
    p1 = init_gnn_params(model, dims, torch.Generator().manual_seed(3), CPU)
    p2 = init_gnn_params(model, dims, torch.Generator().manual_seed(3), CPU)
    jparams = jinit_gnn_params(model, dims, jax.random.PRNGKey(0))
    for a, b, j, (di, do) in zip(p1["layers"], p2["layers"],
                                 jparams["layers"], zip(dims[:-1], dims[1:])):
        assert tuple(a) == keys and set(j) == set(keys)
        for key in keys:  # the reference's shapes, the same seed's bits
            assert tuple(a[key].shape) == tuple(np.shape(j[key])), key
            assert a[key].dtype == torch.float32 and torch.equal(a[key], b[key])
        if model == "sage":
            assert not a["b"].any()
            mats = (("w_self", di), ("w_nbr", di))
        else:
            assert a["eps"].dim() == 0 and float(a["eps"]) == 0.0
            mats = (("w1", di), ("w2", do))
        for key, fan_in in mats:
            assert abs(float(a[key].std()) * fan_in ** 0.5 - 1.0) < 0.15, key
    # the reference's own tree carries over key for key, gin's 0-d eps too
    ported = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    for ours, theirs in zip(ported["layers"], jparams["layers"]):
        assert set(ours) == set(theirs)
        for key in theirs:
            assert tuple(ours[key].shape) == tuple(np.shape(theirs[key]))
            assert np.array_equal(ours[key].numpy(), np.asarray(theirs[key]))


@pytest.mark.parametrize("model", MODELS)
def test_exchange_widths_and_comm_stats_equal_gcn(model):
    """sage and gin read their self rows from the rank's own block, so they
    ship exactly gcn's bytes (the port's counterpart of
    `test_model_property.py::test_self_feature_locality_zero_extra_bytes`),
    and both packages' accounting agrees."""
    dims = [24, 16, 16, 5]
    widths = cost_models.model_exchange_widths(model, dims)
    assert widths == cost_models.model_exchange_widths("gcn", dims)
    assert widths == jcost.model_exchange_widths(model, dims)
    _, eng, jeng = _engines(model, 1)
    gcn = DistGNNEngine(er_graph(**GRAPH), EngineConfig(hidden=16,
                                                        num_layers=3),
                        device=CPU)
    assert (eng.inference_bytes_per_sweep() == gcn.inference_bytes_per_sweep()
            == jeng.inference_bytes_per_sweep())
    eng.train(2)
    gcn.train(2)
    jeng.train(2)
    assert (dataclasses.asdict(eng.comm_stats) == dataclasses.asdict(
        gcn.comm_stats) == dataclasses.asdict(jeng.comm_stats))


@pytest.mark.parametrize("model", MODELS)
def test_train_gnn_main_on_cpu(model):
    out = train_gnn.main(["--model", model, "--device", "cpu", "--vertices",
                          "96", "--layers", "3", "--hidden", "16",
                          "--exchange-chunks", "2", "--epochs", "5", "--lr",
                          "0.3", "--oracle-check", "--infer"])
    assert np.isfinite(out["losses"]).all() and out["losses"][-1] < out["losses"][0]
    assert out["oracle_gap"] <= ORACLE_TOL and out["infer_gap"] <= ORACLE_TOL
    assert set(out["state"]["params"]["layers"][0]) == set(PARAM_KEYS[model])


@pytest.mark.parametrize("model", MODELS)
def test_serve_gnn_main_on_cpu(model):
    emb, wall = serve_gnn.main(["--model", model, "--device", "cpu",
                                "--vertices", "64", "--layers", "3",
                                "--exchange-chunks", "2", "--oracle-check"])
    assert emb.shape == (64, 8) and np.isfinite(emb).all() and wall > 0
