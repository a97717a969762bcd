"""The port's training slice as a whole: `repro_torch`'s synchronous
full-graph GCN training step on the CPU against the JAX engine's distributed
step (Pallas ELL in interpret mode with its scatter-add gradient, one device
on an Auto-axis mesh) and its single-device reference step, from the
reference's own initial weights carried over; the single-device paths
agreeing and learning; determinism; accuracy and CommStats; the training
entry point; the engine's guards; and each historical-embedding protocol
on one rank."""
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
from repro_torch.core.graph import er_graph, sbm_graph
from repro_torch.core.models.gnn import params_from_numpy
from repro_torch.kernels.ell_spmm import ell_spmm, ell_spmm_transpose
from repro_torch.launch import train_gnn

ORACLE_TOL = 1e-4  # the repo's oracle bound for every step
CPU = torch.device("cpu")
# dims [24, 16, 16, 5]; average in-degree 3 leaves some vertices isolated
GRAPH = dict(num_vertices=120, avg_degree=3, feature_dim=24, num_classes=5,
             seed=1)
STEPS = 3


def _engines(chunks):
    g, jg = er_graph(**GRAPH), jer_graph(**GRAPH)
    eng = DistGNNEngine(g, EngineConfig(execution="broadcast",
                                        partitioner="hash", hidden=16,
                                        num_layers=3, exchange_chunks=chunks),
                        device=CPU)
    mesh = jax.make_mesh((1,), ("w",), axis_types=(AxisType.Auto,))
    jeng = JDistGNNEngine(jg, mesh=mesh, cfg=JEngineConfig(
        execution="broadcast", protocol="sync", partitioner="hash",
        hidden=16, num_layers=3, exchange_chunks=chunks, interpret=True))
    return g, eng, jeng


def _close(ours: torch.Tensor, theirs) -> None:
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                               atol=ORACLE_TOL, rtol=0)


@pytest.mark.parametrize("chunks", [1, 2])
def test_step_matches_jax_step_and_reference_step(chunks):
    g, eng, jeng = _engines(chunks)
    assert (g.degree() == 0).any(), "the graph should have isolated vertices"
    assert eng.cfg.lr == jeng.cfg.lr == 0.5
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
        for other in (jlogits, jref_logits):
            _close(logits, other)
        _close(ref_logits, jref_logits)
        assert state["step"] == i + 1
    for ours, ref, theirs, jref in zip(state["params"]["layers"],
                                       ref_state["params"]["layers"],
                                       jstate["params"]["layers"],
                                       jref_state["params"]["layers"]):
        for key in ("w", "b"):
            for other in (theirs[key], jref[key]):
                _close(ours[key], other)
            _close(ref[key], jref[key])


def test_single_device_paths_agree():
    """The counterpart of test_engine_single_device_paths_agree: the step
    and the reference step agree and learn."""
    g = sbm_graph(64, num_blocks=4, p_in=0.1, p_out=0.01, seed=1)
    eng = DistGNNEngine(g, EngineConfig(hidden=16, lr=0.3), device=CPU)
    ld, _ = eng.train(10)
    lr_, _ = eng.train(10, reference=True)
    assert max(abs(a - b) for a, b in zip(ld, lr_)) < ORACLE_TOL
    assert ld[-1] < ld[0]


def test_training_is_bitwise_deterministic_and_states_are_not_mutated():
    _, eng, _ = _engines(2)
    l1, logits1 = eng.train(4)
    l2, logits2 = eng.train(4)
    assert l1 == l2 and torch.equal(logits1, logits2)
    state = eng.init_state()
    before = [p.clone() for layer in state["params"]["layers"]
              for p in layer.values()]
    step = eng.make_step()
    a, b = step(state), step(state)  # one state stepped twice
    after = [p for layer in state["params"]["layers"] for p in layer.values()]
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert torch.equal(a[0]["params"]["layers"][0]["w"],
                       b[0]["params"]["layers"][0]["w"])
    assert float(a[1]["loss"]) == float(b[1]["loss"])


def test_cpu_training_launches_no_kernel():
    _, eng, _ = _engines(2)
    before = ell_spmm.launches, ell_spmm_transpose.launches
    eng.train(2)
    assert (ell_spmm.launches, ell_spmm_transpose.launches) == before


def test_accuracy_and_comm_stats_equal_jax():
    _, eng, jeng = _engines(1)
    for name in ("y", "train_w", "test_w"):
        assert np.array_equal(getattr(eng, name), np.asarray(getattr(jeng, name)))
    _, jlogits = jeng.train(STEPS)
    _, logits = eng.train(STEPS)
    for split in ("train", "test"):
        assert eng.accuracy(torch.from_numpy(np.array(jlogits)), split) \
            == jeng.accuracy(jlogits, split)
        assert 0.0 <= eng.accuracy(logits, split) <= 1.0
    assert dataclasses.asdict(eng.comm_stats) == dataclasses.asdict(
        jeng.comm_stats)
    eng.train(STEPS, reference=True)  # the reference run accrues nothing
    assert dataclasses.asdict(eng.comm_stats) == dataclasses.asdict(
        jeng.comm_stats)


def test_train_gnn_main_on_cpu():
    out = train_gnn.main(["--device", "cpu", "--vertices", "96", "--layers",
                          "3", "--hidden", "16", "--exchange-chunks", "2",
                          "--epochs", "6", "--lr", "0.3", "--oracle-check",
                          "--infer"])
    assert len(out["losses"]) == len(out["walls"]) == 6
    assert np.isfinite(out["losses"]).all() and out["losses"][-1] < out["losses"][0]
    assert out["oracle_gap"] <= ORACLE_TOL and out["infer_gap"] <= ORACLE_TOL
    assert out["state"]["step"] == 6 and out["logits"].shape == (96, 8)


def test_training_entry_points_default_to_the_card(monkeypatch):
    """Without CUDA the engine and the training entry point refuse to start
    unless the caller asks for the CPU: no silent CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = er_graph(**GRAPH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DistGNNEngine(g, EngineConfig(lr=0.1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_gnn.main(["--vertices", "32", "--epochs", "1"])


@pytest.mark.parametrize("protocol", ["epoch_fixed", "epoch_adaptive",
                                      "variation"])
def test_async_protocols_wait_for_their_slice(protocol):
    """Each historical-embedding protocol runs on one rank (its slice is
    ported): with no boundary row every row reads fresh, so its losses and
    logits are sync's bit for bit and it pushes no row; its state holds the
    history and the ages, and the reference run agrees."""
    g = er_graph(**GRAPH)
    runs = {}
    for p in ("sync", protocol):
        eng = DistGNNEngine(g, EngineConfig(protocol=p, hidden=16,
                                            num_layers=3), device=CPU)
        runs[p] = eng.train(3)
    assert runs["sync"][0] == runs[protocol][0]
    assert torch.equal(runs["sync"][1], runs[protocol][1])
    state = eng.init_state()
    assert [tuple(h.shape) for h in state["hist"]] == [
        (eng.nb, d) for d in eng.dims[1:]]
    _, metrics, _ = eng.make_step()(state)
    assert float(metrics["rows_pushed"]) == 0.0
    ref_losses, _ = eng.train(3, reference=True)
    assert max(abs(a - b) for a, b in zip(ref_losses, runs["sync"][0])) \
        <= ORACLE_TOL


def test_unknown_protocol_is_rejected():
    g = er_graph(**GRAPH)
    with pytest.raises(ValueError, match="protocol"):
        DistGNNEngine(g, EngineConfig(protocol="nope"), device=CPU)
