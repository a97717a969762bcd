"""The port's p2p execution model on one rank: `repro_torch`'s default
engine (p2p over the metis_like partition, one bucket) for gcn and gat at
exchange_chunks 1 and 2 on the CPU, against the JAX engine's default engine
on a 1-device Auto-axis mesh (Pallas interpret): the training step, the
reference step and both sweeps within 1e-4 from the reference's own initial
weights, and CommStats equal.  Also: at one rank the p2p table is the
broadcast table with one unread halo row, so the two execution models give
the same bits; `EngineConfig()` has the reference's defaults, and both
launchers default to them; the p2p send rows as an ELL of K = 1
(`bucketed_all_to_all` without a process group)."""
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
from repro_torch.core.execution.pipeline_exchange import bucketed_all_to_all
from repro_torch.core.graph import er_graph
from repro_torch.core.models.gnn import PARAM_KEYS, params_from_numpy
from repro_torch.kernels.ell_spmm import ell_spmm, ell_transpose_plan
from repro_torch.launch import serve_gnn, train_gnn

ORACLE_TOL = 1e-4  # the repo's oracle bound for every step and sweep
CPU = torch.device("cpu")
# dims [24, 16, 16, 5]; average in-degree 3 leaves some vertices isolated
GRAPH = dict(num_vertices=120, avg_degree=3, feature_dim=24, num_classes=5,
             seed=1)
STEPS = 3
CASES = [(model, chunks) for model in ("gcn", "gat") for chunks in (1, 2)]


def _engines(model, chunks):
    g, jg = er_graph(**GRAPH), jer_graph(**GRAPH)
    eng = DistGNNEngine(g, EngineConfig(model=model, hidden=16, num_layers=3,
                                        exchange_chunks=chunks), device=CPU)
    mesh = jax.make_mesh((1,), ("w",), axis_types=(AxisType.Auto,))
    jeng = JDistGNNEngine(jg, mesh=mesh, cfg=JEngineConfig(
        model=model, hidden=16, num_layers=3, exchange_chunks=chunks,
        interpret=True))
    return g, eng, jeng


def _close(ours: torch.Tensor, theirs) -> None:
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               atol=ORACLE_TOL, rtol=0)


@pytest.mark.parametrize("model,chunks", CASES)
def test_p2p_step_and_sweep_match_jax(model, chunks):
    g, eng, jeng = _engines(model, chunks)
    for cfg in (eng.cfg, jeng.cfg):
        assert (cfg.execution, cfg.partitioner, cfg.p2p_buckets) == (
            "p2p", "metis_like", 1)
    assert (eng.playout.cap, eng.playout.p2p_widths) == (
        jeng.playout.cap, jeng.playout.p2p_widths) == (1, [1])
    jstate = jeng.init_state()
    params = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]), CPU)
    state = ref_state = eng.init_state(params=params)
    step, ref_step, jstep = (eng.make_step(), eng.make_reference_step(),
                             jeng.make_step())
    for _ in range(STEPS):
        state, metrics, logits = step(state)
        ref_state, ref_metrics, ref_logits = ref_step(ref_state)
        jstate, jmetrics, jlogits = jstep(jstate)
        for other in (ref_metrics["loss"], jmetrics["loss"]):
            assert abs(float(metrics["loss"]) - float(other)) <= ORACLE_TOL
        _close(logits, jlogits)
        _close(ref_logits, jlogits)
    for ours, ref, theirs in zip(state["params"]["layers"],
                                 ref_state["params"]["layers"],
                                 jstate["params"]["layers"]):
        for key in PARAM_KEYS[model]:
            _close(ours[key], theirs[key])
            _close(ref[key], theirs[key])
    emb = eng.global_embeddings(eng.infer_full_graph(params=params))
    ref = eng.global_embeddings(eng.infer_full_graph(params=params,
                                                     reference=True))
    jparams = jax.tree.map(jax.numpy.asarray, jeng.init_state()["params"])
    jemb = jeng.global_embeddings(jeng.infer_full_graph(params=jparams))
    assert emb.shape == (g.num_vertices, 5) and np.isfinite(emb).all()
    _close(emb, jemb)
    _close(ref, jemb)
    eng.train(2)
    jeng.train(2)
    assert (dataclasses.asdict(eng.comm_stats)
            == dataclasses.asdict(jeng.comm_stats))


@pytest.mark.parametrize("model,chunks", CASES)
def test_p2p_equals_broadcast_on_one_rank(model, chunks):
    """One rank: the p2p gather table is the broadcast table with one halo
    row that no id reads (its send entry is a pad and ships a zero row), so
    the step and the sweep give the same bits under both models."""
    g = er_graph(**GRAPH)
    engs = [DistGNNEngine(g, EngineConfig(
        execution=execution, model=model, hidden=16, num_layers=3,
        exchange_chunks=chunks), device=CPU)
        for execution in ("broadcast", "p2p")]
    assert engs[1].playout.table_rows == engs[0].playout.table_rows + 1
    outs = []
    for eng in engs:
        state = eng.init_state()
        state2, metrics, logits = eng.make_step()(state)
        sweep = eng.infer_full_graph(params=state["params"])
        outs.append([metrics["loss"], logits, sweep] + [
            p[key] for p in state2["params"]["layers"]
            for key in PARAM_KEYS[model]])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_engine_config_defaults_are_the_reference_s():
    ours, theirs = EngineConfig(), JEngineConfig()
    for field in dataclasses.fields(EngineConfig):
        assert getattr(ours, field.name) == getattr(theirs, field.name), field
    assert (ours.execution, ours.partitioner, ours.p2p_buckets) == (
        "p2p", "metis_like", 1)
    for launcher in (serve_gnn, train_gnn):
        args = launcher.parse_args([])
        assert (args.exec, args.partitioner) == ("p2p", "metis_like")
    with pytest.raises(ValueError, match="p2p_buckets must be >= 1"):
        DistGNNEngine(er_graph(**GRAPH), EngineConfig(p2p_buckets=0),
                      device=CPU)


def test_bucketed_all_to_all_without_a_group_is_the_send_gather():
    """Without a process group the installments are the send gathers alone:
    each is h's rows at the send ids, zeros at the pad entries, installment
    after installment; the backward sums a row's cotangents over every
    entry that sent it."""
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((7, 3)).astype(np.float32))
    h.requires_grad_()
    rows = [np.array([3, 0, 3, 6]), np.array([1, 0, 0, 5])]
    fills = [np.array([1, 0, 1, 1]), np.array([1, 1, 0, 0])]
    send = []
    for r, f in zip(rows, fills):
        ids = torch.from_numpy(r.astype(np.int32)[:, None])
        mask = torch.from_numpy(f.astype(np.float32)[:, None])
        send.append((ids, mask, ell_transpose_plan(ids, mask, 7)))
    before = ell_spmm.launches
    recv = bucketed_all_to_all(h, send)()
    assert ell_spmm.launches == before  # CPU tensors never launch the kernel
    want = torch.cat([h[torch.from_numpy(r)] * torch.from_numpy(f)[:, None]
                      for r, f in zip(rows, fills)]).float()
    assert torch.equal(recv, want)
    ct = torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32))
    (grad,) = torch.autograd.grad(recv, h, ct)
    ids = np.concatenate(rows)
    on = np.concatenate(fills) > 0
    expect = np.zeros((7, 3), np.float32)
    np.add.at(expect, ids[on], ct.numpy()[on])
    np.testing.assert_allclose(grad.numpy(), expect, atol=1e-6, rtol=0)
