"""The port's query-serving latency tier: `repro_torch/core/serving.py`
(`GNNQueryEngine`) against the reference's `repro.core.serving` on the CPU,
from the JAX engine's own `init_minibatch_state()` weights carried over
with `params_from_numpy`.

One rank (in-process JAX, a 1-device Auto mesh, Pallas interpret) under
p2p, broadcast and the ring: `build_round`'s host arrays bitwise the
reference's (the same sampling keys and owner checks), `serve_round`'s
target rows within 1e-4 of the JAX `serve_round` and of the port's own
`reference_round`, one round shape, no kernel launch on the CPU;
coalescing and rebuild determinism as `tests/test_serving.py` (duplicates
inside a request, shared targets embedded once, ceil(max owned share /
batch_size) rounds, a fresh engine's stream bitwise equal), each flush
within 1e-4 of JAX's; the constructor's and `submit`'s refusals; and
`serve_gnn`'s query stream.  Four gloo ranks (four CPU processes) against
JAX on four forced host devices (one `run_with_devices` subprocess run
alongside): the same round checks on every rank, the collectives of a
round counted (an all_to_all an installment, one all_gather), a fully
cache-resident query adding zero pull bytes and some cache-hit bytes,
`flush` returning the same dict on every rank within 1e-4 of JAX's
4-device flush, the coalesced stream bitwise on a second engine, the
owner check, and `serve_gnn.main` on four ranks.
"""
import dataclasses
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from conftest import run_with_devices

TESTS = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")
ORACLE_TOL = 1e-4
WORLD = 4
RANK_TIMEOUT = 240  # seconds, for each rank process
# `tests/test_serving.py`'s query setup
GRAPH = dict(num_vertices=192, num_blocks=4, p_in=0.08, p_out=0.01, seed=0)
CFG = dict(batching="node_wise", batch_size=8, fanouts=(3, 3), hidden=8,
           lr=0.3, cache_policy="static_degree", cache_capacity=16)
TRIALS = 3
# the coalesced stream: a duplicate inside a request, an overlap across
# requests, and a request that takes several rounds an owner
STREAM = ([5, 9, 17, 9], [17, 30, 41], list(range(40)))


def _config(cls, execution="p2p", **extra):
    return cls(execution=execution, **dict(CFG, **extra))


def _round_targets(assignment, k, seed):
    """`tests/test_serving.py`'s rounds: 12 (10 when cache-resident)
    distinct targets split by owner, at most 8 an owner."""
    targets = np.random.default_rng(seed).choice(GRAPH["num_vertices"], 12,
                                                 replace=False)
    per_dev = [[] for _ in range(k)]
    for v in targets:
        per_dev[int(assignment[v])].append(int(v))
    return [np.asarray(x[:8], np.int64) for x in per_dev]


def _jax_arrays(batch, L) -> dict:
    """A JAX round's arrays under the port's host-array names."""
    out = {}
    for key, a in batch.items():
        if isinstance(a, tuple):
            out.update({f"{key}{l}": np.asarray(a[l]) for l in range(L)})
        else:
            out[key] = np.asarray(a)
    return out


def _close(ours, theirs, what=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               atol=ORACLE_TOL, rtol=0, err_msg=what)


def _stream(qe):
    rids = [qe.submit(r) for r in STREAM]
    out = qe.flush()
    return [out[r] for r in rids]


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------

MESH1 = None


def _jax_engine(execution="p2p", **extra):
    import jax
    from jax.sharding import AxisType

    from repro.core.engine import DistGNNEngine as JEngine
    from repro.core.engine import EngineConfig as JConfig
    from repro.core.graph import sbm_graph as jsbm_graph

    global MESH1
    if MESH1 is None:
        MESH1 = jax.make_mesh((1,), ("w",), axis_types=(AxisType.Auto,))
    return JEngine(jsbm_graph(**GRAPH), mesh=MESH1,
                   cfg=_config(JConfig, execution, interpret=True, **extra))


def _port(execution="p2p", params=None, **extra):
    """A port engine and a query engine over it from the JAX weights."""
    from repro_torch.core.engine import DistGNNEngine, EngineConfig
    from repro_torch.core.graph import sbm_graph
    from repro_torch.core.models.gnn import params_from_numpy
    from repro_torch.core.serving import GNNQueryEngine

    eng = DistGNNEngine(sbm_graph(**GRAPH),
                        _config(EngineConfig, execution, **extra), device=CPU)
    return GNNQueryEngine(eng, params_from_numpy(params, CPU))


def _numpy_params(jeng) -> dict:
    import jax

    return jax.tree.map(np.asarray, jeng.init_minibatch_state()["params"])


@pytest.mark.parametrize("execution", ["p2p", "broadcast", "ring"])
def test_rounds_match_jax_and_the_reference_round_one_rank(execution):
    from repro.core.serving import GNNQueryEngine as JQuery
    from repro_torch.kernels.ell_spmm import ell_spmm

    jeng = _jax_engine(execution)
    params = _numpy_params(jeng)
    jq = JQuery(jeng, jeng.init_minibatch_state()["params"])
    qe = _port(execution, params)
    eng = qe.engine
    L = eng.cfg.num_layers
    launches = ell_spmm.launches
    for trial in range(TRIALS):
        tg = _round_targets(eng.playout.part.assignment, 1, trial)
        jb, batch = jq.build_round(tg), qe.build_round(tg)
        want = _jax_arrays(jb, L)
        got = batch["arrays"]
        for key, a in want.items():
            assert np.array_equal(got[key], a), (trial, key)
        H = qe.serve_round(batch).numpy()
        R = qe.reference_round(batch).numpy()
        J = np.asarray(jq.serve_round(jb))
        assert H.shape == R.shape == J.shape == (1, eng.caps[-1],
                                                 eng.dims[-1])
        n = len(tg[0])
        _close(H[0, :n], J[0, :n], f"serve vs JAX {trial}")
        _close(H[0, :n], R[0, :n], f"serve vs reference {trial}")
    assert qe.round_shapes() == 1 and qe.stats.rounds == TRIALS
    assert ell_spmm.launches == launches  # the CPU launches no kernel
    assert dataclasses.asdict(eng.comm_stats) == dataclasses.asdict(
        jeng.comm_stats)
    emb = qe.query([int(tg[0][0])])
    assert emb.shape == (1, eng.dims[-1]) and qe.round_shapes() == 1


def test_coalescing_and_rebuild_determinism_one_rank():
    from repro.core.serving import GNNQueryEngine as JQuery

    jeng = _jax_engine()
    params = _numpy_params(jeng)
    theirs = _stream(JQuery(jeng, jeng.init_minibatch_state()["params"]))
    qe = _port(params=params)
    out = _stream(qe)
    assert out[0].shape[0] == 4 and out[1].shape[0] == 3
    assert np.array_equal(out[0][1], out[0][3]), "duplicate target differs"
    assert np.array_equal(out[0][2], out[1][0]), "shared target re-embedded"
    union = sorted(set(sum(STREAM, [])))
    assert qe.stats.queries == 3 and qe.stats.targets == len(union)
    per_dev = np.bincount(qe.engine.playout.part.assignment[union],
                          minlength=qe.engine.k)
    assert qe.stats.rounds == int(np.ceil(per_dev.max() / 8))
    assert qe.round_shapes() == 1
    for a, b in zip(out, theirs):
        _close(a, b, "flush vs JAX")
    again = _stream(_port(params=params))
    assert all(np.array_equal(a, b) for a, b in zip(out, again))
    assert len(qe.stats.latencies_s) == 1 and qe.stats.qps() > 0
    assert qe.stats.percentile_ms(99) >= qe.stats.percentile_ms(50) > 0


def test_constructor_and_submit_refusals():
    from repro_torch.core.engine import DistGNNEngine, EngineConfig
    from repro_torch.core.graph import sbm_graph
    from repro_torch.core.serving import GNNQueryEngine

    g = sbm_graph(**GRAPH)
    eng = DistGNNEngine(g, EngineConfig(execution="p2p", hidden=8),
                        device=CPU)
    with pytest.raises(ValueError, match="node_wise"):
        GNNQueryEngine(eng, eng.init_state()["params"])
    eng = DistGNNEngine(g, EngineConfig(
        execution="p2p", batching="node_wise", batch_size=8, fanouts=(3, 3),
        hidden=8, trainable_features=True), device=CPU)
    with pytest.raises(ValueError, match="publish_embeddings"):
        GNNQueryEngine(eng, eng.init_minibatch_state()["params"])
    qe = _port(params=_numpy_params(_jax_engine()))
    with pytest.raises(ValueError, match="empty query"):
        qe.submit([])
    with pytest.raises(ValueError, match="out of range"):
        qe.submit([GRAPH["num_vertices"]])
    with pytest.raises(ValueError, match="batch_size"):
        qe.build_round([np.arange(9)])
    assert qe.flush() == {} and qe.round_shapes() == 0


def test_serve_gnn_query_stream_one_rank():
    from repro_torch.core.graph import sbm_graph
    from repro_torch.core.serving import GNNQueryEngine
    from repro_torch.launch import serve_gnn

    args = serve_gnn.parse_args(["--device", "cpu", "--train-steps", "2",
                                 "--vertices", "128", "--queries", "6"])
    assert (args.queries, args.targets_per_query) == (6, 8)
    eng = serve_gnn.build_engine(args, sbm_graph(
        128, num_blocks=8, p_in=0.05, p_out=0.003, seed=0))
    qe = GNNQueryEngine(eng, serve_gnn.train_params(eng, 2)["params"])
    s = serve_gnn.run_query_stream(qe, num_queries=6, targets_per_query=8)
    assert s.queries == 6 and len(s.latencies_s) == 6
    assert s.rounds == 7 and qe.round_shapes() == 1  # the warm-up's too
    emb, _ = serve_gnn.main(["--device", "cpu", "--train-steps", "2",
                             "--vertices", "128", "--queries", "3"])
    assert emb.shape[0] == 128


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

_JAX_CODE = """
import dataclasses, json
import jax
import numpy as np
from jax.sharding import AxisType
from repro.core.engine import DistGNNEngine, EngineConfig
from repro.core.graph import sbm_graph
from repro.core.serving import GNNQueryEngine
graph, cfg, trials, stream, out_path = json.loads({args!r})
cfg["fanouts"] = tuple(cfg["fanouts"])
mesh = jax.make_mesh((4,), ("w",), axis_types=(AxisType.Auto,))
out = {{}}
def round_targets(assignment, seed, n=12):
    targets = np.random.default_rng(seed).choice(graph["num_vertices"], n,
                                                 replace=False)
    per_dev = [[] for _ in range(4)]
    for v in targets:
        per_dev[int(assignment[v])].append(int(v))
    return [np.asarray(x[:8], np.int64) for x in per_dev]
def arrays(batch, tag):
    for key, a in batch.items():
        if isinstance(a, tuple):
            for l, x in enumerate(a):
                out[f"{{tag}}/{{key}}{{l}}"] = np.asarray(x)
        else:
            out[f"{{tag}}/{{key}}"] = np.asarray(a)
eng = DistGNNEngine(sbm_graph(**graph), mesh=mesh,
                    cfg=EngineConfig(interpret=True, **cfg))
params = eng.init_minibatch_state()["params"]
qe = GNNQueryEngine(eng, params)
for t in range(trials):
    b = qe.build_round(round_targets(eng.part.assignment, t))
    arrays(b, f"round{{t}}")
    out[f"round{{t}}/H"] = np.asarray(qe.serve_round(b))
out["comm"] = np.array(json.dumps(dataclasses.asdict(eng.comm_stats)))
res = GNNQueryEngine(eng, params)
rids = [res.submit(r) for r in stream]
flushed = res.flush()
for i, r in enumerate(rids):
    out[f"flush/{{i}}"] = np.asarray(flushed[r])
out["flush_rounds"] = np.array(res.stats.rounds)
np.savez(out_path, **out)
print("JAX QUERY DONE")
"""

_RANK_CODE = """
import dataclasses, json, os, sys, traceback
try:
    tests, tmp, rank, world, graph, cfg, trials, stream = json.loads(
        sys.argv[1])
    import numpy as np
    import torch
    from repro_torch.core.engine import DistGNNEngine, EngineConfig
    from repro_torch.core.execution import collectives
    from repro_torch.core.graph import sbm_graph
    from repro_torch.core.models.gnn import params_from_numpy
    from repro_torch.core.serving import GNNQueryEngine
    from repro_torch.launch import serve_gnn
    cfg["fanouts"] = tuple(cfg["fanouts"])
    collectives.init_group(f"file://{tmp}/rendezvous", world, rank,
                           torch.device("cpu"))
    given = np.load(f"{tmp}/init.npz")
    layers = sorted({int(key.split("/")[0]) for key in given.files})
    params = params_from_numpy({"layers": [
        {key.split("/")[1]: given[key] for key in given.files
         if key.startswith(f"{l}/")} for l in layers]}, "cpu")
    g = sbm_graph(**graph)
    out = {}
    def round_targets(assignment, seed, n=12):
        targets = np.random.default_rng(seed).choice(
            graph["num_vertices"], n, replace=False)
        per_dev = [[] for _ in range(world)]
        for v in targets:
            per_dev[int(assignment[v])].append(int(v))
        return [np.asarray(x[:8], np.int64) for x in per_dev]
    eng = DistGNNEngine(g, EngineConfig(**cfg), device="cpu")
    qe = GNNQueryEngine(eng, params)
    assignment = eng.playout.part.assignment
    calls = []
    for t in range(trials):
        b = qe.build_round(round_targets(assignment, t))
        for key, a in b["arrays"].items():
            out[f"round{t}/{key}"] = a
        collectives.zero_calls()
        out[f"round{t}/H"] = qe.serve_round(b).numpy()
        calls.append(collectives.read_calls())
        collectives.zero_calls()
        out[f"round{t}/R"] = qe.reference_round(b).numpy()
        calls.append(collectives.read_calls())
    out["calls"] = np.array(json.dumps(calls))
    out["installments"] = np.array(len(eng.fcap_widths))
    out["round_shapes"] = np.array(qe.round_shapes())
    out["comm"] = np.array(json.dumps(dataclasses.asdict(eng.comm_stats)))
    # the owner check: a target given to a rank that does not own it
    wrong = [np.asarray([v], np.int64) if d == 0 else np.zeros(0, np.int64)
             for d, v in enumerate([int(np.flatnonzero(assignment != 0)[0])]
                                   + [0] * (world - 1))]
    try:
        qe.build_round(wrong)
        out["owner_check"] = np.array("accepted")
    except ValueError as e:
        out["owner_check"] = np.array(str(e))
    # the coalesced stream, and again on a second engine
    for run in (0, 1):
        e2 = DistGNNEngine(g, EngineConfig(**cfg), device="cpu")
        q2 = GNNQueryEngine(e2, params)
        rids = [q2.submit(r) for r in stream]
        flushed = q2.flush()
        for i, r in enumerate(rids):
            out[f"flush{run}/{i}"] = flushed[r]
        out[f"flush{run}_rounds"] = np.array(q2.stats.rounds)
    # a fully cache-resident query: every vertex's row resident
    e3 = DistGNNEngine(g, EngineConfig(**dict(
        cfg, cache_capacity=graph["num_vertices"])), device="cpu")
    q3 = GNNQueryEngine(e3, params)
    before = dataclasses.asdict(e3.comm_stats)
    b = q3.build_round(round_targets(e3.playout.part.assignment, 2, n=10))
    after = dataclasses.asdict(e3.comm_stats)
    out["resident"] = np.array(json.dumps([before, after]))
    out["resident_H"] = q3.serve_round(b).numpy()
    out["resident_R"] = q3.reference_round(b).numpy()
    collectives.destroy_group()
    emb, _ = serve_gnn.main([
        "--device", "cpu", "--world-size", str(world), "--rank", str(rank),
        "--init-method", f"file://{tmp}/serve", "--vertices", "128",
        "--hidden", "8", "--train-steps", "2", "--queries", "4"])
    out["main"] = emb
    np.savez(f"{tmp}/rank{rank}.npz", **out)
except BaseException:
    traceback.print_exc()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(1)
"""


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The port on 4 gloo ranks and JAX on 4 forced host devices, run
    together; the ranks start from the JAX engine's own
    `init_minibatch_state()` weights, drawn here with the reference's
    `init_gnn_params` and the seed's key."""
    import jax

    from repro.core.graph import sbm_graph as jsbm_graph
    from repro.core.models.gnn import init_gnn_params as jinit_gnn_params
    from test_torch_distributed import _run_ranks

    tmp = tmp_path_factory.mktemp("torch_query")
    classes = int(jsbm_graph(**GRAPH).labels.max()) + 1
    tree = jinit_gnn_params("gcn", [32, CFG["hidden"], classes],
                            jax.random.PRNGKey(0))
    np.savez(tmp / "init.npz", **{f"{l}/{key}": np.asarray(a)
                                  for l, p in enumerate(tree["layers"])
                                  for key, a in p.items()})
    cfg = dict(CFG, execution="p2p", fanouts=list(CFG["fanouts"]))
    stream = [list(r) for r in STREAM]
    jax_path = str(tmp / "jax.npz")
    code = _JAX_CODE.format(args=json.dumps(
        [GRAPH, cfg, TRIALS, stream, jax_path]))
    jax_error = []

    def jax_side():
        try:
            run_with_devices(code, n_devices=WORLD, timeout=RANK_TIMEOUT)
        except BaseException as e:  # re-raised below, in the test's thread
            jax_error.append(e)

    jax_thread = threading.Thread(target=jax_side)
    jax_thread.start()
    try:
        _run_ranks([[sys.executable, "-c", _RANK_CODE, json.dumps(
            [TESTS, str(tmp), r, WORLD, GRAPH, cfg, TRIALS, stream])]
            for r in range(WORLD)], timeout=RANK_TIMEOUT)
    finally:
        jax_thread.join()
    if jax_error:
        raise jax_error[0]
    return dict(jax=dict(np.load(jax_path)),
                ranks=[dict(np.load(tmp / f"rank{r}.npz"))
                       for r in range(WORLD)])


@pytest.mark.parametrize("rank", range(WORLD))
def test_four_rank_rounds_match_jax(four, rank):
    ours, jx = four["ranks"][rank], four["jax"]
    for t in range(TRIALS):
        keys = [k for k in jx if k.startswith(f"round{t}/") and
                not k.endswith("/H")]
        assert keys
        for key in keys:
            assert np.array_equal(ours[key], jx[key]), key
        H, R, J = (ours[f"round{t}/H"], ours[f"round{t}/R"],
                   jx[f"round{t}/H"])
        assert H.shape == R.shape == J.shape
        valid = jx[f"round{t}/y"].shape  # [k, cap_L]: every slot compared
        assert H.shape[:2] == valid
        _close(H, J, f"round {t} vs JAX")
        _close(H, R, f"round {t} vs the reference round")
    assert int(ours["round_shapes"]) == 1
    assert json.loads(str(ours["comm"])) == json.loads(str(jx["comm"]))
    B = int(ours["installments"])
    for serve, ref in zip(*[iter(json.loads(str(ours["calls"])))] * 2):
        serve = {name: n for name, n in serve.items() if n}
        assert serve == {"all_to_all": B, "all_gather": 1}, serve
        assert not any(ref.values()), ref
    assert "does not own" in str(ours["owner_check"])


@pytest.mark.parametrize("rank", range(WORLD))
def test_four_rank_flush_same_on_every_rank_and_jax(four, rank):
    ours, jx = four["ranks"][rank], four["jax"]
    first = four["ranks"][0]
    for i in range(len(STREAM)):
        assert np.array_equal(ours[f"flush0/{i}"], first[f"flush0/{i}"])
        assert np.array_equal(ours[f"flush0/{i}"], ours[f"flush1/{i}"])
        assert ours[f"flush0/{i}"].shape[0] == len(STREAM[i])
        _close(ours[f"flush0/{i}"], jx[f"flush/{i}"], f"request {i}")
    assert int(ours["flush0_rounds"]) == int(jx["flush_rounds"]) > 1
    assert np.array_equal(ours["main"], first["main"])


def test_four_rank_cache_resident_query_pulls_nothing(four):
    for ours in four["ranks"]:
        before, after = json.loads(str(ours["resident"]))
        assert after["pull_bytes"] == before["pull_bytes"]
        assert after["cache_hit_bytes"] > before["cache_hit_bytes"]
        _close(ours["resident_H"], ours["resident_R"], "resident round")
