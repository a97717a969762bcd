"""The port's pipelined mini-batch epoch: `repro_torch`'s
`DistGNNEngine.run_epoch_minibatch(schedule="pipelined")` with the prefetch
thread (``prefetch_mode="thread"``) and with the sampling-process pool over
the shared-memory ring (``"process"``), on the CPU.

The contract is the reference's: a pipelined epoch is bitwise equal to the
conventional epoch in losses, final params and CommStats, in both modes, on
every rank.  One rank: every batching (node_wise, layer_wise, subgraph) x
execution model (broadcast, ring, p2p) x mode, with the static_degree cache,
exchange_chunks 2 and p2p_buckets 2, from the JAX engine's own
`init_minibatch_state()` weights; each also within 1e-4 of the JAX engine's
pipelined epoch (thread mode: the JAX process pool names its segments
``repro-*``, which the JAX tiers run beside this one count as theirs) on a
1-device Auto-axis mesh, CommStats equal; the pool's second epoch reuses
the pool (its LRU serves every batch, producer seconds 0) bitwise equal
again, and `close_prefetch_pool()` leaves none of the pool's segments;
the pool's producer (`HostBatchBuilder.produce`) equal to the reference's
array for array.  Four gloo ranks (four CPU processes, each with its own
pool of one or two workers) against the JAX engine's pipelined epoch on
four forced host devices: the same nine configurations, both modes.  And
`train_gnn.main --schedule pipelined` in both modes with its guards.

Every rank process has its own time limit, and a rank that raises exits at
once, so a fault fails the tier instead of hanging it."""
import dataclasses
import json
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from conftest import run_with_devices
from repro.core.engine import DistGNNEngine as JDistGNNEngine
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.graph import sbm_graph as jsbm_graph
from repro_torch.core.engine import DistGNNEngine, EngineConfig
from repro_torch.core.graph import sbm_graph
from repro_torch.core.models.gnn import PARAM_KEYS, params_from_numpy
from repro_torch.core.sampling import proc_prefetch
from repro_torch.core.sampling.proc_prefetch import SHM_DIR, SHM_PREFIX
from repro_torch.launch import train_gnn
from test_torch_distributed import _run_ranks

ORACLE_TOL = 1e-4
CPU = torch.device("cpu")
STEPS = 4
WORLD = 4
RANK_TIMEOUT = 240  # seconds, for each rank process
SBM = dict(num_vertices=96, num_blocks=8, p_in=0.08, p_out=0.01)
# the reference's pipelined tier (`test_engine_pipeline.py`) settings
MB = dict(batch_size=8, fanouts=(3, 3), layer_sizes=(16, 16), walk_length=3,
          hidden=16, num_layers=2, lr=0.3, cache_policy="static_degree",
          cache_capacity=12, exchange_chunks=2, p2p_buckets=2,
          prefetch_depth=2)
CONFIGS = [(b, e) for b in ("node_wise", "layer_wise", "subgraph")
           for e in ("broadcast", "ring", "p2p")]
MODES = ("thread", "process")
CASES = [(b, e, m) for b, e in CONFIGS for m in MODES]
IDS = [f"{b}-{e}-{m}" for b, e, m in CASES]


def _own_segments(pid=None):
    mark = f"-{(os.getpid() if pid is None else pid):x}-"
    return [f for f in os.listdir(SHM_DIR)
            if f.startswith(SHM_PREFIX) and mark in f]


def _close(ours, theirs, what=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               atol=ORACLE_TOL, rtol=0, err_msg=what)


def _same_params(a, b, model="gcn"):
    return all(torch.equal(x[key], y[key]) for x, y in
               zip(a["params"]["layers"], b["params"]["layers"])
               for key in PARAM_KEYS[model])


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------

_JAX_RUNS = {}
MESH1 = None


def _jax_run(batching, execution):
    """The JAX engine's pipelined (thread) epoch of the configuration on a
    1-device Auto mesh, once per configuration: (engine, initial params,
    final state, losses, CommStats)."""
    global MESH1
    key = (batching, execution)
    if key not in _JAX_RUNS:
        if MESH1 is None:
            MESH1 = jax.make_mesh((1,), ("w",), axis_types=(AxisType.Auto,))
        jeng = JDistGNNEngine(jsbm_graph(**SBM), mesh=MESH1, cfg=JEngineConfig(
            batching=batching, execution=execution, interpret=True, **MB))
        init = jax.tree.map(np.asarray, jeng.init_minibatch_state()["params"])
        state, losses, _ = jeng.run_epoch_minibatch(STEPS, "pipelined")
        _JAX_RUNS[key] = (jeng, init, state, losses,
                          dataclasses.asdict(jeng.comm_stats))
    return _JAX_RUNS[key]


@pytest.mark.parametrize("batching,execution,mode", CASES, ids=IDS)
def test_one_rank_pipelined_is_the_blocking_epoch(batching, execution, mode):
    """Pipelined == conventional bit for bit (losses, params, CommStats),
    both within 1e-4 of the JAX pipelined epoch with CommStats equal; in
    process mode the pool's second epoch (the LRU) is bitwise equal too,
    the pool's producer is the reference's, and closing leaves nothing."""
    jeng, init, jstate, jlosses, jcomm = _jax_run(batching, execution)
    eng = DistGNNEngine(sbm_graph(**SBM), EngineConfig(
        batching=batching, execution=execution, prefetch_mode=mode,
        num_sample_workers=2, **MB), device=CPU)
    params = params_from_numpy(init, CPU)
    runs = []
    for schedule in ("conventional", "pipelined"):
        eng.comm_stats.reset()
        state, losses, times = eng.run_epoch_minibatch(
            STEPS, schedule, state=eng.init_minibatch_state(params))
        runs.append((state, losses, dataclasses.asdict(eng.comm_stats),
                     times))
    (s1, l1, c1, _), (s2, l2, c2, t2) = runs
    assert l1 == l2 and all(isinstance(x, float) for x in l2)
    assert _same_params(s1, s2) and c1 == c2
    assert c2 == jcomm  # one rank: nothing is remote
    _close(l2, jlosses, "losses")
    for ours, theirs in zip(s2["params"]["layers"], jstate["params"]["layers"]):
        for key in PARAM_KEYS["gcn"]:
            _close(ours[key], theirs[key], key)
    assert t2.wall > 0 and t2.train > 0 and t2.sample > 0 and t2.extract > 0
    if mode == "process":
        pool = eng._proc_pool
        assert pool is not None and pool.alive and pool.workers_alive
        assert len(_own_segments()) >= MB["prefetch_depth"] + 2
        eng.comm_stats.reset()
        s3, l3, t3 = eng.run_epoch_minibatch(
            STEPS, "pipelined", state=eng.init_minibatch_state(params))
        assert eng._proc_pool is pool  # reused across epochs
        assert l3 == l1 and _same_params(s1, s3)
        assert dataclasses.asdict(eng.comm_stats) == c1
        assert t3.sample == t3.extract == 0.0  # every batch from the LRU
        for step in (0, STEPS - 1):
            arrays, meta = eng.host_builder.produce(step)
            jarrays, jmeta = jeng.host_builder.produce(step)
            assert arrays.keys() == jarrays.keys()
            for key in arrays:
                assert np.array_equal(arrays[key], jarrays[key]), key
            assert meta["per_device"] == jmeta["per_device"]
            # each rank's sample_device span closes inside its sample span
            assert [s[0] for s in meta["spans"]] == [
                s[0] for s in jmeta["spans"]] == (
                    ["sample_device"] * eng.k + ["sample", "extract"])
            assert meta["sample_seconds"] > 0 and meta["extract_seconds"] > 0
        eng.close_prefetch_pool()
        eng.close_prefetch_pool()  # idempotent
        assert eng._proc_pool is None and not pool.alive
        assert _own_segments() == []
    else:
        assert eng._proc_pool is None and _own_segments() == []


def test_entry_point_and_guards():
    """`train_gnn.main --schedule pipelined` in both modes gives the
    conventional epoch's losses and CommStats, the oracle within 1e-4, and
    leaves no pool behind; the reference's config guards refuse depth 0, an
    unknown mode and no workers, and the epoch refuses an unknown mode."""
    common = ["--device", "cpu", "--batching", "node_wise", "--vertices",
              "128", "--epochs", "4", "--fanouts", "3,3", "--cache",
              "static_degree", "--cache-capacity", "16"]
    base = train_gnn.main(common)
    for mode, extra in (("thread", ["--prefetch-depth", "1"]),
                        ("process", ["--num-sample-workers", "1"])):
        out = train_gnn.main(common + ["--schedule", "pipelined",
                                       "--prefetch-mode", mode,
                                       "--oracle-check", *extra])
        assert out["losses"] == base["losses"], mode
        assert out["comm"] == base["comm"]
        assert out["oracle_gap"] <= ORACLE_TOL
        assert out["times"].wall > 0
    assert _own_segments() == []
    args = train_gnn.parse_args([])
    assert (args.prefetch_mode, args.prefetch_depth,
            args.num_sample_workers) == ("thread", 2, 2)
    assert (EngineConfig().prefetch_depth, EngineConfig().prefetch_mode,
            EngineConfig().num_sample_workers) == (2, "thread", 2)
    g = sbm_graph(**SBM)
    for kw in (dict(prefetch_depth=0), dict(prefetch_mode="nope"),
               dict(num_sample_workers=0)):
        with pytest.raises(ValueError, match=next(iter(kw))):
            DistGNNEngine(g, EngineConfig(batching="node_wise", **kw),
                          device=CPU)
        with pytest.raises(ValueError):
            JDistGNNEngine(jsbm_graph(**SBM), cfg=JEngineConfig(
                batching="node_wise", **kw))
    eng = DistGNNEngine(g, EngineConfig(batching="node_wise"), device=CPU)
    with pytest.raises(ValueError, match="prefetch_mode"):
        eng.run_epoch_minibatch(2, "pipelined", prefetch_mode="nope")
    with pytest.raises(ValueError, match="depth"):
        eng.run_epoch_minibatch(2, "pipelined", prefetch_depth=0)
    assert eng._proc_pool is None
    # a mount that holds the graph but not the ring: refused with the
    # ring's sizes, the shared graph unlinked, no pool left
    need = proc_prefetch.graph_shm_nbytes(g)
    free = proc_prefetch.shm_free_bytes
    proc_prefetch.shm_free_bytes = lambda: need
    try:
        with pytest.raises(OSError, match="the batch ring .2 slots of"):
            eng.run_epoch_minibatch(2, "pipelined", prefetch_mode="process")
    finally:
        proc_prefetch.shm_free_bytes = free
    assert eng._proc_pool is None and _own_segments() == []


# ---------------------------------------------------------------------------
# four gloo ranks against JAX on four forced host devices
# ---------------------------------------------------------------------------

FOUR_TAGS = [f"{b}-{e}" for b, e in CONFIGS]

_JAX_CODE = """
import dataclasses, json
import jax, numpy as np
from jax.sharding import AxisType
from repro.core.engine import DistGNNEngine, EngineConfig
from repro.core.graph import sbm_graph
configs, tags, mb, sbm, steps, out_path = json.loads({args!r})
mb["fanouts"], mb["layer_sizes"] = tuple(mb["fanouts"]), tuple(mb["layer_sizes"])
mesh = jax.make_mesh((4,), ("w",), axis_types=(AxisType.Auto,))
g = sbm_graph(**sbm)
out = {{}}
for (batching, execution), tag in zip(configs, tags):
    eng = DistGNNEngine(g, mesh=mesh, cfg=EngineConfig(
        batching=batching, execution=execution, interpret=True, **mb))
    for l, p in enumerate(eng.init_minibatch_state()["params"]["layers"]):
        for key, a in p.items():
            out[f"{{tag}}/init/{{l}}/{{key}}"] = np.asarray(a)
    state, losses, _ = eng.run_epoch_minibatch(steps, "pipelined")
    out[f"{{tag}}/losses"] = np.array(losses)
    for l, p in enumerate(state["params"]["layers"]):
        for key, a in p.items():
            out[f"{{tag}}/final/{{l}}/{{key}}"] = np.asarray(a)
    out[f"{{tag}}/comm"] = np.array(json.dumps(
        dataclasses.asdict(eng.comm_stats)))
np.savez(out_path, **out)
print("JAX DONE", len(configs))
"""

_RANK_CODE = """
import dataclasses, json, os, sys, traceback
try:
    import numpy as np
    import torch
    from repro_torch.core.engine import DistGNNEngine, EngineConfig
    from repro_torch.core.graph import sbm_graph
    from repro_torch.core.models.gnn import params_from_numpy
    from repro_torch.core.sampling.proc_prefetch import SHM_DIR, SHM_PREFIX
    from repro_torch.launch import train_gnn
    from repro_torch.launch.common import join_group, leave_group

    (configs, tags, mb, sbm, steps, rank, world, tmp, init_path,
     out_path) = json.loads(sys.argv[1])
    mb["fanouts"], mb["layer_sizes"] = (tuple(mb["fanouts"]),
                                        tuple(mb["layer_sizes"]))
    args = train_gnn.parse_args([
        "--device", "cpu", "--world-size", str(world), "--rank", str(rank),
        "--init-method", f"file://{tmp}/rendezvous"])
    join_group(args)
    g = sbm_graph(**sbm)
    given = np.load(init_path)
    out = {}
    for n, ((batching, execution), tag) in enumerate(zip(configs, tags)):
        # each rank its own pool, of one or two workers
        eng = DistGNNEngine(g, EngineConfig(
            batching=batching, execution=execution,
            num_sample_workers=1 + (n + rank) % 2, **mb), device="cpu")
        params = params_from_numpy({"layers": [
            {key: given[f"{tag}/init/{l}/{key}"] for key in ("w", "b")}
            for l in range(mb["num_layers"])]}, "cpu")
        for name, schedule, mode in (("conventional", "conventional", None),
                                     ("thread", "pipelined", "thread"),
                                     ("process", "pipelined", "process")):
            eng.comm_stats.reset()
            state, losses, _ = eng.run_epoch_minibatch(
                steps, schedule, state=eng.init_minibatch_state(params),
                prefetch_mode=mode)
            out[f"{tag}/{name}/losses"] = np.array(losses)
            for l, p in enumerate(state["params"]["layers"]):
                for key, a in p.items():
                    out[f"{tag}/{name}/final/{l}/{key}"] = a.numpy()
            out[f"{tag}/{name}/comm"] = np.array(json.dumps(
                dataclasses.asdict(eng.comm_stats)))
        out[f"{tag}/workers"] = np.array(eng._proc_pool.num_workers)
        eng.close_prefetch_pool()
        mark = f"-{os.getpid():x}-"
        out[f"{tag}/litter"] = np.array(len([
            f for f in os.listdir(SHM_DIR)
            if f.startswith(SHM_PREFIX) and mark in f]))
    leave_group(args)
    np.savez(out_path, **out)
except BaseException:
    traceback.print_exc()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(1)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's pipelined epoch on 4 host devices and the port's three epochs
    on 4 gloo ranks, run together; the ranks start from the JAX run's own
    `init_minibatch_state()` weights, drawn here with the reference's
    `init_gnn_params` and the seed's key (the JAX run writes its weights
    too, and they must be the same)."""
    from repro.core.models.gnn import init_gnn_params as jinit_gnn_params

    tmp = tmp_path_factory.mktemp("torch_pipeline")
    jg = jsbm_graph(**SBM)
    dims = [jg.features.shape[1], MB["hidden"], int(jg.labels.max()) + 1]
    init = {}
    for tag in FOUR_TAGS:
        tree = jinit_gnn_params("gcn", dims, jax.random.PRNGKey(0))
        for l, p in enumerate(tree["layers"]):
            for key, a in p.items():
                init[f"{tag}/init/{l}/{key}"] = np.asarray(a)
    init_path = str(tmp / "init.npz")
    np.savez(init_path, **init)
    mb = dict(MB, fanouts=list(MB["fanouts"]),
              layer_sizes=list(MB["layer_sizes"]))
    jax_path = str(tmp / "jax.npz")
    code = _JAX_CODE.format(args=json.dumps(
        [CONFIGS, FOUR_TAGS, mb, SBM, STEPS, jax_path]))
    jax_error = []

    def jax_side():
        try:
            run_with_devices(code, n_devices=WORLD, timeout=RANK_TIMEOUT)
        except BaseException as e:  # re-raised below, in the test's thread
            jax_error.append(e)

    jax_thread = threading.Thread(target=jax_side)
    jax_thread.start()
    rank_paths = [str(tmp / f"rank{r}.npz") for r in range(WORLD)]
    try:
        outs = _run_ranks([[sys.executable, "-c", _RANK_CODE, json.dumps([
            CONFIGS, FOUR_TAGS, mb, SBM, STEPS, r, WORLD, str(tmp),
            init_path, rank_paths[r]])] for r in range(WORLD)],
            timeout=RANK_TIMEOUT)
    finally:
        jax_thread.join()
    if jax_error:
        raise jax_error[0]
    return dict(init=init, jax=dict(np.load(jax_path)),
                ranks=[dict(np.load(p)) for p in rank_paths],
                stderr=[err for _, _, err in outs])


def _final(res, prefix):
    return {f"{l}/{key}": res[f"{prefix}/final/{l}/{key}"]
            for l in range(MB["num_layers"]) for key in PARAM_KEYS["gcn"]}


@pytest.mark.parametrize("i,mode", [(i, m) for i in range(len(CONFIGS))
                                    for m in MODES],
                         ids=[f"{t}-{m}" for t in FOUR_TAGS for m in MODES])
def test_four_ranks_pipelined_is_the_blocking_epoch_and_jax_s(runs, i, mode):
    """On every rank the pipelined epoch equals the conventional epoch bit
    for bit (losses, params, CommStats), every rank reports the same, the
    losses and params are within 1e-4 of JAX's pipelined epoch on four
    devices from the same weights, CommStats equal JAX's, and the pool's
    segments are gone after `close_prefetch_pool()`."""
    tag = FOUR_TAGS[i]
    jx = {key[len(tag) + 1:]: a for key, a in runs["jax"].items()
          if key.startswith(tag + "/")}
    for key, a in runs["init"].items():  # the JAX run's own weights
        if key.startswith(tag + "/"):
            assert np.array_equal(jx[key[len(tag) + 1:]], a), key
    jcomm = json.loads(str(jx["comm"]))
    first = runs["ranks"][0]
    for res in runs["ranks"]:
        base, run = f"{tag}/conventional", f"{tag}/{mode}"
        assert np.array_equal(res[f"{run}/losses"], res[f"{base}/losses"])
        assert np.array_equal(res[f"{run}/losses"], first[f"{run}/losses"])
        ours, blocking = _final(res, run), _final(res, base)
        for key, a in ours.items():
            assert np.array_equal(a, blocking[key]), key
            assert np.array_equal(a, _final(first, run)[key]), key
            _close(a, jx[f"final/{key}"], f"{tag} param {key}")
        _close(res[f"{run}/losses"], jx["losses"], f"{tag} losses")
        comm = json.loads(str(res[f"{run}/comm"]))
        assert comm == json.loads(str(res[f"{base}/comm"])) == jcomm
        assert comm["pull_bytes"] > 0 and comm["cache_hit_bytes"] > 0
        assert int(res[f"{tag}/workers"]) in (1, 2)
        assert int(res[f"{tag}/litter"]) == 0
    assert {int(res[f"{tag}/workers"]) for res in runs["ranks"]} == {1, 2}
    for err in runs["stderr"]:
        assert "leaked shared_memory" not in err, err
