"""The port's sampled mini-batch step: `repro_torch`'s `DistGNNEngine` with
batching node_wise, layer_wise and subgraph on the CPU against the JAX
engine's `make_minibatch_step`, from the reference's own
`init_minibatch_state()` weights carried over by `params_from_numpy`, on the
same sampled batches (host sampling is deterministic in (seed, step,
rank) in both packages).

One rank (a 1-device Auto-axis mesh on the JAX side): gcn under every
batching and execution model, sage, gin and gat node-wise, and p2p at
exchange_chunks 2 and p2p_buckets 2.  Four gloo ranks (four CPU processes,
one `torch.distributed` group joined through the training launcher's
options) against the JAX engine on four forced host devices: gcn under
every batching and execution model, node-wise with the static_degree cache
under each execution model on a power-law graph, and sage, gin and gat
node-wise.  Per step the loss and the target logits, and the final params,
within 1e-4 of JAX's and of the port's own reference step; every rank
reporting the same numbers; a second engine's run bitwise equal; CommStats
equal to JAX's and to `feature_fetch_bytes`, the cache hitting with the
bytes asked for unchanged; the collectives counted exactly; the three
blocking schedules' losses equal; the config guards; and `train_gnn.main
--batching node_wise` and `serve_gnn.main --train-steps 3` on one rank and
on four.

Every rank process has its own time limit, and a rank that raises exits at
once, so a fault fails the tier instead of hanging it."""
import dataclasses
import json
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
from repro_torch.core.execution import collectives
from repro_torch.core.graph import sbm_graph
from repro_torch.core.models.gnn import PARAM_KEYS, params_from_numpy
from repro_torch.kernels.ell_spmm import ell_spmm
from repro_torch.launch import serve_gnn, train_gnn
from test_torch_distributed import _run_ranks

ORACLE_TOL = 1e-4
CPU = torch.device("cpu")
STEPS = 3
WORLD = 4
RANK_TIMEOUT = 240  # seconds, for each rank process
SBM = dict(num_vertices=96, num_blocks=8, p_in=0.08, p_out=0.01)
POWERLAW = dict(num_vertices=120, avg_degree=8, seed=2)
# the sampler settings of every case: 2 layers of 16, batch 8, fanouts 3, 3
MB = dict(hidden=16, num_layers=2, batch_size=8, fanouts=(3, 3),
          layer_sizes=(16, 16), walk_length=3)
BATCHINGS = ("node_wise", "layer_wise", "subgraph")
EXECUTIONS = ("broadcast", "ring", "p2p")


def _case(model="gcn", batching="node_wise", execution="p2p", chunks=1,
          buckets=1, partitioner="hash", cache="none", graph="sbm"):
    return dict(model=model, batching=batching, execution=execution,
                chunks=chunks, buckets=buckets, partitioner=partitioner,
                cache=cache, graph=graph)


def _tag(c):
    tag = f"{c['model']}-{c['batching']}-{c['execution']}"
    if c["chunks"] > 1 or c["buckets"] > 1:
        tag += f"-c{c['chunks']}b{c['buckets']}"
    if c["cache"] != "none":
        tag += f"-{c['cache']}"
    return tag


def _config(c, cls, **extra):
    return cls(model=c["model"], batching=c["batching"],
               execution=c["execution"], exchange_chunks=c["chunks"],
               p2p_buckets=c["buckets"], partitioner=c["partitioner"],
               cache_policy=c["cache"],
               cache_capacity=12 if c["cache"] != "none" else 0, **MB,
               **extra)


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------

ONE = [_case(batching=b, execution=e) for b in BATCHINGS for e in EXECUTIONS]
ONE += [_case("sage", execution="p2p"), _case("gin", execution="broadcast"),
        _case("gat", execution="ring"),
        _case("gcn", execution="p2p", chunks=2, buckets=2),
        _case("gat", "layer_wise", "p2p", chunks=2, buckets=2)]
MESH1 = None


def _jax_engine(c):
    global MESH1
    if MESH1 is None:
        MESH1 = jax.make_mesh((1,), ("w",), axis_types=(AxisType.Auto,))
    return JDistGNNEngine(jsbm_graph(**SBM), mesh=MESH1,
                          cfg=_config(c, JEngineConfig, interpret=True))


def _port_run(eng, params, steps=STEPS):
    """``steps`` steps of the engine's step and, beside each, its reference
    step, each from its own state on the same batch; CommStats reset
    first."""
    step, ref_step = eng.make_minibatch_step(), eng.make_reference_minibatch_step()
    state = ref_state = eng.init_minibatch_state(params)
    eng.comm_stats.reset()
    out = dict(losses=[], logits=[], ref_losses=[], ref_logits=[])
    for i in range(steps):
        batch = eng.sample_minibatch(i)
        state, metrics, logits = step(state, batch)
        ref_state, ref_metrics, ref_logits = ref_step(ref_state, batch)
        out["losses"].append(float(metrics["loss"]))
        out["logits"].append(logits.numpy())
        out["ref_losses"].append(float(ref_metrics["loss"]))
        out["ref_logits"].append(ref_logits.numpy())
    out.update(state=state, ref_state=ref_state,
               comm=dataclasses.asdict(eng.comm_stats))
    return out


def _close(ours, theirs, what=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               atol=ORACLE_TOL, rtol=0, err_msg=what)


@pytest.mark.parametrize("c", ONE, ids=[_tag(c) for c in ONE])
def test_one_rank_matches_jax_and_its_reference(c):
    jeng = _jax_engine(c)
    jstate = jeng.init_minibatch_state()
    params = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]), CPU)
    jstep = jeng.make_minibatch_step()
    jeng.comm_stats.reset()
    jlosses, jlogits = [], []
    for i in range(STEPS):
        jstate, jm, jl = jstep(jstate, jeng.sample_minibatch(i))
        jlosses.append(float(jm["loss"]))
        jlogits.append(np.asarray(jl))
    launches = ell_spmm.launches
    runs = []
    for _ in range(2):  # a second engine: bitwise equal
        eng = DistGNNEngine(sbm_graph(**SBM), _config(c, EngineConfig),
                            device=CPU)
        assert list(eng.caps) == list(jeng.caps) and eng.fcap == jeng.fcap
        runs.append(_port_run(eng, params))
    run, again = runs
    assert ell_spmm.launches == launches  # the CPU launches no kernel
    _close(run["losses"], jlosses, "losses")
    _close(run["ref_losses"], jlosses, "reference losses")
    for ours, ref, theirs in zip(run["logits"], run["ref_logits"], jlogits):
        assert ours.shape == theirs.shape == ref.shape
        _close(ours, theirs, "logits")
        _close(ref, theirs, "reference logits")
    for ours, ref, theirs in zip(run["state"]["params"]["layers"],
                                 run["ref_state"]["params"]["layers"],
                                 jstate["params"]["layers"]):
        for key in PARAM_KEYS[c["model"]]:
            _close(ours[key], theirs[key], key)
            _close(ref[key], theirs[key], key)
    assert run["comm"] == dataclasses.asdict(jeng.comm_stats)
    assert run["losses"] == again["losses"]
    for a, b in zip(run["logits"] + run["ref_logits"],
                    again["logits"] + again["ref_logits"]):
        assert np.array_equal(a, b)
    for a, b in zip(run["state"]["params"]["layers"],
                    again["state"]["params"]["layers"]):
        for key in PARAM_KEYS[c["model"]]:
            assert torch.equal(a[key], b[key])


def test_schedules_train_and_sweep_on_a_minibatch_engine():
    """The three blocking schedules give the step loop's losses (and the
    reference's within 1e-4) with their stage times; `train` gives them
    too, with every rank's target logits [k, cap_L, C]; the layer-wise
    sweep of a mini-batch engine equals a full-graph engine's bit for
    bit; the accuracy of both logits forms agrees."""
    c = _case("sage", execution="p2p")
    eng = DistGNNEngine(sbm_graph(**SBM), _config(c, EngineConfig), device=CPU)
    run = _port_run(eng, None)
    comm = run["comm"]
    for schedule in ("conventional", "factored", "operator_parallel"):
        state, losses, times = eng.run_epoch_minibatch(STEPS, schedule)
        assert losses == run["losses"], schedule
        assert dataclasses.asdict(eng.comm_stats) == comm
        assert min(times.sample, times.extract, times.train) > 0
        # conventional measures its wall (the stages and the loop around
        # them); the other two model an overlap of their lanes
        assert times.wall > 0 and (schedule == "conventional"
                                   or times.wall <= times.busy())
        for a, b in zip(state["params"]["layers"],
                        run["state"]["params"]["layers"]):
            assert all(torch.equal(a[key], b[key]) for key in a)
    _, ref_losses, _ = eng.run_epoch_minibatch(STEPS, reference=True)
    assert ref_losses == run["ref_losses"]
    _close(ref_losses, run["losses"])
    losses, logits = eng.train(STEPS)
    assert losses == run["losses"]
    assert np.array_equal(logits.numpy(), run["logits"][-1])
    ref_losses, ref_logits = eng.train(STEPS, reference=True)
    assert tuple(ref_logits.shape) == (1, eng.caps[-1], eng.dims[-1])
    batch = eng.sample_minibatch(STEPS - 1)
    y, w = batch["arrays"]["y"], batch["arrays"]["w"]
    for out in (logits, ref_logits):
        right = (out.numpy().argmax(-1) == y) * w
        assert eng.minibatch_accuracy(out, batch) == pytest.approx(
            right.sum() / max(w.sum(), 1.0))
    params = run["state"]["params"]
    full = DistGNNEngine(sbm_graph(**SBM), dataclasses.replace(
        eng.cfg, batching="full_graph"), device=CPU)
    assert np.array_equal(eng.infer_full_graph(params=params).numpy(),
                          full.infer_full_graph(params=params).numpy())


def test_minibatch_rejects_bad_config():
    """The reference's guards (`test_minibatch_rejects_bad_config`): an
    unknown batching, a mini-batch mode under an async protocol, an
    unknown cache policy, fanouts short of num_layers, a replica family
    under mini-batch, each a ValueError; trainable features, ported, build
    their state (the embedding table, zero moments and counts); the
    pipelined schedule refuses an unknown prefetch mode and a depth of
    0."""
    g = sbm_graph(**SBM)
    for cfg in (EngineConfig(batching="nope"),
                EngineConfig(batching="node_wise", protocol="variation"),
                EngineConfig(cache_policy="nope"),
                EngineConfig(batching="node_wise", fanouts=(3,)),
                EngineConfig(batching="layer_wise", layer_sizes=(3, 3, 3)),
                EngineConfig(batching="node_wise",
                             partition_family="vertex_cut"),
                EngineConfig(batching="subgraph", partition_family="hybrid")):
        with pytest.raises(ValueError):
            DistGNNEngine(g, cfg, device=CPU)
    for batching in ("full_graph", "node_wise"):
        eng = DistGNNEngine(g, EngineConfig(batching=batching,
                                            trainable_features=True),
                            device=CPU)
        state = (eng.init_state() if batching == "full_graph"
                 else eng.init_minibatch_state())
        assert tuple(state["embed"].shape) == (eng.nb, 32)
        assert tuple(state["emb_t"].shape) == (eng.nb,)
        assert not (state["emb_m"].any() or state["emb_v"].any()
                    or state["emb_t"].any())
    eng = DistGNNEngine(g, EngineConfig(batching="node_wise"), device=CPU)
    # the pipelined schedule runs (the blocking epoch's losses) and refuses
    # an unknown prefetch mode
    assert (eng.run_epoch_minibatch(2, schedule="pipelined")[1]
            == eng.run_epoch_minibatch(2)[1])
    with pytest.raises(ValueError, match="prefetch_mode"):
        eng.run_epoch_minibatch(2, schedule="pipelined", prefetch_mode="nope")
    with pytest.raises(ValueError, match="schedule"):
        eng.run_epoch_minibatch(2, schedule="nope")
    eng.cfg.protocol = "epoch_fixed"  # mutated after construction
    with pytest.raises(ValueError, match="protocol"):
        eng.run_epoch_minibatch(2)
    full = DistGNNEngine(g, EngineConfig(), device=CPU)
    for call in (full.make_minibatch_step, lambda: full.run_epoch_minibatch(2)):
        with pytest.raises(ValueError, match="full_graph"):
            call()
    with pytest.raises(ValueError, match="prefetch_depth"):
        train_gnn.main(["--device", "cpu", "--batching", "node_wise",
                        "--schedule", "pipelined", "--prefetch-depth", "0",
                        "--vertices", "48"])


def test_entry_points_on_one_rank():
    out = train_gnn.main(["--device", "cpu", "--batching", "node_wise",
                          "--vertices", "128", "--epochs", "4",
                          "--fanouts", "3,3", "--cache", "static_degree",
                          "--cache-capacity", "16", "--oracle-check",
                          "--infer"])
    assert out["oracle_gap"] <= ORACLE_TOL and out["infer_gap"] <= ORACLE_TOL
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    for schedule in ("factored", "operator_parallel"):
        again = train_gnn.main(["--device", "cpu", "--batching", "node_wise",
                                "--vertices", "128", "--epochs", "4",
                                "--fanouts", "3,3", "--schedule", schedule])
        assert again["losses"] == out["losses"]
    for batching in ("layer_wise", "subgraph"):
        res = train_gnn.main(["--device", "cpu", "--batching", batching,
                              "--vertices", "96", "--epochs", "2",
                              "--exec", "ring", "--oracle-check"])
        assert res["oracle_gap"] <= ORACLE_TOL
    emb, wall = serve_gnn.main(["--device", "cpu", "--vertices", "64",
                                "--train-steps", "3", "--oracle-check"])
    assert emb.shape == (64, 8) and np.isfinite(emb).all() and wall > 0
    emb, _ = serve_gnn.main(["--device", "cpu", "--vertices", "64",
                             "--train-steps", "3", "--partition-family",
                             "vertex_cut", "--oracle-check"])
    assert np.isfinite(emb).all()


# ---------------------------------------------------------------------------
# four gloo ranks against JAX on four forced host devices
# ---------------------------------------------------------------------------

FOUR = [_case(batching=b, execution=e, partitioner=p, chunks=ch, buckets=bu)
        for b, e, p, ch, bu in (
            ("node_wise", "p2p", "metis_like", 1, 1),
            ("node_wise", "broadcast", "hash", 1, 1),
            ("node_wise", "ring", "hash", 1, 1),
            ("layer_wise", "p2p", "hash", 2, 2),
            ("layer_wise", "broadcast", "range", 2, 1),
            ("layer_wise", "ring", "hash", 1, 1),
            ("subgraph", "p2p", "hash", 1, 2),
            ("subgraph", "broadcast", "hash", 1, 1),
            ("subgraph", "ring", "range", 1, 1))]
FOUR += [_case(execution=e, cache="static_degree", graph="powerlaw")
         for e in EXECUTIONS]
FOUR += [_case("sage", execution="p2p", chunks=2, buckets=2),
         _case("gin", execution="broadcast"), _case("gat", execution="ring")]
FOUR_TAGS = [_tag(c) for c in FOUR]

_JAX_CODE = """
import dataclasses, json
import jax, numpy as np
from jax.sharding import AxisType
from repro.core.engine import DistGNNEngine, EngineConfig
from repro.core.graph import powerlaw_graph, sbm_graph
configs, tags, mb, graphs, steps, out_path = json.loads({args!r})
mb["fanouts"], mb["layer_sizes"] = tuple(mb["fanouts"]), tuple(mb["layer_sizes"])
mesh = jax.make_mesh((4,), ("w",), axis_types=(AxisType.Auto,))
built = dict(sbm=sbm_graph(**graphs["sbm"]),
             powerlaw=powerlaw_graph(**graphs["powerlaw"]))
out = {{}}
for c, tag in zip(configs, tags):
    cfg = EngineConfig(model=c["model"], batching=c["batching"],
                       execution=c["execution"], exchange_chunks=c["chunks"],
                       p2p_buckets=c["buckets"], partitioner=c["partitioner"],
                       cache_policy=c["cache"],
                       cache_capacity=12 if c["cache"] != "none" else 0,
                       interpret=True, **mb)
    eng = DistGNNEngine(built[c["graph"]], mesh=mesh, cfg=cfg)
    state = eng.init_minibatch_state()
    for l, p in enumerate(state["params"]["layers"]):
        for key, a in p.items():
            out[f"{{tag}}/init/{{l}}/{{key}}"] = np.asarray(a)
    step = eng.make_minibatch_step()
    eng.comm_stats.reset()
    for i in range(steps):
        state, metrics, logits = step(state, eng.sample_minibatch(i))
        out[f"{{tag}}/loss/{{i}}"] = np.array(float(metrics["loss"]))
        out[f"{{tag}}/logits/{{i}}"] = np.asarray(logits)
    for l, p in enumerate(state["params"]["layers"]):
        for key, a in p.items():
            out[f"{{tag}}/final/{{l}}/{{key}}"] = np.asarray(a)
    out[f"{{tag}}/comm"] = np.array(json.dumps(
        dataclasses.asdict(eng.comm_stats)))
    out[f"{{tag}}/plan"] = np.array(json.dumps(
        [list(eng.caps), int(eng.fcap),
         list(eng.fcap_widths) if cfg.execution == "p2p" else None]))
np.savez(out_path, **out)
print("JAX DONE", len(configs))
"""

_RANK_CODE = """
import dataclasses, json, os, sys, traceback
try:
    import numpy as np
    import torch
    from repro_torch.core.engine import DistGNNEngine, EngineConfig
    from repro_torch.core.execution import collectives
    from repro_torch.core.graph import powerlaw_graph, sbm_graph
    from repro_torch.core.models.gnn import PARAM_KEYS, params_from_numpy
    from repro_torch.core.sampling.distributed import feature_fetch_bytes
    from repro_torch.launch import serve_gnn, train_gnn
    from repro_torch.launch.common import join_group, leave_group

    (configs, tags, mb, graphs, steps, rank, world, tmp, init_path,
     out_path) = json.loads(sys.argv[1])
    built = dict(sbm=sbm_graph(**graphs["sbm"]),
                 powerlaw=powerlaw_graph(**graphs["powerlaw"]))
    given = np.load(init_path)
    out = {}

    def per_layer(values):
        return ",".join(str(v) for v in values)

    def build(c, args):
        # through the launcher, but for p2p's buckets (no launcher option)
        if c["buckets"] == 1:
            return train_gnn.build_engine(args, built[c["graph"]])
        return DistGNNEngine(built[c["graph"]], EngineConfig(
            model=c["model"], batching=c["batching"],
            execution=c["execution"], exchange_chunks=c["chunks"],
            p2p_buckets=c["buckets"], partitioner=c["partitioner"],
            cache_policy=c["cache"],
            cache_capacity=12 if c["cache"] != "none" else 0,
            hidden=mb["hidden"], num_layers=mb["num_layers"],
            batch_size=mb["batch_size"], fanouts=tuple(mb["fanouts"]),
            layer_sizes=tuple(mb["layer_sizes"]),
            walk_length=mb["walk_length"]), device="cpu")

    def gathered(eng, logits):  # this rank's [1, capL, C] -> [k, capL, C]
        return eng.gather_rows(logits[0]).view(eng.k, *logits.shape[1:])

    def run(c, args, tag, first):
        eng = build(c, args)
        L = mb["num_layers"]
        params = params_from_numpy({"layers": [
            {key: given[f"{tag}/init/{l}/{key}"]
             for key in PARAM_KEYS[c["model"]]} for l in range(L)]},
            eng.device)
        eng.comm_stats.reset()
        batches = [eng.sample_minibatch(i) for i in range(steps)]
        res = dict(comm=np.array(json.dumps(dataclasses.asdict(
            eng.comm_stats))))
        # the cost model: every rank's frontier, hits and misses, and the
        # bytes asked for with no cache
        part, D = eng.playout.part, eng.g.features.shape[1]
        pull = hit = asked = 0
        for i in range(steps):
            for d, m in enumerate(eng._sample_host(i)):
                lv0 = m.layer_vertices[0]
                pull += feature_fetch_bytes(
                    part, d, lv0, D, eng.host_builder.cache_sets[d])
                asked += feature_fetch_bytes(part, d, lv0, D)
        res["model"] = np.array([pull, asked])
        step, ref_step = (eng.make_minibatch_step(),
                          eng.make_reference_minibatch_step())
        state = ref_state = eng.init_minibatch_state(params)
        collectives.zero_calls()
        for i, b in enumerate(batches):
            state, metrics, logits = step(state, b)
            res[f"loss/{i}"] = np.array(float(metrics["loss"]))
            res[f"logits/{i}"] = logits
        calls = collectives.read_calls()
        for i in range(steps):
            res[f"logits/{i}"] = gathered(eng, res[f"logits/{i}"]).numpy()
        collectives.zero_calls()
        for i, b in enumerate(batches):
            ref_state, ref_metrics, ref_logits = ref_step(ref_state, b)
            res[f"ref_loss/{i}"] = np.array(float(ref_metrics["loss"]))
            res[f"ref_logits/{i}"] = ref_logits.numpy()
        res["calls"] = np.array(json.dumps(dict(
            steps=calls, ref=collectives.read_calls())))
        res["plan"] = np.array(json.dumps(
            [list(eng.caps), int(eng.fcap),
             list(eng.fcap_widths) if eng.cfg.execution == "p2p" else None]))
        for name, tree in (("final", state["params"]),
                           ("ref_final", ref_state["params"])):
            for l, p in enumerate(tree["layers"]):
                for key, a in p.items():
                    res[f"{name}/{l}/{key}"] = a.numpy()
        if first:  # the three blocking schedules from the same weights
            for s in ("conventional", "factored", "operator_parallel"):
                _, losses, times = eng.run_epoch_minibatch(
                    steps, s, state=eng.init_minibatch_state(params))
                res[f"schedule/{s}"] = np.array(losses)
                res[f"schedule_times/{s}"] = np.array(
                    [times.sample, times.extract, times.train, times.wall])
        return res

    args = None
    for n, (c, tag) in enumerate(zip(configs, tags)):
        argv = ["--device", "cpu", "--world-size", str(world), "--rank",
                str(rank), "--init-method", f"file://{tmp}/rendezvous",
                "--model", c["model"], "--batching", c["batching"],
                "--exec", c["execution"], "--exchange-chunks",
                str(c["chunks"]), "--partitioner", c["partitioner"],
                "--cache", c["cache"], "--cache-capacity",
                "12" if c["cache"] != "none" else "0", "--hidden",
                str(mb["hidden"]), "--layers", str(mb["num_layers"]),
                "--batch-size", str(mb["batch_size"]), "--fanouts",
                per_layer(mb["fanouts"]), "--layer-sizes",
                per_layer(mb["layer_sizes"]), "--walk-length",
                str(mb["walk_length"])]
        args = train_gnn.parse_args(argv)
        if n == 0:
            join_group(args)
        for run_i in (0, 1):  # a second engine and run: bitwise equal
            for name, a in run(c, args, tag, n == 0 and run_i == 0).items():
                out[f"{tag}/{run_i}/{name}"] = a
    leave_group(args)
    # the entry points, each in a group of its own
    common = ["--device", "cpu", "--world-size", str(world), "--rank",
              str(rank), "--vertices", "90", "--hidden", "16"]
    res = train_gnn.main(common + [
        "--init-method", f"file://{tmp}/train", "--batching", "node_wise",
        "--batch-size", "8", "--fanouts", "3,3", "--epochs", "3",
        "--cache", "static_degree", "--cache-capacity", "16",
        "--oracle-check", "--infer"])
    out["main/train"] = np.array(res["losses"] + [res["oracle_gap"],
                                                  res["infer_gap"]])
    out["main/train_comm"] = np.array(json.dumps(res["comm"]))
    emb, _ = serve_gnn.main(common + [
        "--init-method", f"file://{tmp}/serve", "--model", "sage",
        "--train-steps", "3", "--batch-size", "8", "--oracle-check"])
    out["main/serve"] = emb
    np.savez(out_path, **out)
except BaseException:
    traceback.print_exc()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(1)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX on 4 host devices and the port on 4 gloo ranks, run together;
    the ranks start from the JAX run's own `init_minibatch_state()`
    weights, drawn here with the reference's `init_gnn_params` and the
    seed's key (the JAX run writes its weights too, and they must be the
    same)."""
    from repro.core.graph import powerlaw_graph as jpowerlaw_graph
    from repro.core.models.gnn import init_gnn_params as jinit_gnn_params

    tmp = tmp_path_factory.mktemp("torch_minibatch")
    graphs = dict(sbm=SBM, powerlaw=POWERLAW)
    classes = dict(sbm=int(jsbm_graph(**SBM).labels.max()) + 1,
                   powerlaw=int(jpowerlaw_graph(**POWERLAW).labels.max()) + 1)
    init = {}
    for c, tag in zip(FOUR, FOUR_TAGS):
        dims = [32, MB["hidden"], classes[c["graph"]]]
        tree = jinit_gnn_params(c["model"], dims, jax.random.PRNGKey(0))
        for l, p in enumerate(tree["layers"]):
            for key, a in p.items():
                init[f"{tag}/init/{l}/{key}"] = np.asarray(a)
    init_path = str(tmp / "init.npz")
    np.savez(init_path, **init)
    mb = dict(MB, fanouts=list(MB["fanouts"]),
              layer_sizes=list(MB["layer_sizes"]))
    jax_path = str(tmp / "jax.npz")
    code = _JAX_CODE.format(args=json.dumps(
        [FOUR, FOUR_TAGS, mb, graphs, STEPS, jax_path]))
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
        _run_ranks([[sys.executable, "-c", _RANK_CODE, json.dumps([
            FOUR, FOUR_TAGS, mb, graphs, STEPS, r, WORLD, str(tmp),
            init_path, rank_paths[r]])] for r in range(WORLD)],
            timeout=RANK_TIMEOUT)
    finally:
        jax_thread.join()
    if jax_error:
        raise jax_error[0]
    return dict(init=init, jax=dict(np.load(jax_path)),
                ranks=[dict(np.load(p)) for p in rank_paths])


def _params(res, prefix, model):
    return {f"{l}/{key}": res[f"{prefix}/{l}/{key}"]
            for l in range(MB["num_layers"]) for key in PARAM_KEYS[model]}


def _jx(runs, tag):
    return {key[len(tag) + 1:]: a for key, a in runs["jax"].items()
            if key.startswith(tag + "/")}


@pytest.mark.parametrize("i", range(len(FOUR)), ids=FOUR_TAGS)
def test_four_ranks_match_jax(runs, i):
    c, tag = FOUR[i], FOUR_TAGS[i]
    jx = _jx(runs, tag)
    for key, a in runs["init"].items():  # the JAX run's own weights
        if key.startswith(tag + "/"):
            assert np.array_equal(jx[key[len(tag) + 1:]], a), key
    for res in runs["ranks"]:
        run = f"{tag}/0"
        assert json.loads(str(res[f"{run}/plan"])) == json.loads(
            str(jx["plan"]))
        for s in range(STEPS):
            _close(res[f"{run}/loss/{s}"], jx[f"loss/{s}"], f"{tag} loss")
            assert res[f"{run}/logits/{s}"].shape == jx[f"logits/{s}"].shape
            _close(res[f"{run}/logits/{s}"], jx[f"logits/{s}"], tag)
        for key, a in _params(res, f"{run}/final", c["model"]).items():
            _close(a, jx[f"final/{key}"], f"{tag} param {key}")
            assert not np.array_equal(a, jx[f"init/{key}"]) or key.endswith(
                "/b"), f"{tag} {key} did not train"


@pytest.mark.parametrize("i", range(len(FOUR)), ids=FOUR_TAGS)
def test_four_ranks_match_the_port_reference(runs, i):
    c, tag = FOUR[i], FOUR_TAGS[i]
    for res in runs["ranks"]:
        run = f"{tag}/0"
        for s in range(STEPS):
            _close(res[f"{run}/loss/{s}"], res[f"{run}/ref_loss/{s}"], tag)
            _close(res[f"{run}/logits/{s}"], res[f"{run}/ref_logits/{s}"],
                   tag)
        ref = _params(res, f"{run}/ref_final", c["model"])
        for key, a in _params(res, f"{run}/final", c["model"]).items():
            _close(a, ref[key], f"{tag} param {key}")


@pytest.mark.parametrize("i", range(len(FOUR)), ids=FOUR_TAGS)
def test_ranks_agree_and_a_second_run_is_bitwise_equal(runs, i):
    tag = FOUR_TAGS[i]
    first = runs["ranks"][0]
    names = [key[len(tag) + 3:] for key in first
             if key.startswith(f"{tag}/0/") and "schedule" not in key]
    assert len(names) > 10
    for res in runs["ranks"]:
        for name in names:
            for run in (0, 1):
                assert np.array_equal(res[f"{tag}/{run}/{name}"],
                                      first[f"{tag}/0/{name}"]), (name, run)


@pytest.mark.parametrize("i", range(len(FOUR)), ids=FOUR_TAGS)
def test_comm_stats_cache_and_collective_counts(runs, i):
    """CommStats equal JAX's and `feature_fetch_bytes` on every rank: the
    pulled bytes its misses, the cache's hits the rest of the bytes asked
    for (the cache must hit on the power-law graph).  A step calls, per
    feature chunk, an all_gather (broadcast) or an all_to_all per
    installment (p2p), or k - 1 rotations (the ring, unchunked), and one
    all_reduce; no backward through the fetch; the reference calls
    none."""
    c, tag = FOUR[i], FOUR_TAGS[i]
    jcomm = json.loads(str(runs["jax"][f"{tag}/comm"]))
    plan = json.loads(str(runs["jax"][f"{tag}/plan"]))
    none = dict(all_gather=0, reduce_scatter=0, all_to_all=0, ppermute=0,
                all_reduce=0)
    for res in runs["ranks"]:
        comm = json.loads(str(res[f"{tag}/0/comm"]))
        assert comm == jcomm
        pull, asked = res[f"{tag}/0/model"].tolist()
        assert comm["pull_bytes"] == pull > 0
        assert comm["pull_bytes"] + comm["cache_hit_bytes"] == asked
        assert (comm["cache_hit_bytes"] > 0) == (c["cache"] != "none")
        assert sum(comm.values()) == asked
        calls = json.loads(str(res[f"{tag}/0/calls"]))
        C = c["chunks"]
        if c["execution"] == "broadcast":
            want = dict(all_gather=C * STEPS)
        elif c["execution"] == "ring":
            want = dict(ppermute=(WORLD - 1) * STEPS)
        else:
            want = dict(all_to_all=C * len(plan[2]) * STEPS)
            assert (len(plan[2]) > 1) == (c["buckets"] > 1 and plan[1] > 1)
        assert calls["steps"] == {**none, **want, "all_reduce": STEPS}
        assert calls["ref"] == none


def test_four_rank_schedules_and_entry_points(runs):
    """The three blocking schedules' losses equal the step loop's on every
    rank; `train_gnn.main --batching node_wise` (oracle and sweep checks)
    and `serve_gnn.main --train-steps 3` report the same numbers on every
    rank."""
    tag = FOUR_TAGS[0]
    first = runs["ranks"][0]
    for res in runs["ranks"]:
        losses = [float(res[f"{tag}/0/loss/{s}"]) for s in range(STEPS)]
        for s in ("conventional", "factored", "operator_parallel"):
            assert res[f"{tag}/0/schedule/{s}"].tolist() == losses, s
            assert (res[f"{tag}/0/schedule_times/{s}"] > 0).all()
        for key in ("main/train", "main/train_comm", "main/serve"):
            assert np.array_equal(res[key], first[key]), key
    train = first["main/train"]
    assert np.isfinite(train).all() and (train[-2:] <= ORACLE_TOL).all()
    assert json.loads(str(first["main/train_comm"]))["cache_hit_bytes"] > 0
    assert first["main/serve"].shape == (90, 8)
    assert np.isfinite(first["main/serve"]).all()
