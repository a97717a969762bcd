"""The port's multi-rank execution models and protocols: `repro_torch`'s
full-graph step and layer-wise sweep on four gloo ranks (four CPU processes,
one `torch.distributed` group, joined through the launchers' group path)
against the JAX engine on four forced host devices (Auto-axis mesh, Pallas
interpret), on a graph with isolated vertices and unequal parts: broadcast
for gcn, sage, gin and gat at exchange_chunks 1 and 2 under the hash and
range partitioners, the bucketed p2p halo exchange in four configurations
of model, partitioner, chunks and buckets, the first of them the default
`EngineConfig()` (p2p, metis_like, one bucket) on both sides, the ring for
gcn, sage and gat, the three historical-embedding protocols (broadcast
gcn epoch_fixed, p2p gat epoch_adaptive, ring gin variation), and the
replica families: the vertex cut in six configurations (the three cuts,
the three execution models, gin under epoch_fixed, and sorted masters) and the hybrid cut in
five (p2p over metis_like with two buckets, gat's ring, sage under
broadcast at chunks 2, and the degenerate thresholds inf, halo only, and
0, replica sync only).  From the
reference's own initial weights: the per-step loss, the final logits and
params, and the sweep within 1e-4 of JAX's and of the port's own reference
step; under a protocol each layer's gathered history within 1e-4 and the
ages and rows pushed exactly JAX's and the reference's; every rank
reporting the same numbers; a second run bitwise equal; CommStats equal to
JAX's; the collectives counted exactly (the ring's rotations and their
reverse included); a partition whose part count is not the rank count
refused; and the two entry points on four ranks.

Every process has its own time limit, and a rank that raises exits at
once, so a fault fails the tier instead of hanging it."""
import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

from conftest import SRC, run_with_devices
from repro_torch.core.models.gnn import PARAM_KEYS

WORLD = 4
STEPS = 3
ORACLE_TOL = 1e-4
RANK_TIMEOUT = 240  # seconds, for each rank process
# 98 vertices over 4 ranks: parts of 24 and 25 (pad rows), 5 isolated
GRAPH = dict(num_vertices=98, avg_degree=3, feature_dim=24, num_classes=5,
             seed=1)
HIDDEN, LAYERS = 16, 3
CONFIGS = [dict(model=model, chunks=chunks, execution="broadcast", buckets=1,
                partitioner=("hash", "range")[chunks - 1])
           for model in ("gcn", "sage", "gin", "gat") for chunks in (1, 2)]
# p2p; the first runs the default EngineConfig() of each package
CONFIGS += [dict(model=model, chunks=chunks, execution="p2p", buckets=buckets,
                 partitioner=partitioner, default=model == "gcn")
            for model, partitioner, chunks, buckets in (
                ("gcn", "metis_like", 1, 1), ("sage", "block", 2, 2),
                ("gin", "ldg", 1, 2), ("gat", "pagraph", 2, 2))]
# the ring (it ignores exchange_chunks), then one configuration under each
# historical-embedding protocol
CONFIGS += [dict(model=model, chunks=chunks, execution=execution,
                 buckets=buckets, partitioner=partitioner, protocol=protocol)
            for model, execution, protocol, partitioner, chunks, buckets in (
                ("gcn", "ring", "sync", "hash", 1, 1),
                ("sage", "ring", "sync", "metis_like", 2, 1),
                ("gat", "ring", "sync", "ldg", 1, 1),
                ("gcn", "broadcast", "epoch_fixed", "hash", 1, 1),
                ("gat", "p2p", "epoch_adaptive", "range", 2, 2),
                ("gin", "ring", "variation", "hash", 1, 1))]
# the replica families: the vertex cut, then the hybrid cut (None: the
# default hub threshold, the 95th percentile of the in-degree)
CONFIGS += [dict(family="vertex_cut", vcut=vcut, model=model,
                 execution=execution, chunks=chunks, buckets=buckets,
                 protocol=protocol, partitioner="hash")
            for model, execution, vcut, protocol, chunks, buckets in (
                ("gcn", "p2p", "cartesian2d", "sync", 1, 1),
                ("sage", "broadcast", "random", "sync", 2, 1),
                ("gin", "ring", "libra", "epoch_fixed", 1, 1),
                ("gat", "p2p", "cartesian2d", "sync", 2, 2),
                ("gat", "broadcast", "libra", "sync", 1, 1))]
# sorted masters: each rank's master slots first (the same math)
CONFIGS += [dict(family="vertex_cut", vcut="random", model="gcn",
                 execution="p2p", chunks=2, buckets=1, protocol="sync",
                 partitioner="hash", sorted_masters=True)]
CONFIGS += [dict(family="hybrid", threshold=threshold, model=model,
                 execution=execution, chunks=chunks, buckets=buckets,
                 partitioner=partitioner)
            for model, execution, partitioner, threshold, chunks, buckets in (
                ("gcn", "p2p", "metis_like", None, 1, 2),
                ("gat", "ring", "hash", None, 1, 1),
                ("sage", "broadcast", "range", None, 2, 1),
                ("gcn", "p2p", "hash", float("inf"), 1, 1),
                ("gat", "broadcast", "hash", 0.0, 2, 1))]
for c in CONFIGS:
    c.setdefault("protocol", "sync")
    c.setdefault("family", "edge_cut")


def _tag(c):
    tag = f"{c['model']}-{c['chunks']}-{c['partitioner']}"
    if c["execution"] == "p2p":
        tag = f"p2p-{tag}-b{c['buckets']}"
    elif c["execution"] == "ring":
        tag = f"ring-{tag}"
    if c["family"] == "vertex_cut":
        sort = "-sorted" if c.get("sorted_masters") else ""
        tag = f"vc-{c['vcut']}{sort}-{tag}"
    elif c["family"] == "hybrid":
        tag = f"hy-{c['threshold']}-{tag}"
    return tag if c["protocol"] == "sync" else f"{tag}-{c['protocol']}"


TAGS = [_tag(c) for c in CONFIGS]

# the reference: every configuration on one 4-device Auto-axis mesh
_JAX_CODE = """
import dataclasses, json
import jax, numpy as np
from jax.sharding import AxisType
from repro.core.engine import DistGNNEngine, EngineConfig
from repro.core.graph import er_graph
configs, tags, graph, out_path = json.loads({args!r})
steps, hidden, layers = {steps}, {hidden}, {layers}
g = er_graph(**graph)
mesh = jax.make_mesh((4,), ("w",), axis_types=(AxisType.Auto,))
out = {{}}
for c, tag in zip(configs, tags):
    if c.get("default"):
        cfg = EngineConfig(hidden=hidden, num_layers=layers, interpret=True)
    else:
        cfg = EngineConfig(
            execution=c["execution"], protocol=c["protocol"],
            partitioner=c["partitioner"], model=c["model"], hidden=hidden,
            num_layers=layers, exchange_chunks=c["chunks"],
            p2p_buckets=c["buckets"], partition_family=c["family"],
            vertex_cut=c.get("vcut", "cartesian2d"),
            hub_threshold=c.get("threshold"),
            sorted_masters=c.get("sorted_masters", False), interpret=True)
    eng = DistGNNEngine(g, mesh=mesh, cfg=cfg)
    out[f"{{tag}}/config"] = np.array(json.dumps([
        cfg.execution, cfg.partitioner, cfg.model, cfg.exchange_chunks,
        cfg.p2p_buckets]))
    if cfg.execution == "p2p" and c["family"] == "edge_cut":
        out[f"{{tag}}/installments"] = np.array(len(eng.playout.p2p_widths))
    elif cfg.execution == "p2p" and eng.playout._vc_plan:
        out[f"{{tag}}/installments"] = np.array([
            eng.playout._vc_plan[key].shape[1] for key in ("send1", "send2")])
    state = eng.init_state()
    init = state["params"]
    step = eng.make_step()
    losses, pushed = [], []
    for _ in range(steps):
        state, metrics, logits = step(state)
        losses.append(float(metrics["loss"]))
        pushed.append(float(metrics["rows_pushed"]))
    train_losses, _ = eng.train(steps)
    assert train_losses == losses, (train_losses, losses)
    if cfg.protocol != "sync":
        out[f"{{tag}}/pushed"] = np.array(pushed)
        out[f"{{tag}}/age"] = np.asarray(state["age"])
        for l, h in enumerate(state["hist"]):
            out[f"{{tag}}/hist/{{l}}"] = np.asarray(h)
    emb = eng.global_embeddings(eng.infer_full_graph(params=init))
    out[f"{{tag}}/losses"] = np.array(losses)
    out[f"{{tag}}/logits"] = np.asarray(logits)
    out[f"{{tag}}/sweep"] = emb
    for name, tree in (("init", init), ("final", state["params"])):
        for l, p in enumerate(tree["layers"]):
            for key, a in p.items():
                out[f"{{tag}}/{{name}}/{{l}}/{{key}}"] = np.asarray(a)
    out[f"{{tag}}/comm"] = np.array(json.dumps(
        dataclasses.asdict(eng.comm_stats)))
    out[f"{{tag}}/nb"] = np.array(eng.nb)
np.savez(out_path, **out)
print("JAX DONE", len(configs))
"""

# one rank of the port: every configuration through the training
# launcher's group path, from the reference's initial weights
_RANK_CODE = """
import dataclasses, json, os, sys, traceback
try:
    import numpy as np
    import torch
    from repro_torch.core.engine import DistGNNEngine, EngineConfig
    from repro_torch.core.execution import collectives
    from repro_torch.core.graph import er_graph
    from repro_torch.core.models.gnn import PARAM_KEYS, params_from_numpy
    from repro_torch.core.partition.edge_cut import hash_partition
    from repro_torch.launch import train_gnn
    from repro_torch.launch.common import join_group, leave_group

    (configs, tags, graph, rank, world, init_method, params_path, out_path,
     steps, hidden, layers) = json.loads(sys.argv[1])
    g = er_graph(**graph)
    given = np.load(params_path)
    out = {}

    # broadcast and the ring through the launcher; p2p from an
    # EngineConfig (the launchers have no buckets option), the default one
    # for the first
    def build(c, args):
        if c["execution"] != "p2p":
            return train_gnn.build_engine(args, g)
        if c.get("default"):
            cfg = EngineConfig(hidden=hidden, num_layers=layers)
        else:
            cfg = EngineConfig(
                execution="p2p", protocol=c["protocol"],
                partitioner=c["partitioner"], model=c["model"],
                exchange_chunks=c["chunks"], p2p_buckets=c["buckets"],
                hidden=hidden, num_layers=layers,
                partition_family=c["family"],
                vertex_cut=c.get("vcut", "cartesian2d"),
                hub_threshold=c.get("threshold"),
                sorted_masters=c.get("sorted_masters", False))
        return DistGNNEngine(g, cfg, device="cpu")

    # a protocol run's per-step rows pushed, its ages [L, k] and each
    # layer's history [Vp, d]; ``gather`` (the engine's `gather_rows`)
    # assembles them from every rank's rows
    def history(res, prefix, state, pushed, gather=None):
        res[f"{prefix}pushed"] = np.array(pushed)
        age = state["age"]
        if gather is not None:
            age = gather(age[None].float()).t().to(torch.int32)
        res[f"{prefix}age"] = age.numpy()
        for l, h in enumerate(state["hist"]):
            res[f"{prefix}hist/{l}"] = (h if gather is None
                                        else gather(h)).numpy()

    def run(c, args, tag, model):
        eng = build(c, args)
        L = len(eng.dims) - 1
        params = params_from_numpy({"layers": [
            {key: given[f"{tag}/init/{l}/{key}"] for key in PARAM_KEYS[model]}
            for l in range(L)]}, eng.device)
        collectives.zero_calls()
        step, state = eng.make_step(), eng.init_state(params=params)
        eng.comm_stats.reset()
        losses, pushed = [], []
        for _ in range(steps):
            state, metrics, logits = step(state)
            losses.append(float(metrics["loss"]))
            pushed.append(float(metrics["rows_pushed"]))
            eng.account_step()
        calls_steps = collectives.read_calls()
        logits = eng.gather_rows(logits)
        collectives.zero_calls()
        sweep = eng.infer_full_graph(params=params)
        calls_sweep = collectives.read_calls()
        collectives.zero_calls()
        ref_step, ref_state = eng.make_reference_step(), eng.init_state(
            params=params, reference=True)
        ref_losses, ref_pushed = [], []
        for _ in range(steps):
            ref_state, ref_metrics, ref_logits = ref_step(ref_state)
            ref_losses.append(float(ref_metrics["loss"]))
            ref_pushed.append(float(ref_metrics["rows_pushed"]))
        ref_sweep = eng.infer_full_graph(params=params, reference=True)
        calls_ref = collectives.read_calls()
        res = dict(losses=np.array(losses), logits=logits.numpy(),
                   sweep=eng.global_embeddings(sweep),
                   ref_losses=np.array(ref_losses),
                   ref_logits=ref_logits.numpy(),
                   ref_sweep=eng.global_embeddings(ref_sweep),
                   calls=np.array(json.dumps(dict(
                       steps=calls_steps, sweep=calls_sweep, ref=calls_ref))),
                   comm=np.array(json.dumps(dataclasses.asdict(
                       eng.comm_stats))),
                   shape=np.array([eng.k, eng.rank, eng.nb, eng.Vp]),
                   config=np.array(json.dumps([
                       eng.cfg.execution, eng.cfg.partitioner, eng.cfg.model,
                       eng.cfg.exchange_chunks, eng.cfg.p2p_buckets])))
        lay = eng.playout
        if c["family"] == "edge_cut":
            if eng.cfg.execution == "p2p":
                res["installments"] = np.array(len(lay.p2p_widths))
        else:
            # what the collective counts depend on: the flags, p2p's two
            # sync installments and the halo's
            plan = lay._vc_plan
            res["replica"] = np.array(json.dumps(dict(
                sync=bool(lay.sync_active), halo=bool(lay.halo_active),
                B1=plan["send1"].shape[1] if "send1" in plan else 0,
                B2=plan["send2"].shape[1] if "send2" in plan else 0,
                Bh=len(lay.halo_widths) if getattr(lay, "halo_active", False)
                and eng.cfg.execution == "p2p" else 0)))
            if "send1" in plan:
                res["installments"] = np.array(
                    [plan[key].shape[1] for key in ("send1", "send2")])
        if eng.cfg.protocol != "sync":
            history(res, "", state, pushed, eng.gather_rows)
            history(res, "ref_", ref_state, ref_pushed)
        for name, tree in (("final", state["params"]),
                           ("ref_final", ref_state["params"])):
            for l, p in enumerate(tree["layers"]):
                for key, a in p.items():
                    res[f"{name}/{l}/{key}"] = a.numpy()
        return res

    joined = False
    for c, tag in zip(configs, tags):
        family = ["--partition-family", c["family"]]
        if "vcut" in c:
            family += ["--vertex-cut", c["vcut"]]
        if c.get("threshold") is not None:
            family += ["--hub-threshold", str(c["threshold"])]
        args = train_gnn.parse_args([
            "--device", "cpu", "--world-size", str(world), "--rank",
            str(rank), "--init-method", init_method, "--exec",
            c["execution"], "--protocol", c["protocol"],
            "--partitioner", c["partitioner"], "--model",
            c["model"], "--exchange-chunks", str(c["chunks"]), "--hidden",
            str(hidden), "--layers", str(layers), *family])
        if not joined:
            join_group(args)
            joined = True
        for run_i in (0, 1):  # a second engine and run: bitwise equal
            for name, a in run(c, args, tag, c["model"]).items():
                out[f"{tag}/{run_i}/{name}"] = a
    try:
        DistGNNEngine(g, EngineConfig(execution="broadcast",
                                      partitioner="hash"),
                      hash_partition(g, 2), device="cpu")
        out["mismatch"] = np.array("no error")
    except ValueError as e:
        out["mismatch"] = np.array(str(e))
    np.savez(out_path, **out)
    leave_group(args)
except BaseException:
    traceback.print_exc()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(1)
"""


def _rank_env():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    return env


def _run_ranks(argvs, timeout=RANK_TIMEOUT):
    """Start one process per argv together; wait for all (each within
    ``timeout``); kill the rest when one fails or runs out of time."""
    procs = [subprocess.Popen(argv, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env=_rank_env()) for argv in argvs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
            if p.returncode != 0:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} rc={rc}\n{out[-3000:]}\n{err[-6000:]}"
    assert len(outs) == len(argvs)
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX on 4 host devices and the port on 4 gloo ranks, run together;
    the port's ranks start from the reference's initial weights, drawn
    here with the reference's own `init_gnn_params` (the JAX run writes
    its `init_state()` weights too, and they must be the same)."""
    import jax

    from repro.core.graph import er_graph as jer_graph
    from repro.core.models.gnn import init_gnn_params as jinit_gnn_params

    tmp = tmp_path_factory.mktemp("torch_distributed")
    jg = jer_graph(**GRAPH)
    dims = ([GRAPH["feature_dim"]] + [HIDDEN] * (LAYERS - 1)
            + [int(jg.labels.max()) + 1])
    init = {}
    for c, tag in zip(CONFIGS, TAGS):
        tree = jinit_gnn_params(c["model"], dims, jax.random.PRNGKey(0))
        for l, p in enumerate(tree["layers"]):
            for key, a in p.items():
                init[f"{tag}/init/{l}/{key}"] = np.asarray(a)
    params_path = str(tmp / "init.npz")
    np.savez(params_path, **init)

    jax_path = str(tmp / "jax.npz")
    code = _JAX_CODE.format(args=json.dumps([CONFIGS, TAGS, GRAPH, jax_path]),
                            steps=STEPS, hidden=HIDDEN, layers=LAYERS)
    jax_error = []

    def jax_side():
        try:
            run_with_devices(code, n_devices=WORLD, timeout=RANK_TIMEOUT)
        except BaseException as e:  # re-raised below, in the test's thread
            jax_error.append(e)

    jax_thread = threading.Thread(target=jax_side)
    jax_thread.start()
    init_method = f"file://{tmp / 'rendezvous'}"
    rank_paths = [str(tmp / f"rank{r}.npz") for r in range(WORLD)]
    try:
        _run_ranks([[sys.executable, "-c", _RANK_CODE, json.dumps([
            CONFIGS, TAGS, GRAPH, r, WORLD, init_method, params_path,
            rank_paths[r], STEPS, HIDDEN, LAYERS])] for r in range(WORLD)])
    finally:
        jax_thread.join()
    if jax_error:
        raise jax_error[0]
    return dict(init=init, jax=dict(np.load(jax_path)),
                ranks=[dict(np.load(p)) for p in rank_paths])


def _close(ours, theirs, what):
    np.testing.assert_allclose(ours, theirs, atol=ORACLE_TOL, rtol=0,
                               err_msg=what)


def _params(res, prefix, model):
    return {f"{l}/{key}": res[f"{prefix}/{l}/{key}"]
            for l in range(LAYERS) for key in PARAM_KEYS[model]}


@pytest.mark.parametrize("i", range(len(CONFIGS)), ids=TAGS)
def test_four_ranks_match_jax_step_and_sweep(runs, i):
    c, tag = CONFIGS[i], TAGS[i]
    jx = {key[len(tag) + 1:]: a for key, a in runs["jax"].items()
          if key.startswith(tag + "/")}
    # the JAX run's init_state() weights are the ones the ranks started from
    for key, a in runs["init"].items():
        if key.startswith(tag + "/"):
            assert np.array_equal(jx[key[len(tag) + 1:]], a), key
    for rank, res in enumerate(runs["ranks"]):
        ours = f"{tag}/0"
        assert res[f"{ours}/shape"].tolist()[:3] == [WORLD, rank, int(jx["nb"])]
        _close(res[f"{ours}/losses"], jx["losses"], f"{tag} losses")
        _close(res[f"{ours}/logits"], jx["logits"], f"{tag} logits")
        for key, a in _params(res, f"{ours}/final", c["model"]).items():
            _close(a, jx[f"final/{key}"], f"{tag} param {key}")
            assert not np.array_equal(a, jx[f"init/{key}"]) or key.endswith(
                "/b"), f"{tag} {key} did not train"
        _close(res[f"{ours}/sweep"], jx["sweep"], f"{tag} sweep")
        if c["protocol"] != "sync":
            _same_history(res, f"{ours}/", jx, "", tag)
    assert np.isfinite(runs["ranks"][0][f"{tag}/0/sweep"]).all()
    if c["protocol"] == "sync":
        assert not any(key.startswith("hist/") for key in jx)
    else:  # some layer pushed boundary rows in some step
        assert jx["pushed"].max() > 0


def _same_history(res, prefix, theirs, their_prefix, tag):
    """Each layer's history within 1e-4; the ages and each step's rows
    pushed exactly equal."""
    L = LAYERS
    for l in range(L):
        _close(res[f"{prefix}hist/{l}"], theirs[f"{their_prefix}hist/{l}"],
               f"{tag} history {l}")
    assert np.array_equal(res[f"{prefix}age"], theirs[f"{their_prefix}age"]), tag
    assert np.array_equal(res[f"{prefix}pushed"],
                          theirs[f"{their_prefix}pushed"]), tag


@pytest.mark.parametrize("i", range(len(CONFIGS)), ids=TAGS)
def test_four_ranks_match_the_port_reference(runs, i):
    """Each rank's reference step and sweep run the whole graph on one
    device with no collective: the distributed run is held to them.  Sync
    runs must also learn in three steps.  The protocol runs are held to
    JAX and to the reference step by step instead: JAX's own losses do not
    fall in three steps there (broadcast gcn epoch_fixed 2.519, 2.431,
    7.252: the stale step delays sync's first overshoot, 2.519, 7.245,
    1.789; p2p gat epoch_adaptive 1.644, 1.675, 1.679 at every lr from
    0.05 to 2: half the parts read the all-zero history at step 0)."""
    c, tag = CONFIGS[i], TAGS[i]
    for res in runs["ranks"]:
        run = f"{tag}/0"
        _close(res[f"{run}/losses"], res[f"{run}/ref_losses"], f"{tag} loss")
        _close(res[f"{run}/logits"], res[f"{run}/ref_logits"], f"{tag} logits")
        ref = _params(res, f"{run}/ref_final", c["model"])
        for key, a in _params(res, f"{run}/final", c["model"]).items():
            _close(a, ref[key], f"{tag} param {key}")
        _close(res[f"{run}/sweep"], res[f"{run}/ref_sweep"], f"{tag} sweep")
        if c["protocol"] != "sync":
            _same_history(res, f"{run}/", res, f"{run}/ref_", tag)
        else:
            assert res[f"{run}/losses"][-1] < res[f"{run}/losses"][0]


@pytest.mark.parametrize("i", range(len(CONFIGS)), ids=TAGS)
def test_ranks_agree_and_a_second_run_is_bitwise_equal(runs, i):
    tag = TAGS[i]
    first = runs["ranks"][0]
    names = [key[len(tag) + 3:] for key in first
             if key.startswith(f"{tag}/0/") and not key.endswith("/shape")]
    assert len(names) > 10
    for res in runs["ranks"]:
        for name in names:
            for run in (0, 1):
                assert np.array_equal(res[f"{tag}/{run}/{name}"],
                                      first[f"{tag}/0/{name}"]), (name, run)


@pytest.mark.parametrize("i", range(len(CONFIGS)), ids=TAGS)
def test_comm_stats_and_collective_counts(runs, i):
    """CommStats equal JAX's (halo bytes of the steps, inference bytes of
    one sweep) on every rank.  broadcast: a step calls an all_gather per
    layer and chunk, a reduce-scatter per layer and chunk whose table needs
    a gradient (not layer 0's constant features, but gat's Hw) and one flat
    all_reduce; a sweep an all_gather per layer and chunk, then one for the
    output rows.  p2p: an all_to_all per layer, chunk and installment, and
    its reverse all_to_all wherever broadcast reduce-scatters; a sweep's
    output rows still come by one all_gather.  ring: k - 1 rotations a
    layer (no chunks), and k - 1 reverse rotations wherever broadcast
    reduce-scatters.  A protocol changes none of these.  The references
    call none."""
    c, tag = CONFIGS[i], TAGS[i]
    jcomm = json.loads(str(runs["jax"][f"{tag}/comm"]))
    C = c["chunks"]
    grad_layers = LAYERS if c["model"] == "gat" else LAYERS - 1
    none = dict(all_gather=0, reduce_scatter=0, all_to_all=0, ppermute=0,
                all_reduce=0)
    for res in runs["ranks"]:
        comm = json.loads(str(res[f"{tag}/0/comm"]))
        assert comm == jcomm and comm["inference_bytes"] > 0
        assert comm["halo_bytes"] > 0 or c["family"] != "edge_cut"
        calls = json.loads(str(res[f"{tag}/0/calls"]))
        if c["family"] != "edge_cut":
            info = json.loads(str(res[f"{tag}/0/replica"]))
            _replica_bytes(c, info, comm, res, runs["jax"], tag)
            steps, sweep = _replica_calls(c, info)
        elif c["execution"] == "broadcast":
            steps = dict(all_gather=LAYERS * C * STEPS,
                         reduce_scatter=grad_layers * C * STEPS)
            sweep = dict(all_gather=LAYERS * C + 1)
        elif c["execution"] == "ring":
            steps = dict(ppermute=(LAYERS + grad_layers) * (WORLD - 1) * STEPS)
            sweep = dict(ppermute=LAYERS * (WORLD - 1), all_gather=1)
        else:
            B = int(res[f"{tag}/0/installments"])
            assert B == int(runs["jax"][f"{tag}/installments"])
            assert (B > 1) == (c["buckets"] > 1)
            steps = dict(all_to_all=(LAYERS + grad_layers) * C * B * STEPS)
            sweep = dict(all_to_all=LAYERS * C * B, all_gather=1)
        assert calls["steps"] == {**none, **steps, "all_reduce": STEPS}
        assert calls["sweep"] == {**none, **sweep}
        assert calls["ref"] == none


def _replica_bytes(c, info, comm, res, jx, tag):
    """A replica configuration's wire fields: vertex_cut accrues replica
    sync bytes only; hybrid halo bytes where it has a halo and replica
    sync bytes where it has replicas (threshold inf: no replica, its halo
    the edge-cut p2p halo, the partition's communication volume, as
    `edge_cut_halo_bytes_per_step`; threshold 0: no halo).  p2p's
    installments are JAX's."""
    from repro_torch.core.graph import er_graph
    from repro_torch.core.partition import cost_models
    from repro_torch.core.partition.edge_cut import PARTITIONERS

    if c["family"] == "vertex_cut":
        assert info["sync"] and not info["halo"]
        assert comm["replica_sync_bytes"] > 0 and comm["halo_bytes"] == 0
    else:
        assert (comm["halo_bytes"] > 0) == info["halo"]
        assert (comm["replica_sync_bytes"] > 0) == info["sync"]
        if c["threshold"] == float("inf"):
            assert info["halo"] and not info["sync"]
            g = er_graph(**GRAPH)
            part = PARTITIONERS[c["partitioner"]](g, WORLD)
            dims = [GRAPH["feature_dim"]] + [HIDDEN] * (LAYERS - 1) + [
                GRAPH["num_classes"]]
            assert comm["halo_bytes"] == STEPS * (
                cost_models.edge_cut_halo_bytes_per_step(
                    g, part, dims, model=c["model"]))
        elif c["threshold"] == 0.0:
            assert info["sync"] and not info["halo"]
        else:
            assert info["sync"] and info["halo"]
    if info["B1"]:
        assert np.array_equal(res[f"{tag}/0/installments"],
                              jx[f"{tag}/installments"])
        assert (max(info["B1"], info["B2"]) > 1) == (c["buckets"] > 1)


def _replica_calls(c, info):
    """Collective calls of the STEPS training steps and of one sweep of a
    replica configuration.  A layer runs the halo exchange (hybrid, where
    there is one) and the replica combine (where there are replicas):
    broadcast an all_gather per chunk each, the ring k - 1 rotations each
    (the halo's per chunk, the combine's unchunked), p2p per chunk an
    all_to_all per installment (the halo's Bh, the combine's B1 + B2 over
    its two phases).  gat exchanges Hw's halo unchunked and adds a max
    combine (unchunked: broadcast one all_gather, the ring k - 1
    rotations, p2p B1 + B2 all_to_alls) with no backward.  The backward
    runs each exchange's reverse wherever its table needs a gradient (not
    layer 0's constant features, but gat's Hw): a reduce-scatter, a
    reverse rotation or a reverse all_to_all.  Then one all_reduce a step;
    the sweep adds one all_gather of its output rows."""
    C, k, L, ex = c["chunks"], WORLD, LAYERS, c["execution"]
    gat = c["model"] == "gat"
    key = dict(broadcast="all_gather", ring="ppermute", p2p="all_to_all")[ex]
    back = dict(broadcast="reduce_scatter", ring="ppermute",
                p2p="all_to_all")[ex]
    per_halo = dict(broadcast=1, ring=k - 1, p2p=info["Bh"])[ex]
    per_sync = dict(broadcast=1, ring=k - 1, p2p=info["B1"] + info["B2"])[ex]
    halo_n = per_halo * (1 if gat else C) if info["halo"] else 0
    sync_n = per_sync * (1 if ex == "ring" else C) if info["sync"] else 0
    max_n = per_sync if info["sync"] and gat else 0
    fwd = L * (halo_n + sync_n + max_n)
    bwd = (L if gat else L - 1) * (halo_n + sync_n)
    steps = {key: fwd * STEPS}
    steps[back] = steps.get(back, 0) + bwd * STEPS
    steps["all_reduce"] = STEPS
    sweep = {key: fwd}
    sweep["all_gather"] = sweep.get("all_gather", 0) + 1
    return steps, sweep


def test_default_config_is_p2p_metis_like(runs):
    """`EngineConfig()` is the same engine in both packages: p2p over the
    metis_like partition with one bucket (the default-config run's own
    config, read back on every rank and from JAX)."""
    tag = TAGS[CONFIGS.index(next(c for c in CONFIGS if c.get("default")))]
    want = ["p2p", "metis_like", "gcn", 1, 1]
    assert json.loads(str(runs["jax"][f"{tag}/config"])) == want
    for res in runs["ranks"]:
        assert json.loads(str(res[f"{tag}/0/config"])) == want


def test_partition_part_count_must_equal_the_rank_count(runs):
    for res in runs["ranks"]:
        assert str(res["mismatch"]) == (
            "the partition has 2 parts and the process group 4 rank(s): "
            "they must be equal")


def test_entry_points_on_four_gloo_ranks(tmp_path):
    """`train_gnn.main` and `serve_gnn.main` as four rank processes with a
    file:// rendezvous: the oracle checks pass on every rank, and every rank
    reports the same losses and embeddings."""
    code = textwrap.dedent("""
        import json, os, sys, traceback
        try:
            import numpy as np
            from repro_torch.launch import serve_gnn, train_gnn
            rank, tmp = int(sys.argv[1]), sys.argv[2]
            common = ["--device", "cpu", "--world-size", "4", "--rank",
                      str(rank), "--vertices", "90", "--layers", "3",
                      "--hidden", "16", "--exchange-chunks", "2"]
            out = train_gnn.main(common + [
                "--init-method", f"file://{tmp}/train", "--model", "sage",
                "--partitioner", "range", "--epochs", "4", "--lr", "0.3",
                "--oracle-check", "--infer"])
            emb, _ = serve_gnn.main(common + [
                "--init-method", f"file://{tmp}/serve", "--model", "gat",
                "--oracle-check"])
            np.savez(f"{tmp}/main{rank}.npz", losses=out["losses"],
                     gaps=[out["oracle_gap"], out["infer_gap"]], emb=emb)
        except BaseException:
            traceback.print_exc()
            sys.stderr.flush()
            os._exit(1)
    """)
    _run_ranks([[sys.executable, "-c", code, str(r), str(tmp_path)]
                for r in range(WORLD)])
    res = [np.load(tmp_path / f"main{r}.npz") for r in range(WORLD)]
    assert res[0]["emb"].shape == (90, 8) and np.isfinite(res[0]["emb"]).all()
    assert (res[0]["gaps"] <= ORACLE_TOL).all()
    assert res[0]["losses"][-1] < res[0]["losses"][0]
    for r in res[1:]:
        for key in ("losses", "gaps", "emb"):
            assert np.array_equal(r[key], res[0][key]), key

