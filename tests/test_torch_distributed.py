"""The port's multi-rank broadcast: `repro_torch`'s synchronous full-graph
step and layer-wise sweep on four gloo ranks (four CPU processes, one
`torch.distributed` group, joined through the launchers' group path)
against the JAX engine on four forced host devices (Auto-axis mesh, Pallas
interpret), for gcn, sage, gin and gat at exchange_chunks 1 and 2 under the
hash and range partitioners, on a graph with isolated vertices and unequal
parts.  From the reference's own initial weights: the per-step loss, the
final logits and params, and the sweep within 1e-4 of JAX's and of the
port's own reference step; every rank reporting the same numbers; a second
run bitwise equal; CommStats equal to JAX's; the collectives counted
exactly; a partition whose part count is not the rank count refused; and
the two entry points on four ranks.

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
CONFIGS = [dict(model=model, chunks=chunks,
                partitioner=("hash", "range")[chunks - 1])
           for model in ("gcn", "sage", "gin", "gat") for chunks in (1, 2)]
TAGS = [f"{c['model']}-{c['chunks']}-{c['partitioner']}" for c in CONFIGS]

# the reference: every configuration on one 4-device Auto-axis mesh
_JAX_CODE = """
import dataclasses, json
import jax, numpy as np
from jax.sharding import AxisType
from repro.core.engine import DistGNNEngine, EngineConfig
from repro.core.graph import er_graph
configs, graph, out_path = json.loads({args!r})
steps, hidden, layers = {steps}, {hidden}, {layers}
g = er_graph(**graph)
mesh = jax.make_mesh((4,), ("w",), axis_types=(AxisType.Auto,))
out = {{}}
for c in configs:
    tag = f"{{c['model']}}-{{c['chunks']}}-{{c['partitioner']}}"
    eng = DistGNNEngine(g, mesh=mesh, cfg=EngineConfig(
        execution="broadcast", protocol="sync", partitioner=c["partitioner"],
        model=c["model"], hidden=hidden, num_layers=layers,
        exchange_chunks=c["chunks"], interpret=True))
    state = eng.init_state()
    init = state["params"]
    step = eng.make_step()
    losses = []
    for _ in range(steps):
        state, metrics, logits = step(state)
        losses.append(float(metrics["loss"]))
    train_losses, _ = eng.train(steps)
    assert train_losses == losses, (train_losses, losses)
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

    (configs, graph, rank, world, init_method, params_path, out_path, steps,
     hidden, layers) = json.loads(sys.argv[1])
    g = er_graph(**graph)
    given = np.load(params_path)
    out = {}

    def run(args, tag, model):
        eng = train_gnn.build_engine(args, g)
        L = len(eng.dims) - 1
        params = params_from_numpy({"layers": [
            {key: given[f"{tag}/init/{l}/{key}"] for key in PARAM_KEYS[model]}
            for l in range(L)]}, eng.device)
        collectives.zero_calls()
        step, state = eng.make_step(), eng.init_state(params=params)
        eng.comm_stats.reset()
        losses = []
        for _ in range(steps):
            state, metrics, logits = step(state)
            losses.append(float(metrics["loss"]))
            eng.account_step()
        calls_steps = collectives.read_calls()
        logits = eng.gather_rows(logits)
        collectives.zero_calls()
        sweep = eng.infer_full_graph(params=params)
        calls_sweep = collectives.read_calls()
        collectives.zero_calls()
        ref_step, ref_state = eng.make_reference_step(), eng.init_state(
            params=params)
        ref_losses = []
        for _ in range(steps):
            ref_state, ref_metrics, ref_logits = ref_step(ref_state)
            ref_losses.append(float(ref_metrics["loss"]))
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
                   shape=np.array([eng.k, eng.rank, eng.nb, eng.Vp]))
        for name, tree in (("final", state["params"]),
                           ("ref_final", ref_state["params"])):
            for l, p in enumerate(tree["layers"]):
                for key, a in p.items():
                    res[f"{name}/{l}/{key}"] = a.numpy()
        return res

    joined = False
    for c in configs:
        tag = f"{c['model']}-{c['chunks']}-{c['partitioner']}"
        args = train_gnn.parse_args([
            "--device", "cpu", "--world-size", str(world), "--rank",
            str(rank), "--init-method", init_method, "--partitioner",
            c["partitioner"], "--model", c["model"], "--exchange-chunks",
            str(c["chunks"]), "--hidden", str(hidden), "--layers",
            str(layers)])
        if not joined:
            join_group(args)
            joined = True
        for run_i in (0, 1):  # a second engine and run: bitwise equal
            for name, a in run(args, tag, c["model"]).items():
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
    code = _JAX_CODE.format(args=json.dumps([CONFIGS, GRAPH, jax_path]),
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
            CONFIGS, GRAPH, r, WORLD, init_method, params_path,
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
    assert np.isfinite(runs["ranks"][0][f"{tag}/0/sweep"]).all()


@pytest.mark.parametrize("i", range(len(CONFIGS)), ids=TAGS)
def test_four_ranks_match_the_port_reference(runs, i):
    """Each rank's reference step and sweep run the whole graph on one
    device with no collective: the distributed run is held to them."""
    c, tag = CONFIGS[i], TAGS[i]
    for res in runs["ranks"]:
        run = f"{tag}/0"
        _close(res[f"{run}/losses"], res[f"{run}/ref_losses"], f"{tag} loss")
        _close(res[f"{run}/logits"], res[f"{run}/ref_logits"], f"{tag} logits")
        ref = _params(res, f"{run}/ref_final", c["model"])
        for key, a in _params(res, f"{run}/final", c["model"]).items():
            _close(a, ref[key], f"{tag} param {key}")
        _close(res[f"{run}/sweep"], res[f"{run}/ref_sweep"], f"{tag} sweep")
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
    one sweep) on every rank.  A step calls an all_gather per layer and
    chunk, a reduce-scatter per layer and chunk whose table needs a
    gradient (not layer 0's constant features, but gat's Hw) and one flat
    all_reduce; a sweep an all_gather per layer and chunk, then one for the
    output rows; the references none."""
    c, tag = CONFIGS[i], TAGS[i]
    jcomm = json.loads(str(runs["jax"][f"{tag}/comm"]))
    C = c["chunks"]
    grad_layers = LAYERS if c["model"] == "gat" else LAYERS - 1
    for res in runs["ranks"]:
        comm = json.loads(str(res[f"{tag}/0/comm"]))
        assert comm == jcomm and comm["halo_bytes"] > 0
        assert comm["inference_bytes"] > 0
        calls = json.loads(str(res[f"{tag}/0/calls"]))
        assert calls["steps"] == dict(all_gather=LAYERS * C * STEPS,
                                      reduce_scatter=grad_layers * C * STEPS,
                                      all_reduce=STEPS)
        assert calls["sweep"] == dict(all_gather=LAYERS * C + 1,
                                      reduce_scatter=0, all_reduce=0)
        assert calls["ref"] == dict(all_gather=0, reduce_scatter=0,
                                    all_reduce=0)


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

