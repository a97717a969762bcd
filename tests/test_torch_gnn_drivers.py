"""The port's GNN drivers held to the reference's on the CPU.

- `launch/dryrun_gnn.py --bench-partition-families`: the port's
  BENCH_partition_families.json equal, entry for entry and number for
  number, to the one `python -m repro.launch.dryrun_gnn
  --bench-partition-families` writes (run in a subprocess: the reference
  module forces 512 host devices at import).
- `launch/train_gnn.py`: the reference driver's rules between the engine
  and the legacy path, ``--partition`` as a second name of
  ``--partitioner``, ``--parts`` against the group; ``--no-engine`` at one
  rank, each legacy execution model, against the reference's own
  `run_legacy` (its jitted step watched for the losses and its first
  weights, which the port's run starts from).
- `examples/train_gnn_distributed.py` (torchrun-style) on four gloo ranks,
  from the reference's initial weights: the engine path with
  ``--trainable-features --embed-lr 0.01 --p2p-buckets 2`` against the JAX
  engine at the same `EngineConfig` on an Auto-axis mesh of four host
  devices (losses within 1e-4, CommStats equal) and against its own
  single-device oracle; the legacy path (spmm_1d, spmm_2d on a 2 x 2 grid)
  against the reference's `run_legacy` on four host devices (losses and
  final weights within 1e-4) and against the same run on one rank.
- `examples/staleness_ablation.py`: every row's bytes pushed equal to the
  reference's `full_graph_train` from the same weights, the losses within
  1e-4.

    PYTHONPATH=src python -m pytest -q tests/test_torch_gnn_drivers.py
"""
import argparse
import importlib.util
import json
import os
import socket
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from conftest import REPO, SRC, run_with_devices
from repro.core.graph import sbm_graph as jsbm_graph
from repro.core.models.gnn import init_gnn_params as jinit_gnn_params
from repro_torch.core import training
from repro_torch.core.graph import sbm_graph
from repro_torch.core.models.gnn import params_from_numpy
from repro_torch.launch import dryrun_gnn, train_gnn

ORACLE_TOL = 1e-4
CPU = torch.device("cpu")
WORLD = 4
RANK_TIMEOUT = 240  # seconds, for each rank process
VERTICES, EPOCHS = 256, 4  # the four-rank runs' graph and steps


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small tensors: more only
    contend with the other test workers' processes on a shared host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# dryrun_gnn: the partition families' bytes
# ---------------------------------------------------------------------------


def test_partition_families_bench_matches_reference(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.dryrun_gnn",
         "--bench-partition-families", "--out", str(tmp_path / "ref")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    try:  # the port's bench beside the reference's
        path = dryrun_gnn.main(["--bench-partition-families", "--out",
                                str(tmp_path / "port")])
        _, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-4000:]
    assert path == str(tmp_path / "port" / "BENCH_partition_families.json")
    assert os.listdir(tmp_path / "port") == ["BENCH_partition_families.json"]
    with open(path) as f:
        ours = json.load(f)
    with open(tmp_path / "ref" / "BENCH_partition_families.json") as f:
        theirs = json.load(f)
    assert len(ours["configs"]) == len(theirs["configs"]) == 7
    for a, b in zip(ours["configs"], theirs["configs"]):
        assert a == b, (a["graph"], a["chips"], a["vertices"])
    assert ours == theirs
    with pytest.raises(SystemExit):  # the compile half is not ported
        dryrun_gnn.main(["--out", str(tmp_path / "none")])


# ---------------------------------------------------------------------------
# train_gnn: the flags and the legacy path
# ---------------------------------------------------------------------------


def test_driver_rules_and_names():
    a = train_gnn.parse_args([])
    assert (a.engine, a.exec, a.device, a.parts, a.p2p_buckets,
            a.trainable_features, a.embed_lr, a.partitioner) == (
        True, "p2p", "cuda", 0, 1, False, 0.1, "metis_like")
    assert not train_gnn.parse_args(["--no-engine"]).engine
    assert train_gnn.parse_args(["--no-engine"]).exec == "spmm_1d"
    legacy = train_gnn.parse_args(["--exec", "spmm_2d"])  # a legacy name
    assert not legacy.engine and legacy.exec == "spmm_2d"
    assert train_gnn.parse_args(["--partition", "hash"]).partitioner == "hash"
    for bad in (["--exec", "nope"], ["--no-engine", "--exec", "p2p"],
                ["--no-engine", "--batching", "node_wise"],
                ["--no-engine", "--trace-out", "t.json"],
                ["--no-engine", "--partition-family", "vertex_cut"],
                ["--partition-family", "hybrid", "--batching", "subgraph"]):
        with pytest.raises(SystemExit):
            train_gnn.parse_args(bad)
    for parts in ("2", "4"):  # one rank, no group: only 0 or 1
        with pytest.raises(ValueError, match="--parts"):
            train_gnn.main(["--device", "cpu", "--parts", parts, "--epochs", "1",
                            "--vertices", "64"])
    with pytest.raises(ValueError, match="--parts"):
        train_gnn.main(["--device", "cpu", "--no-engine", "--parts", "2",
                        "--epochs", "1", "--vertices", "64"])
    assert train_gnn.legacy_grid_shape("spmm_2d", 4) == (2, 2)
    assert train_gnn.legacy_grid_shape("spmm_15d", 8) == (2, 4)
    assert train_gnn.legacy_grid_shape("spmm_1d", 4) == (4,)


def _reference_driver():
    path = os.path.join(REPO, "examples", "train_gnn_distributed.py")
    spec = importlib.util.spec_from_file_location("ref_train_gnn_distributed",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("exec_name", ["spmm_1d", "spmm_1d_ring", "replicated",
                                       "spmm_2d", "spmm_15d"])
def test_no_engine_matches_run_legacy(monkeypatch, exec_name):
    """The reference's `run_legacy` itself at one device, its jitted step
    watched: the weights it starts from carried into the port's
    `run_legacy`, each epoch's loss within 1e-4, the final weights too.
    Its meshes are made Auto-axis (under jax 0.9 `jax.make_mesh` makes
    Explicit-axis ones, on which the reference's legacy products raise a
    ShardingTypeError), as every port tier builds the reference's mesh."""
    from jax.sharding import AxisType

    ref = _reference_driver()
    calls = []
    real_jit, real_make_mesh = jax.jit, jax.make_mesh

    def auto_mesh(shape, names, **kw):
        return real_make_mesh(shape, names,
                              axis_types=(AxisType.Auto,) * len(shape))

    def watched_jit(fn, *a, **kw):
        jitted = real_jit(fn, *a, **kw)

        class Watched:
            def lower(self, *args):
                return jitted.lower(*args)

            def __call__(self, params):
                out = jitted(params)
                calls.append((params, out))
                return out

        return Watched()

    monkeypatch.setattr(ref.jax, "jit", watched_jit)
    monkeypatch.setattr(ref.jax, "make_mesh", auto_mesh)
    epochs = 12
    args = argparse.Namespace(parts=0, partition="metis_like", exec=exec_name,
                              epochs=epochs)
    ref.run_legacy(args, ref.sbm_graph(128, num_blocks=8, p_in=0.05,
                                       p_out=0.003, seed=0))
    monkeypatch.undo()
    assert len(calls) == epochs
    theirs = [float(out[1]) for _, out in calls]
    params = params_from_numpy(jax.tree.map(np.asarray, calls[0][0]), CPU)
    targs = train_gnn.parse_args(["--device", "cpu", "--no-engine", "--exec",
                                  exec_name, "--epochs", str(epochs)])
    ours = train_gnn.run_legacy(targs, sbm_graph(128, num_blocks=8, p_in=0.05,
                                                 p_out=0.003, seed=0),
                                CPU, params=params)
    assert ours["grid"] == ((1, 1) if exec_name in ("spmm_2d", "spmm_15d")
                            else (1,))
    np.testing.assert_allclose(ours["losses"], theirs, atol=ORACLE_TOL, rtol=0)
    assert ours["losses"][-1] < ours["losses"][0]
    final = jax.tree.map(np.asarray, calls[-1][1][0])
    for p, q in zip(ours["params"]["layers"], final["layers"]):
        for key in p:
            np.testing.assert_allclose(p[key].numpy(), q[key], atol=ORACLE_TOL,
                                       rtol=0, err_msg=key)
    assert not torch.distributed.is_initialized()  # its group of one is left


def test_legacy_main_runs_alone():
    out = train_gnn.main(["--device", "cpu", "--no-engine", "--epochs", "3",
                          "--vertices", "64"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# the torchrun-style example on four gloo ranks
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_RANK_CODE = """
import json, os, sys
import numpy as np
from repro_torch.core import engine
from repro_torch.core.models.gnn import params_from_numpy
from repro_torch.launch import train_gnn
summary, path = sys.argv[1:3]
if path != "-":  # start from the reference's weights
    z = np.load(path)
    def carried(model, dims, generator, device):
        L = len(dims) - 1
        tree = {{"layers": [{{k.split("/")[1]: z[k] for k in z.files
                             if k.startswith(f"{{l}}/")}} for l in range(L)]}}
        return params_from_numpy(tree, device)
    engine.init_gnn_params = train_gnn.init_gnn_params = carried
from repro_torch.examples import train_gnn_distributed
out = train_gnn_distributed.main(sys.argv[3:])
if os.environ["RANK"] == "0":
    keep = {{k: out[k] for k in ("losses", "ref_losses", "oracle_gap", "comm",
                                "grid") if k in out}}
    if "params" in out:  # the legacy path's final weights
        keep["params"] = [{{k: t.tolist() for k, t in p.items()}}
                          for p in out["params"]["layers"]]
    with open(summary, "w") as f:
        json.dump(keep, f)
"""


def _torchrun(tmp, flags, params_path="-", world=WORLD):
    """The example on ``world`` gloo ranks, torchrun's environment set by
    hand (one free localhost port), each rank from the weights saved at
    ``params_path`` if one is given; rank 0's losses (the oracle's too),
    CommStats or grid and final weights, as its wrapper writes them."""
    port = _free_port()
    out = str(tmp / f"summary-{port}.json")
    argvs = [[sys.executable, "-c", _RANK_CODE.format(), out, params_path,
              "--device", "cpu", *flags]
             for _ in range(world)]
    env = dict(os.environ, PYTHONPATH=SRC, MASTER_ADDR="localhost",
               MASTER_PORT=str(port), WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    procs = []
    for rank, argv in enumerate(argvs):
        procs.append(subprocess.Popen(argv, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True,
                                      env=dict(env, RANK=str(rank))))
    outs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=RANK_TIMEOUT)
            outs.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (rc, so, se) in enumerate(outs):
        assert rc == 0, f"rank {rank} rc={rc}\n{so[-2000:]}\n{se[-6000:]}"
    with open(out) as f:
        return json.load(f)


def _beside_jax(code, run):
    """``run()`` (the gloo ranks) while ``code`` runs in a JAX subprocess on
    WORLD forced host devices; run's result and the subprocess's RESULT
    line, parsed."""
    jax_out, jax_error = [], []

    def jax_side():
        try:
            jax_out.append(run_with_devices(code, n_devices=WORLD,
                                            timeout=RANK_TIMEOUT))
        except BaseException as e:  # re-raised in the test's thread
            jax_error.append(e)

    thread = threading.Thread(target=jax_side)
    thread.start()
    try:
        ours = run()
    finally:
        thread.join()
    if jax_error:
        raise jax_error[0]
    line = [x for x in jax_out[0].splitlines() if x.startswith("RESULT ")][-1]
    return ours, json.loads(line[len("RESULT "):])


def _save_reference_init(tmp_path):
    """The reference drivers' initial gcn weights for the four-rank runs'
    graph (`init_gnn_params` at PRNGKey(0)), saved for the ranks."""
    g = jsbm_graph(VERTICES, num_blocks=8, p_in=0.05, p_out=0.003, seed=0)
    dims = [g.features.shape[1], 32, int(g.labels.max()) + 1]
    tree = jinit_gnn_params("gcn", dims, jax.random.PRNGKey(0))
    path = str(tmp_path / "init.npz")
    np.savez(path, **{f"{l}/{k}": np.asarray(a)
                      for l, p in enumerate(tree["layers"]) for k, a in p.items()})
    return path, tree


ENGINE_FLAGS = ["--exec", "p2p", "--trainable-features", "--embed-lr", "0.01",
                "--p2p-buckets", "2", "--vertices", str(VERTICES),
                "--epochs", str(EPOCHS)]

_JAX_CODE = """
import dataclasses, json
import jax
import numpy as np
from jax.sharding import AxisType
from repro.core.engine import DistGNNEngine, EngineConfig
from repro.core.graph import sbm_graph
g = sbm_graph({vertices}, num_blocks=8, p_in=0.05, p_out=0.003, seed=0)
mesh = jax.make_mesh(({world},), ("w",), axis_types=(AxisType.Auto,))
cfg = EngineConfig(execution="p2p", protocol="sync", model="gcn",
                   partitioner="metis_like", trainable_features=True,
                   embed_lr=0.01, p2p_buckets=2, interpret=True)
eng = DistGNNEngine(g, mesh=mesh, cfg=cfg)
losses, _ = eng.train({epochs})
print("RESULT", json.dumps(dict(losses=[float(x) for x in losses],
                                comm=dataclasses.asdict(eng.comm_stats))))
"""


def test_torchrun_engine_flags_match_the_jax_engine(tmp_path):
    """Four gloo ranks through the example with ``--trainable-features
    --embed-lr 0.01 --p2p-buckets 2`` (and ``--oracle-check``: the port's
    single-device reference run within 1e-4 inside the driver), from the
    reference's initial weights, against the JAX engine at the same
    config on four host devices: losses within 1e-4, CommStats equal."""
    path, _ = _save_reference_init(tmp_path)
    ours, theirs = _beside_jax(
        _JAX_CODE.format(vertices=VERTICES, world=WORLD, epochs=EPOCHS),
        lambda: _torchrun(tmp_path, [*ENGINE_FLAGS, "--oracle-check"], path))
    assert len(ours["losses"]) == EPOCHS
    np.testing.assert_allclose(ours["losses"], theirs["losses"],
                               atol=ORACLE_TOL, rtol=0)
    assert ours["oracle_gap"] <= ORACLE_TOL
    assert ours["comm"] == theirs["comm"]
    assert ours["comm"]["halo_bytes"] > 0 and ours["comm"]["embed_grad_bytes"] > 0


_JAX_LEGACY_CODE = """
import argparse, importlib.util, json
import jax
import numpy as np
from jax.sharding import AxisType
spec = importlib.util.spec_from_file_location("ref_driver", {path!r})
ref = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ref)
calls = []
real_jit, real_make_mesh = jax.jit, jax.make_mesh
def auto_mesh(shape, names, **kw):
    return real_make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
def watched_jit(fn, *a, **kw):
    jitted = real_jit(fn, *a, **kw)
    class Watched:
        def lower(self, *args):
            return jitted.lower(*args)
        def __call__(self, params):
            out = jitted(params)
            calls.append((params, out))
            return out
    return Watched()
jax.jit, jax.make_mesh = watched_jit, auto_mesh
args = argparse.Namespace(parts=0, partition="metis_like", exec={exec_name!r},
                          epochs={epochs})
ref.run_legacy(args, ref.sbm_graph({vertices}, num_blocks=8, p_in=0.05,
                                   p_out=0.003, seed=0))
def listed(tree):
    return [{{k: np.asarray(a).tolist() for k, a in p.items()}}
            for p in tree["layers"]]
print("RESULT", json.dumps(dict(losses=[float(out[1]) for _, out in calls],
                                init=listed(calls[0][0]),
                                final=listed(calls[-1][1][0]))))
"""


@pytest.mark.parametrize("exec_name", ["spmm_1d", "spmm_2d"])
def test_torchrun_legacy_matches_one_rank(tmp_path, exec_name):
    """The legacy path on four gloo ranks (spmm_2d on a 2 x 2 grid), from
    the reference's initial weights, against the reference's own
    `run_legacy` on four host devices (its jitted step watched, its meshes
    made Auto-axis as in `test_no_engine_matches_run_legacy`): each epoch's
    loss and the final weights within 1e-4.  Beside it, the port's run on
    one rank from the same weights: the loss does not depend on the
    relabelling, so the losses agree within 1e-4."""
    path, tree = _save_reference_init(tmp_path)
    flags = ["--no-engine", "--exec", exec_name, "--vertices", str(VERTICES),
             "--epochs", str(EPOCHS)]
    code = _JAX_LEGACY_CODE.format(
        path=os.path.join(REPO, "examples", "train_gnn_distributed.py"),
        exec_name=exec_name, epochs=EPOCHS, vertices=VERTICES)
    ours, theirs = _beside_jax(code, lambda: _torchrun(tmp_path, flags, path))
    assert tuple(ours["grid"]) == train_gnn.legacy_grid_shape(exec_name, WORLD)
    for p, q in zip(theirs["init"], tree["layers"]):  # the same start
        for key in q:
            np.testing.assert_array_equal(np.asarray(p[key], np.float32),
                                          np.asarray(q[key]), err_msg=key)
    assert len(theirs["losses"]) == len(ours["losses"]) == EPOCHS
    np.testing.assert_allclose(ours["losses"], theirs["losses"],
                               atol=ORACLE_TOL, rtol=0)
    for p, q in zip(ours["params"], theirs["final"]):
        for key in q:
            np.testing.assert_allclose(p[key], q[key], atol=ORACLE_TOL, rtol=0,
                                       err_msg=key)
    alone = train_gnn.run_legacy(
        train_gnn.parse_args(["--device", "cpu", *flags]),
        sbm_graph(VERTICES, num_blocks=8, p_in=0.05, p_out=0.003, seed=0), CPU,
        params=params_from_numpy(jax.tree.map(np.asarray, tree), CPU))
    np.testing.assert_allclose(ours["losses"], alone["losses"],
                               atol=ORACLE_TOL, rtol=0)


def test_rendezvous_reads_torchrun_environment():
    from repro_torch.examples.train_gnn_distributed import rendezvous

    env = dict(RANK="2", WORLD_SIZE="4", MASTER_ADDR="localhost",
               MASTER_PORT="29511")
    assert rendezvous(env) == ["--world-size", "4", "--rank", "2",
                               "--init-method", "tcp://localhost:29511"]
    assert rendezvous({}) == []
    assert rendezvous({}, "file:///tmp/r")[-1] == "file:///tmp/r"
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        rendezvous(dict(RANK="0", WORLD_SIZE="2"))


# ---------------------------------------------------------------------------
# the staleness ablation
# ---------------------------------------------------------------------------


def _carried(model, dims, generator, device):
    """The reference's initial weights for the generator's seed."""
    tree = jinit_gnn_params(model, dims,
                            jax.random.PRNGKey(generator.initial_seed()))
    return params_from_numpy(jax.tree.map(np.asarray, tree), device)


def test_staleness_ablation_matches_reference(monkeypatch, capsys):
    from repro.core import full_graph_train as jfull_graph_train
    from repro_torch.examples import staleness_ablation

    monkeypatch.setattr(training, "init_gnn_params", _carried)
    out = staleness_ablation.main(["--device", "cpu"])
    assert "expected pattern" in capsys.readouterr().out
    jg = jsbm_graph(300, num_blocks=4, p_in=0.08, p_out=0.004, seed=0)
    sync = jfull_graph_train(jg, epochs=60)
    np.testing.assert_allclose(out["sync"].losses, sync.losses,
                               atol=ORACLE_TOL, rtol=0)
    assert [(p, kw) for p, kw, _ in out["rows"]] == list(staleness_ablation.ROWS)
    for proto, kw, ours in out["rows"]:
        theirs = jfull_graph_train(jg, protocol=proto, epochs=60, **kw)
        assert ours.bytes_pushed == theirs.bytes_pushed > 0, (proto, kw)
        np.testing.assert_allclose(ours.losses, theirs.losses,
                                   atol=ORACLE_TOL, rtol=0, err_msg=f"{proto}{kw}")
