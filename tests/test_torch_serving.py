"""The port's slice as a whole: `repro_torch`'s layer-wise GCN inference
sweep on the CPU against the JAX engine's distributed sweep (Pallas ELL in
interpret mode, one device on an Auto-axis mesh) and its single-device
reference, with the reference's own weights carried over; the serving
driver; the engine's device and config guards; and the import-purity guard
(the port imports nothing of JAX or of `repro`)."""
import dataclasses
import os
import re
import subprocess
import sys
import textwrap

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
from repro_torch.core.graph import er_graph
from repro_torch.core.models.gnn import init_gnn_params, params_from_numpy
from repro_torch.core.partition.edge_cut import hash_partition
from repro_torch.kernels.ell_spmm import ell_spmm
from repro_torch.launch import serve_gnn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
ORACLE_TOL = 1e-4  # the repo's oracle bound for every sweep
CPU = torch.device("cpu")
# dims [24, 16, 16, 5]; average in-degree 3 leaves some vertices isolated
GRAPH = dict(num_vertices=120, avg_degree=3, feature_dim=24, num_classes=5,
             seed=1)


def _engines(chunks):
    g, jg = er_graph(**GRAPH), jer_graph(**GRAPH)
    eng = DistGNNEngine(g, EngineConfig(execution="broadcast",
                                        partitioner="hash", hidden=16,
                                        num_layers=3, exchange_chunks=chunks),
                        device=CPU)
    mesh = jax.make_mesh((1,), ("w",), axis_types=(AxisType.Auto,))
    jeng = JDistGNNEngine(jg, mesh=mesh, cfg=JEngineConfig(
        execution="broadcast", partitioner="hash", hidden=16, num_layers=3,
        exchange_chunks=chunks, interpret=True))
    return g, eng, jeng


@pytest.mark.parametrize("chunks", [1, 2])
def test_sweep_matches_jax_sweep_and_reference(chunks):
    g, eng, jeng = _engines(chunks)
    assert eng.dims == jeng.dims == [24, 16, 16, 5]
    assert (g.degree() == 0).any(), "the graph should have isolated vertices"
    jparams = jinit_gnn_params("gcn", jeng.dims, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    before = ell_spmm.launches
    emb = eng.global_embeddings(eng.infer_full_graph(params=params))
    ref = eng.global_embeddings(eng.infer_full_graph(params=params,
                                                     reference=True))
    assert ell_spmm.launches == before  # CPU tensors never launch the kernel
    jemb = jeng.global_embeddings(jeng.infer_full_graph(params=jparams))
    jref = jeng.global_embeddings(jeng.infer_full_graph(params=jparams,
                                                        reference=True))
    assert emb.shape == (g.num_vertices, 5) and np.isfinite(emb).all()
    for other in (jemb, jref, ref):
        np.testing.assert_allclose(emb, other, atol=ORACLE_TOL, rtol=0)
    deg0 = g.degree() == 0
    np.testing.assert_allclose(emb[deg0], jref[deg0], atol=ORACLE_TOL, rtol=0)


def test_inference_bytes_and_global_embeddings_equal():
    g, eng, jeng = _engines(1)
    assert eng.inference_bytes_per_sweep() == jeng.inference_bytes_per_sweep()
    jparams = jinit_gnn_params("gcn", jeng.dims, jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    eng.infer_full_graph(params=params)
    jeng.infer_full_graph(params=jparams)
    assert (eng.comm_stats.inference_bytes == jeng.comm_stats.inference_bytes
            == eng.inference_bytes_per_sweep())
    H = np.random.default_rng(0).standard_normal((eng.Vp, 3)).astype(np.float32)
    assert np.array_equal(eng.global_embeddings(torch.from_numpy(H)),
                          jeng.global_embeddings(H))


def test_live_store_update_reaches_next_sweep():
    g, eng, _ = _engines(2)
    params = init_gnn_params("gcn", eng.dims, torch.Generator().manual_seed(0),
                             CPU)
    H0 = eng.infer_full_graph(params=params).clone()
    rows = np.random.default_rng(2).standard_normal((4, 24)).astype(np.float32)
    eng.store.update_rows(np.arange(4), rows)
    H1 = eng.infer_full_graph(params=params)
    ref1 = eng.infer_full_graph(params=params, reference=True)
    assert not torch.equal(H0, H1)
    torch.testing.assert_close(H1, ref1, atol=ORACLE_TOL, rtol=0)


def test_init_gnn_params_distribution_and_seed():
    dims = [64, 32, 8]
    p1 = init_gnn_params("gcn", dims, torch.Generator().manual_seed(3), CPU)
    p2 = init_gnn_params("gcn", dims, torch.Generator().manual_seed(3), CPU)
    assert [tuple(p["w"].shape) for p in p1["layers"]] == [(64, 32), (32, 8)]
    for a, b, fan_in in zip(p1["layers"], p2["layers"], dims):
        assert torch.equal(a["w"], b["w"]) and not a["b"].any()
        assert abs(float(a["w"].std()) * fan_in ** 0.5 - 1.0) < 0.15
    with pytest.raises(ValueError, match="model must be one of"):
        init_gnn_params("gatv2", dims, torch.Generator(), CPU)


def test_serve_gnn_main_on_cpu():
    emb, wall = serve_gnn.main(["--device", "cpu", "--vertices", "64",
                                "--layers", "3", "--exchange-chunks", "2",
                                "--oracle-check"])
    assert emb.shape == (64, 8) and np.isfinite(emb).all() and wall > 0


def test_entry_points_default_to_the_card(monkeypatch):
    """Without CUDA the engine and the driver refuse to start unless the
    caller asks for the CPU: no silent CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = er_graph(**GRAPH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DistGNNEngine(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_gnn.main(["--vertices", "32"])


@pytest.mark.parametrize("case", ["model", "execution", "batching", "family",
                                  "ranks"])
def test_engine_rejects_what_is_not_ported(case):
    """Every model, execution model, protocol, batching mode and partition
    family is ported, trainable features too: each case that held the
    trainable refusal now builds the trainable engine on its axis and
    holds its state's keys and shapes (``model``: gat under layer_wise;
    ``execution``: the ring under subgraph; ``batching``: node_wise;
    ``family``: the vertex cut's full-graph step, whose touched rows are
    its master slots, and the reference's guard: trainable features
    refused under a historical-embedding protocol).  A partition whose
    part count is not the process group's rank count (one rank here: no
    group) is a caller's error."""
    g = er_graph(**GRAPH)
    if case == "ranks":
        with pytest.raises(ValueError,
                           match="4 parts and the process group 1 rank"):
            DistGNNEngine(g, EngineConfig(), hash_partition(g, 4),
                          device=CPU)
        return
    cfg = EngineConfig(trainable_features=True, hidden=8)
    if case == "model":
        cfg.model, cfg.batching = "gat", "layer_wise"
    elif case == "execution":
        cfg.execution, cfg.batching = "ring", "subgraph"
    elif case == "batching":
        cfg.batching = "node_wise"
    else:
        cfg.partition_family, cfg.execution = "vertex_cut", "broadcast"
        with pytest.raises(ValueError, match="protocol='sync'"):
            DistGNNEngine(g, dataclasses.replace(cfg, protocol="epoch_fixed"),
                          device=CPU)
    eng = DistGNNEngine(g, cfg, device=CPU)
    full = cfg.batching == "full_graph"
    state = eng.init_state() if full else eng.init_minibatch_state()
    assert set(state) == {"params", "step", "embed", "emb_m", "emb_v",
                          "emb_t"}
    D = g.features.shape[1]
    for key in ("embed", "emb_m", "emb_v"):
        assert tuple(state[key].shape) == (eng.nb, D)
        assert state[key].dtype == torch.float32
    assert not state["emb_m"].any() and not state["emb_v"].any()
    assert state["emb_t"].dtype == torch.int32 and not state["emb_t"].any()
    assert tuple(state["emb_t"].shape) == (eng.nb,)
    assert torch.equal(state["embed"], eng.store.device_table())
    if full:
        assert eng.emb_touched.sum() == g.num_vertices  # one master each
    else:
        assert eng.tcap == min(eng.nb, eng.k * eng.caps[0])


_PURITY_CODE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("repro_torch.core.training", "repro_torch.core.execution.chunk",
             "repro_torch.core.execution.spmm_models",
             "repro_torch.core.protocols.sync",
             "repro_torch.core.partition.feature_partition",
             "repro_torch.models.transformer", "repro_torch.launch.serve",
             "repro_torch.launch.batching", "repro_torch.launch.serve_llm",
             "repro_torch.launch.train", "repro_torch.optim.optimizers",
             "repro_torch.checkpoint.ckpt", "repro_torch.data.pipeline",
             "repro_torch.examples.train_llm_100m",
             "repro_torch.examples.quickstart"):
    assert name in names, name
# the packages' lazy exports, every one resolved
for pkg in ("repro_torch.core", "repro_torch.core.execution",
            "repro_torch.core.protocols", "repro_torch.core.partition"):
    mod = importlib.import_module(pkg)
    for name in mod.__all__:
        getattr(mod, name)
from repro_torch.core.models.gnn import full_graph_forward
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
assert "repro_torch.core.engine" in sys.modules
print("PURE", len(names))
"""

_FORBIDDEN_IMPORT = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)\b",
                               re.MULTILINE)


def test_port_imports_nothing_of_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, REPO]))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_PURITY_CODE)],
                          capture_output=True, text=True, timeout=120, env=env,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PURE" in proc.stdout
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(sources) > 20
    for path in sources:
        with open(path) as f:
            hits = _FORBIDDEN_IMPORT.findall(f.read())
        assert not hits, (path, hits)
