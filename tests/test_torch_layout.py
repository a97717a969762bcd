"""The port's host layer against the reference: synthetic graphs bitwise
equal for one seed, partitioners equal, and the vectorised edge-cut layout
build array-for-array equal to the reference's loop build, at k = 1 and
k = 4 (numpy build only; the engine runs k = 1)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import utils as jutils
from repro.configs import gcn_paper as jgcn_paper
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.feature_store import FeatureStore as JFeatureStore
from repro.core.graph import er_graph as jer_graph, sbm_graph as jsbm_graph
from repro.core.partition import cost_models as jcost
from repro.core.partition.edge_cut import PARTITIONERS as JPARTITIONERS
from repro.core.partition.layout_api import EdgeCutLayout as JEdgeCutLayout
from repro_torch import utils
from repro_torch.configs import gcn_paper
from repro_torch.core.engine import EngineConfig
from repro_torch.core.feature_store import FeatureStore
from repro_torch.core.graph import er_graph, sbm_graph
from repro_torch.core.partition import cost_models
from repro_torch.core.partition.edge_cut import PARTITIONERS
from repro_torch.core.partition.layout_api import EdgeCutLayout

GRAPHS = {
    "er": (er_graph, jer_graph,
           dict(num_vertices=300, avg_degree=3, feature_dim=12,
                num_classes=5, seed=3)),
    "sbm": (sbm_graph, jsbm_graph,
            dict(num_vertices=96, num_blocks=4, p_in=0.1, p_out=0.01,
                 feature_dim=8, seed=0)),
}
GRAPH_FIELDS = ("indptr", "indices", "features", "labels", "train_mask",
                "val_mask", "test_mask")


def test_config_and_utils_copies_equal():
    for ours, theirs in ((gcn_paper.CONFIG, jgcn_paper.CONFIG),
                         (gcn_paper.smoke_config(), jgcn_paper.smoke_config())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for a in (0, 1, 127, 128, 129):
        assert utils.round_up(a, 128) == jutils.round_up(a, 128)
        assert utils.cdiv(a, 7) == jutils.cdiv(a, 7)


def _graphs(name):
    make, jmake, kw = GRAPHS[name]
    return make(**kw), jmake(**kw)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_generators_bitwise_equal(name):
    g, jg = _graphs(name)
    assert g.num_vertices == jg.num_vertices
    for field in GRAPH_FIELDS:
        a, b = getattr(g, field), getattr(jg, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


@pytest.mark.parametrize("partitioner", ["hash", "range"])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_partitioners_equal(partitioner, k):
    g, jg = _graphs("er")
    a = PARTITIONERS[partitioner](g, k).assignment
    b = JPARTITIONERS[partitioner](jg, k).assignment
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("partitioner", ["hash", "range"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_edge_cut_layout_equal(name, k, partitioner):
    g, jg = _graphs(name)
    lay = EdgeCutLayout(g, k, EngineConfig(partitioner=partitioner))
    jlay = JEdgeCutLayout(jg, k, JEngineConfig(execution="broadcast",
                                               partitioner=partitioner))
    assert (lay.nb, lay.Vp, lay.K) == (jlay.nb, jlay.Vp, jlay.K)
    for ours, theirs in ((lay.new_of_old, jlay.new_of_old),
                         (lay.ids_global, jlay.ids_global),
                         (lay.mask, np.asarray(jlay.mask)),
                         (lay.deg, np.asarray(jlay.deg)),
                         (lay.X.numpy(), np.asarray(jlay.X)),
                         (lay.ids_exec, np.asarray(jlay.ids_exec))):
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    for model, dims in (("gcn", [12, 8, 5]), ("gat", [12, 8, 8, 5])):
        assert (lay.wire_fields_per_step(model, dims)
                == jlay.wire_fields_per_step(model, dims))
    H = np.random.default_rng(0).standard_normal((lay.Vp, 4)).astype(np.float32)
    assert np.array_equal(lay.global_embeddings(H), jlay.global_embeddings(H))


def test_layout_for_an_unported_plan_raises():
    g, _ = _graphs("sbm")
    with pytest.raises(NotImplementedError, match="multi-rank"):
        EdgeCutLayout(g, 1, EngineConfig(execution="p2p"))


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("execution", ["broadcast", "ring"])
def test_cost_models_equal(execution, k):
    for model, family in (("gcn", "edge_cut"), ("gat", "edge_cut"),
                          ("gat", "vertex_cut")):
        dims = [16, 8, 8, 3]
        assert (cost_models.model_exchange_widths(model, dims, family)
                == jcost.model_exchange_widths(model, dims, family))
    for model in ("gcn", "gat"):
        assert (cost_models.inference_bytes_per_sweep(
                    execution, [16, 8, 3], model=model, k=k, nb=37)
                == jcost.inference_bytes_per_sweep(
                    execution, [16, 8, 3], model=model, k=k, nb=37))


def test_feature_store_update_rows_is_live():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((2, 5, 3)).astype(np.float32)
    store, jstore = FeatureStore(table, torch.device("cpu")), JFeatureStore(table)
    view = store.device_table()
    ids, rows = np.array([7, 1]), rng.standard_normal((2, 3)).astype(np.float32)
    store.update_rows(ids, rows)
    jstore.update_rows(ids, rows)
    assert (store.num_rows, store.dim) == (jstore.num_rows, jstore.dim)
    assert np.array_equal(view.numpy(), np.asarray(jstore.device_table()))
