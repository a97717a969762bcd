"""The port's partition autotuner: `repro_torch/core/partition/autotune.py`
and the layouts' per-device byte models and telemetry gauges it reads,
against `repro`'s on the CPU.

Number for number: `graph_stats`, every family's `device_bytes_per_step`
and `telemetry_gauges` (edge cut under each execution model and
partitioner; the cartesian2d and libra vertex cuts; the hybrid cut at its
degree-percentile thresholds, inf and 0; gcn and gat; k = 1 and 4), the
three cost models themselves, and `enumerate_plans`' labels, pipeline
knobs, predictions and balance claims on a power-law and an SBM graph;
`choose_plan` picks the same label under both objectives, its refusals.
`validate_plan` on one rank (every prediction 0 bytes, every balance 1.0;
the hybrid plan refused as the reference refuses it, its halo gauge 0 on
the one device; a plan scored for 4 devices refused) and on four gloo ranks (four CPU
processes) against JAX's on four forced host devices (one
`run_with_devices` subprocess run alongside): each family's chosen plan
measures JAX's bytes field for field with ratio 1.0 and its balance claim
exactly, `PlanRejected` on a drifting byte claim, a drifting balance claim
and a world-size mismatch, and `autotune` end to end choosing JAX's plan.
"""
import dataclasses
import json
import sys
import threading

import numpy as np
import pytest

from conftest import run_with_devices

WORLD = 4
RANK_TIMEOUT = 240  # seconds, for each rank process
POWERLAW = dict(num_vertices=100, avg_degree=8, seed=1)
SBM = dict(num_vertices=96, num_blocks=8, p_in=0.08, p_out=0.01, seed=0)
HIDDEN = 16


def _graphs(pkg):
    from importlib import import_module

    graph = import_module(f"{pkg}.core.graph")
    return dict(powerlaw=graph.powerlaw_graph(**POWERLAW),
                sbm=graph.sbm_graph(**SBM))


def _dims(g):
    return [g.features.shape[1], HIDDEN, int(g.labels.max()) + 1]


def _gauges(pkg, layout) -> dict:
    from importlib import import_module

    tel = import_module(f"{pkg}.core.telemetry").Telemetry()
    layout.telemetry_gauges(tel)
    return tel.metrics.as_dict()


def test_graph_stats_equal_the_reference():
    from repro.core.partition.autotune import graph_stats as jgraph_stats
    from repro_torch.core.partition.autotune import graph_stats

    ours, theirs = _graphs("repro_torch"), _graphs("repro")
    for name in ours:
        assert graph_stats(ours[name]) == jgraph_stats(theirs[name]), name
    s = graph_stats(ours["powerlaw"])
    assert s["p90"] <= s["p95"] <= s["p99"] <= s["max_degree"]


LAYOUTS = ([("edge_cut", e, dict(partitioner=p)) for e in
            ("p2p", "broadcast", "ring") for p in ("metis_like", "hash")]
           + [("vertex_cut", e, dict(vertex_cut=c, sorted_masters=True))
              for e in ("p2p", "broadcast") for c in ("cartesian2d", "libra")]
           + [("hybrid", e, dict(hub_threshold=t)) for e in ("p2p", "ring")
              for t in (None, float("inf"), 0.0)])


def _layout_id(case):
    family, execution, var = case
    return f"{family}-{execution}-" + "-".join(str(v) for v in var.values())


@pytest.mark.parametrize("case", LAYOUTS, ids=[_layout_id(c) for c in LAYOUTS])
def test_device_bytes_and_gauges_equal_the_reference(case):
    from repro.core.engine import EngineConfig as JConfig
    from repro.core.partition.layout_api import (
        get_layout_builder as jget_layout_builder,
    )
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.partition.layout_api import get_layout_builder

    family, execution, var = case
    ours, theirs = _graphs("repro_torch"), _graphs("repro")
    for name in ("powerlaw", "sbm"):
        for k in (1, 4):
            cfg = dict(partition_family=family, execution=execution, **var)
            lay = get_layout_builder(family)(ours[name], k,
                                             EngineConfig(**cfg))
            jlay = jget_layout_builder(family)(theirs[name], k,
                                               JConfig(**cfg))
            for model in ("gcn", "gat"):
                dims = _dims(ours[name])
                got = lay.device_bytes_per_step(model, dims)
                want = np.asarray(jlay.device_bytes_per_step(model, dims))
                assert got.shape == (k,)
                assert np.array_equal(got, want), (name, k, model)
            assert _gauges("repro_torch", lay) == _gauges("repro", jlay), (
                name, k)


def test_cost_models_equal_the_reference():
    import repro.core.partition.cost_models as jcm
    import repro_torch.core.partition.cost_models as cm
    from repro.core.partition.edge_cut import PARTITIONERS as JPARTITIONERS
    from repro_torch.core.partition.edge_cut import PARTITIONERS

    ours, theirs = _graphs("repro_torch"), _graphs("repro")
    for name in ours:
        for k in (1, 3, 4):
            part = PARTITIONERS["metis_like"](ours[name], k)
            jpart = JPARTITIONERS["metis_like"](theirs[name], k)
            for model in ("gcn", "sage", "gat"):
                dims = _dims(ours[name])
                assert np.array_equal(
                    cm.edge_cut_halo_device_bytes(ours[name], part, dims,
                                                  model=model),
                    jcm.edge_cut_halo_device_bytes(theirs[name], jpart, dims,
                                                   model=model))


def _plan_rows(plans):
    return [(p.label(), p.family, p.execution, p.k, p.hidden, p.num_layers,
             p.exchange_chunks, p.p2p_buckets, p.predicted_step_bytes,
             p.predicted_bottleneck_bytes, p.balance_claim) for p in plans]


@pytest.mark.parametrize("model", ["gcn", "gat"])
@pytest.mark.parametrize("graph", ["powerlaw", "sbm"])
def test_enumerate_and_choose_equal_the_reference(graph, model):
    from repro.core.partition.autotune import choose_plan as jchoose_plan
    from repro.core.partition.autotune import (
        enumerate_plans as jenumerate_plans,
    )
    from repro_torch.core.partition.autotune import (
        choose_plan,
        enumerate_plans,
    )

    g, jg = _graphs("repro_torch")[graph], _graphs("repro")[graph]
    plans = enumerate_plans(g, WORLD, _dims(g), model)
    jplans = jenumerate_plans(jg, WORLD, _dims(jg), model)
    assert _plan_rows(plans) == _plan_rows(jplans)
    assert {p.family for p in plans} == {"edge_cut", "vertex_cut", "hybrid"}
    assert all(p.predicted_step_bytes > 0 and p.balance_claim for p in plans)
    for objective in ("bottleneck", "total"):
        assert choose_plan(plans, objective).label() == jchoose_plan(
            jplans, objective).label()
    best = choose_plan(plans)
    assert best.predicted_bottleneck_bytes == min(
        p.predicted_bottleneck_bytes for p in plans)
    # a tiny table budget turns on chunking and p2p buckets, as JAX's
    small = enumerate_plans(g, WORLD, _dims(g), model, table_budget_bytes=1024)
    jsmall = jenumerate_plans(jg, WORLD, _dims(jg), model,
                              table_budget_bytes=1024)
    assert _plan_rows(small) == _plan_rows(jsmall)
    assert max(p.p2p_buckets for p in small) > 1
    with pytest.raises(ValueError):
        choose_plan(plans, objective="nope")
    with pytest.raises(ValueError):
        choose_plan([])


def test_validate_plan_one_rank():
    """At one rank every prediction is 0 bytes and every balance 1.0: the
    dryrun measures exactly that for the edge and vertex cuts.  The hybrid
    cut's ``layout.halo_rows`` gauge is 0 on the one device, which the
    claim reads as balance 1.0 and the imbalance report as 0.0: the
    reference refuses that plan too, with the same message.  A plan scored
    for 4 devices is refused with the reference's message; `autotune` runs
    end to end; the plan's `engine_config` is the port's."""
    import jax
    from jax.sharding import AxisType

    from repro.core.partition.autotune import PlanRejected as JPlanRejected
    from repro.core.partition.autotune import (
        enumerate_plans as jenumerate_plans,
    )
    from repro.core.partition.autotune import validate_plan as jvalidate_plan
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.partition.autotune import (
        PlanRejected,
        autotune,
        choose_plan,
        enumerate_plans,
        validate_plan,
    )

    g, jg = _graphs("repro_torch")["sbm"], _graphs("repro")["sbm"]
    plans = enumerate_plans(g, 1, _dims(g), "gcn")
    jplans = jenumerate_plans(jg, 1, _dims(jg), "gcn")
    mesh = jax.make_mesh((1,), ("w",), axis_types=(AxisType.Auto,))
    for fam in ("edge_cut", "vertex_cut", "hybrid"):
        plan = choose_plan([p for p in plans if p.family == fam])
        assert plan.predicted_step_bytes == 0
        assert set(plan.balance_claim.values()) == {1.0}
        if fam == "hybrid":
            jplan = choose_plan([p for p in jplans if p.family == fam])
            with pytest.raises(JPlanRejected) as theirs:
                jvalidate_plan(jg, jplan, steps=2, mesh=mesh)
            with pytest.raises(PlanRejected) as ours:
                validate_plan(g, plan, steps=2, device="cpu")
            assert str(ours.value) == str(theirs.value)
            assert "layout.halo_rows measured 0.0" in str(ours.value)
            continue
        rep = validate_plan(g, plan, steps=2, device="cpu")
        assert rep["ratio"] == 1.0 and rep["measured_bytes"] == 0, rep
        for b in rep["balance"].values():
            assert b["measured"] == b["claimed"] == 1.0
    with pytest.raises(PlanRejected, match="the predictions do not transfer"):
        validate_plan(g, dataclasses.replace(plans[0], k=4), device="cpu")
    plan, report = autotune(g, 1, _dims(g), "gcn", device="cpu")
    assert report["chosen"] == plan.label()
    assert report["validation"]["ratio"] == 1.0
    assert isinstance(plan.engine_config(), EngineConfig)


_JAX_CODE = """
import dataclasses, json
import jax
from jax.sharding import AxisType
from repro.core.graph import powerlaw_graph
from repro.core.partition.autotune import (
    autotune, choose_plan, enumerate_plans, validate_plan)
graph, hidden, out_path = json.loads({args!r})
mesh = jax.make_mesh((4,), ("w",), axis_types=(AxisType.Auto,))
g = powerlaw_graph(**graph)
dims = [g.features.shape[1], hidden, int(g.labels.max()) + 1]
plans = enumerate_plans(g, 4, dims, "gcn")
out = {{}}
for fam in ("edge_cut", "vertex_cut", "hybrid"):
    plan = choose_plan([p for p in plans if p.family == fam])
    out[fam] = validate_plan(g, plan, steps=2, mesh=mesh)
plan, report = autotune(g, 4, dims, "gcn", mesh=mesh)
out["autotune"] = report
with open(out_path, "w") as f:
    json.dump(out, f)
print("JAX AUTOTUNE DONE")
"""

_RANK_CODE = """
import dataclasses, json, os, sys, traceback
try:
    tmp, rank, world, graph, hidden = json.loads(sys.argv[1])
    import torch
    from repro_torch.core.execution import collectives
    from repro_torch.core.graph import powerlaw_graph
    from repro_torch.core.partition.autotune import (
        PlanRejected, autotune, choose_plan, enumerate_plans, validate_plan)
    collectives.init_group(f"file://{tmp}/rendezvous", world, rank,
                           torch.device("cpu"))
    g = powerlaw_graph(**graph)
    dims = [g.features.shape[1], hidden, int(g.labels.max()) + 1]
    plans = enumerate_plans(g, world, dims, "gcn")
    out = {}
    for fam in ("edge_cut", "vertex_cut", "hybrid"):
        plan = choose_plan([p for p in plans if p.family == fam])
        out[fam] = validate_plan(g, plan, steps=2, device="cpu")
    best = choose_plan(plans)
    rejected = {}
    for what, bad in (
            ("bytes", dataclasses.replace(
                best, predicted_step_bytes=best.predicted_step_bytes * 10)),
            ("balance", dataclasses.replace(best, balance_claim={
                k: v * 10 for k, v in best.balance_claim.items()})),
            ("k", dataclasses.replace(best, k=64))):
        try:
            validate_plan(g, bad, steps=2, device="cpu")
            rejected[what] = "accepted"
        except PlanRejected as e:
            rejected[what] = str(e)
    out["rejected"] = rejected
    plan, report = autotune(g, world, dims, "gcn", device="cpu")
    out["autotune"] = report
    out["engine_config"] = dataclasses.asdict(plan.engine_config())
    collectives.destroy_group()
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(out, f)
except BaseException:
    traceback.print_exc()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(1)
"""


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """`validate_plan` and `autotune` on 4 gloo ranks and JAX's on 4
    forced host devices, run together."""
    from test_torch_distributed import _run_ranks

    tmp = tmp_path_factory.mktemp("torch_autotune")
    jax_path = str(tmp / "jax.json")
    code = _JAX_CODE.format(args=json.dumps([POWERLAW, HIDDEN, jax_path]))
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
            [str(tmp), r, WORLD, POWERLAW, HIDDEN])] for r in range(WORLD)],
            timeout=RANK_TIMEOUT)
    finally:
        jax_thread.join()
    if jax_error:
        raise jax_error[0]
    with open(jax_path) as f:
        jax_res = json.load(f)
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    return dict(jax=jax_res, ranks=ranks)


@pytest.mark.parametrize("family", ["edge_cut", "vertex_cut", "hybrid"])
def test_validate_plan_four_ranks_measures_jax_bytes(four, family):
    theirs = four["jax"][family]
    for ours in four["ranks"]:
        rep = ours[family]
        assert rep["ratio"] == 1.0, rep
        assert rep["plan"] == theirs["plan"]
        assert rep["measured_fields"] == theirs["measured_fields"]
        assert rep["measured_bytes"] == theirs["measured_bytes"] > 0
        assert rep["predicted_bytes"] == theirs["predicted_bytes"]
        assert rep["balance"] == theirs["balance"]
        for b in rep["balance"].values():
            assert abs(b["measured"] - b["claimed"]) < 1e-9


def test_validate_plan_four_ranks_rejects_drift_and_mismatch(four):
    for ours in four["ranks"]:
        rej = ours["rejected"]
        assert "drifts past" in rej["bytes"] and "wire bytes" in rej["bytes"]
        assert "balance gauge" in rej["balance"]
        assert "the predictions do not transfer" in rej["k"]


def test_autotune_four_ranks_chooses_jax_plan(four):
    theirs = four["jax"]["autotune"]
    for ours in four["ranks"]:
        rep = ours["autotune"]
        assert rep["chosen"] == theirs["chosen"]
        assert rep["graph"] == theirs["graph"]
        assert rep["candidates"] == theirs["candidates"]
        assert rep["validation"] == theirs["validation"]
        assert len(rep["candidates"]) >= 12
        assert ours["engine_config"]["partition_family"] == \
            rep["chosen"].split("/")[0]
