"""The port's run-wide telemetry: `repro_torch/core/telemetry.py` (a copy of
the stdlib-only `repro.core.telemetry`) and the engine's instrumentation.

The module: every recording and export call made the same way on both
modules gives the same result (spans, metrics, the imbalance report, the
run summary, the Chrome trace and the step log, under one fake clock);
percentiles bitwise equal to the reference's and to numpy's, bucket counts,
the disabled no-op identity and its overhead bound, the trace schema's
round trip through a file, distinct lanes for two threads.

The engine (the reference's `tests/test_telemetry.py` contract): a traced
pipelined node-wise epoch and one coalesced flush of two overlapping
requests.  The summed bytes of the ``exchange`` spans equal
``CommStats.total()``, every CommStats field equals its ``comm.*`` counter,
every step has its sample, extract and train spans, the producer and the
trainer are two lanes, the imbalance report sees every device, the run
summary is JSON and the Chrome trace reads back from its file.  Against
the JAX engine on the same graph and config: the per-device ``comm.*``
counters, the layout gauges, ``frontier_occupancy``, the store's overlay
hits and misses and the ``serve.*`` counters equal JAX's exactly, and the
answers are within 1e-4.  One rank (in-process JAX, 1-device Auto mesh)
and four gloo ranks (four CPU processes, `file://` rendezvous) against
JAX on four forced host devices (one `run_with_devices` subprocess run
alongside), every rank's registry equal to the reference's single-host
one.  Also the pool's replayed spans (process mode), the traced full-graph
`train` and sweep, and `train_gnn --trace-out` on one rank and four.
"""
import dataclasses
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import repro.core.telemetry as ref_telemetry
import repro_torch.core.telemetry as port_telemetry
from conftest import run_with_devices

TESTS = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")
ORACLE_TOL = 1e-4
WORLD = 4
RANK_TIMEOUT = 240  # seconds, for each rank process
# the reference's traced-engine contract (`tests/test_telemetry.py`)
TRACE_GRAPH = dict(num_vertices=96, num_blocks=4, p_in=0.2, p_out=0.05,
                   feature_dim=8, num_classes=4, seed=0)
TRACE_CFG = dict(batching="node_wise", execution="p2p", batch_size=4,
                 fanouts=(3, 3), cache_policy="static_degree",
                 cache_capacity=8, seed=0)
NB = 4  # pipelined steps of the traced epoch
REQUESTS = ([1, 2, 3], [3, 4])  # the flush: two overlapping requests
# the metrics compared with JAX's: every one but the prefetch lane's
# (stalls and queue depth depend on the thread schedule)
COMPARED = ("comm.", "store.", "serve.", "layout.", "frontier_occupancy")


class FakeClock:
    """Deterministic clock: each call advances by `dt`."""

    def __init__(self, dt=1.0):
        self.t = 0.0
        self.dt = dt

    def __call__(self):
        self.t += self.dt
        return self.t


# ---------------------------------------------------------------------------
# the module, call for call against the reference's
# ---------------------------------------------------------------------------

def _drive(mod, tmp_path, tag):
    """One fixed sequence of recording and export calls on ``mod``'s
    Telemetry under a fake clock; returns everything it exports."""
    tel = mod.Telemetry(clock=FakeClock(0.25))
    with tel.span("outer", step=0):
        with tel.span("sample", step=0, device=1) as sp:
            sp.set(rows=7)
        with tel.span("extract", step=0, device=2):
            pass
    tel.instant("exchange", stage="extract", bytes=64, device=2)
    tel.record_span("sample", 0.5, 1.25, tid=("sampler-proc", 0), step=1,
                    device=0)
    for d, v in ((0, 30), (1, 10), (2, 10), (3, 10)):
        tel.counter("comm.pull_bytes", device=d).add(v)
        tel.gauge("layout.owned_vertices", device=d).set(d + 1)
    tel.counter("comm.pull_bytes").add(2)
    h = tel.histogram("serve.flush_latency_s")
    for v in (1e-5, 2e-4, 3e-3, 0.5, 20.0):
        h.record(v)
    tel.histogram("custom", buckets=(1.0, 2.0)).record(1.5)
    tel.log_step(step=0, loss=0.5, comm_total_bytes=128, obj=object)
    tel.log_step(step=1, loss=0.25, comm_total_bytes=256)
    tel.attach_executable("train_step", {"max_memory_allocated": 1 << 20})
    trace, steps = tmp_path / f"{tag}.json", tmp_path / f"{tag}.jsonl"
    tel.write_chrome_trace(str(trace))
    tel.write_step_log(str(steps))
    return dict(summary=tel.run_summary(), chrome=tel.chrome_trace(),
                trace_file=trace.read_text(), steps_file=steps.read_text(),
                imbalance=tel.imbalance_report(),
                span_seconds=tel.span_seconds(),
                per_device=tel.metrics.per_device("comm.pull_bytes"),
                total=tel.metrics.counter_total("comm.pull_bytes"),
                p=[h.percentile(q) for q in (0.0, 50.0, 99.0, 100.0)],
                counts=list(h.counts))


def test_same_calls_same_exports_as_the_reference(tmp_path):
    ours = _drive(port_telemetry, tmp_path, "port")
    theirs = _drive(ref_telemetry, tmp_path, "ref")
    assert ours == theirs
    assert ours["counts"] == [1, 1, 0, 1, 0, 0, 0, 0, 1, 0, 0, 1]
    assert port_telemetry.DEFAULT_LATENCY_BUCKETS == \
        ref_telemetry.DEFAULT_LATENCY_BUCKETS


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 100, 1001])
def test_percentiles_bitwise_equal_to_the_reference_and_numpy(n):
    draws = np.random.default_rng(n).lognormal(mean=-5.0, sigma=2.0, size=n)
    if n > 3:
        draws[: n // 4] = draws[n // 2]  # ties
    h = port_telemetry.MetricRegistry().histogram("lat")
    for d in draws:
        h.record(d)
    for q in (0.0, 1.0, 25.0, 50.0, 75.0, 90.0, 99.0, 99.9, 100.0):
        want = float(np.percentile(draws, q)) if n else 0.0
        assert port_telemetry.exact_percentile(draws, q) == want, (n, q)
        assert ref_telemetry.exact_percentile(draws, q) == want, (n, q)
        assert h.percentile(q) == want, (n, q)


def test_histogram_bucket_counts_and_registry():
    reg = port_telemetry.MetricRegistry()
    h = reg.histogram("lat", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.5, 1.7, 3.0, 100.0):
        h.record(v)
    assert h.counts == [1, 2, 1, 1]  # the last bucket is the +inf overflow
    assert h.count == 5 and h.total == pytest.approx(106.7)
    c0 = reg.counter("comm.pull_bytes", device=0)
    assert reg.counter("comm.pull_bytes", device=0) is c0
    c0.add(10).add(5)
    reg.counter("comm.pull_bytes", device=1).add(3)
    assert reg.per_device("comm.pull_bytes") == {0: 15, 1: 3}
    assert reg.as_dict()["histograms"]["lat"][""]["counts"] == [1, 2, 1, 1]


def test_span_nesting_and_thread_lanes():
    tr = port_telemetry.Tracer(clock=FakeClock())
    with tr.span("outer", step=0):
        with tr.span("inner", device=1):
            pass
    outer, inner = tr.spans()
    assert (outer.depth, inner.depth) == (0, 1)
    assert outer.t0 < inner.t0
    assert inner.t0 + inner.dur <= outer.t0 + outer.dur
    tel = port_telemetry.Telemetry()
    barrier = threading.Barrier(2)

    def work(tag):
        barrier.wait()
        for i in range(5):
            with tel.span("stage", lane=tag, step=i):
                time.sleep(0.001)

    threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    xev = [e for e in tel.chrome_trace()["traceEvents"] if e["ph"] == "X"]
    assert {e["tid"] for e in xev} == {0, 1}
    lanes = {}
    for e in xev:
        lanes.setdefault(e["tid"], set()).add(e["args"]["lane"])
    assert all(len(v) == 1 for v in lanes.values())


def test_disabled_mode_is_a_noop_identity_within_its_overhead_bound():
    tel = port_telemetry.Telemetry(enabled=False)
    assert tel.span("x", step=1) is port_telemetry.NULL_SPAN
    assert tel.counter("c") is port_telemetry.NULL_METRIC
    assert tel.gauge("g") is port_telemetry.NULL_METRIC
    assert tel.histogram("h") is port_telemetry.NULL_METRIC
    with tel.span("x") as sp:
        sp.set(bytes=1)
    tel.instant("x", bytes=1)
    tel.record_span("x", 0.0, 1.0)
    tel.log_step(step=0)
    tel.attach_executable("e", {"a": 1})
    assert tel.trace.spans() == []
    assert tel.run_summary()["spans"]["count"] == 0
    assert tel.chrome_trace()["traceEvents"] == []
    assert tel.imbalance_report() == {"spans": {}, "metrics": {}}
    assert port_telemetry.NULL_TELEMETRY.span("y") is port_telemetry.NULL_SPAN
    n = 10000
    t0 = time.perf_counter()
    for i in range(n):
        with tel.span("s", step=i):
            pass
        tel.counter("c", device=0).add(1)
    per_call = (time.perf_counter() - t0) / n
    # the reference tier's bound: no hidden allocation or locking
    assert per_call < 50e-6, f"disabled telemetry costs {per_call * 1e6:.1f}us"


def test_chrome_trace_schema_and_step_log_round_trip(tmp_path):
    tel = port_telemetry.Telemetry()
    with tel.span("sample", step=0, device=1):
        with tel.span("extract", step=0, device=1):
            pass
    tel.instant("exchange", stage="extract", bytes=64, device=2)
    tel.log_step(step=0, loss=0.5, comm_total_bytes=128)
    path = tmp_path / "trace.json"
    tel.write_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    assert trace == tel.chrome_trace()
    xev = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert len(xev) == 3 and {e["pid"] for e in xev} == {1, 2}
    for e in xev:
        assert {"name", "ph", "ts", "dur", "pid", "tid"} <= set(e)
        assert e["ts"] >= 0.0 and e["dur"] >= 0.0
    meta = {m["args"]["name"] for m in trace["traceEvents"] if m["ph"] == "M"}
    assert meta >= {"device 1", "device 2", "lane 0"}
    steps = tmp_path / "steps.jsonl"
    tel.write_step_log(str(steps))
    recs = [json.loads(line) for line in steps.read_text().splitlines()]
    assert recs == [{"step": 0, "loss": 0.5, "comm_total_bytes": 128}]
    assert tel.run_summary()["steps"] == recs


# ---------------------------------------------------------------------------
# the engine: the traced-engine contract, on the port and on JAX
# ---------------------------------------------------------------------------

def compared_metrics(tel) -> dict:
    """The registry's metrics compared with JAX's, as JSON: counters and
    gauges by name and label set, histogram counts."""
    d = tel.metrics.as_dict()
    out = {}
    for kind in ("counters", "gauges"):
        for name, by_labels in d[kind].items():
            if name.startswith(COMPARED):
                out[f"{kind}/{name}"] = by_labels
    for name, by_labels in d["histograms"].items():
        out[f"histograms/{name}"] = {k: v["count"]
                                     for k, v in by_labels.items()}
    return out


def check_trace_contract(tel, comm_stats, k, trace_path) -> None:
    """The reference's traced-engine assertions on one rank's telemetry."""
    spans = tel.trace.spans()
    exch = sum(s.labels["bytes"] for s in spans if s.name == "exchange")
    assert exch == comm_stats.total(), (exch, comm_stats.total())
    for name, value in dataclasses.asdict(comm_stats).items():
        assert tel.metrics.counter_total("comm." + name) == value, name
    for stage in ("sample", "extract", "train"):
        steps = {s.labels.get("step") for s in spans if s.name == stage}
        assert set(range(NB)) <= steps, (stage, steps)
    devices = {s.labels["device"] for s in spans if s.name == "sample_device"}
    assert devices == set(range(k))
    assert any(s.name == "finalize" for s in spans)
    xev = [e for e in tel.chrome_trace()["traceEvents"] if e["ph"] == "X"]
    assert len({e["tid"] for e in xev}) >= 2, "expected >= 2 lanes"
    rep = tel.imbalance_report()["metrics"]
    # one rank reads no remote row: no pull bytes, no overlay hit
    for name in (("comm.pull_bytes", "layout.owned_vertices",
                  "frontier_occupancy", "store.overlay_hit") if k > 1
                 else ("layout.owned_vertices", "frontier_occupancy")):
        assert name in rep and len(rep[name]["per_device"]) == k, name
        assert rep[name]["max_over_mean"] >= 1.0
    assert tel.histogram("serve.flush_latency_s").count == 1
    assert tel.metrics.counter_total("serve.queries") == len(REQUESTS)
    assert tel.metrics.counter_total("serve.targets_requested") == sum(
        len(r) for r in REQUESTS)
    assert "prefetch.queue_depth" in tel.metrics.as_dict()["gauges"]
    json.dumps(tel.run_summary())
    tel.write_chrome_trace(trace_path)
    with open(trace_path) as f:
        assert json.load(f) == tel.chrome_trace()


def port_trace_run(trace_path: str, params) -> dict:
    """The traced pipelined epoch from the reference's initial ``params``
    (a numpy tree) and the coalesced flush on the port's engine (over the
    process group when one is joined), held to the contract; returns the
    compared metrics, CommStats and answers."""
    from repro_torch.core.engine import DistGNNEngine, EngineConfig
    from repro_torch.core.graph import sbm_graph
    from repro_torch.core.models.gnn import params_from_numpy
    from repro_torch.core.serving import GNNQueryEngine

    eng = DistGNNEngine(sbm_graph(**TRACE_GRAPH), EngineConfig(**TRACE_CFG),
                        device=CPU)
    held = eng.comm_stats
    tel = eng.enable_telemetry()
    state, _, _ = eng.run_epoch_minibatch(
        NB, schedule="pipelined",
        state=eng.init_minibatch_state(params_from_numpy(params, CPU)))
    assert held is eng.comm_stats
    assert eng.k == 1 or held.total() > 0  # one rank reads no remote row
    qe = GNNQueryEngine(eng, state["params"])
    rids = [qe.submit(r) for r in REQUESTS]
    answers = qe.flush()
    check_trace_contract(tel, eng.comm_stats, eng.k, trace_path)
    return dict(metrics=compared_metrics(tel),
                comm=dataclasses.asdict(eng.comm_stats),
                answers=[answers[r].tolist() for r in rids])


_JAX_TRACE = """
import dataclasses, json
import jax
import numpy as np
from jax.sharding import AxisType
from repro.core.engine import DistGNNEngine, EngineConfig
from repro.core.graph import sbm_graph
from repro.core.serving import GNNQueryEngine
graph, cfg, nb, requests, compared, out_path = json.loads({args!r})
cfg["fanouts"] = tuple(cfg["fanouts"])
mesh = jax.make_mesh((4,), ("w",), axis_types=(AxisType.Auto,))
eng = DistGNNEngine(sbm_graph(**graph), mesh=mesh,
                    cfg=EngineConfig(interpret=True, **cfg))
tel = eng.enable_telemetry()
state, _, _ = eng.run_epoch_minibatch(nb, schedule="pipelined")
qe = GNNQueryEngine(eng, state["params"])
rids = [qe.submit(r) for r in requests]
answers = qe.flush()
d = tel.metrics.as_dict()
metrics = {{}}
for kind in ("counters", "gauges"):
    for name, by_labels in d[kind].items():
        if name.startswith(tuple(compared)):
            metrics[f"{{kind}}/{{name}}"] = by_labels
for name, by_labels in d["histograms"].items():
    metrics[f"histograms/{{name}}"] = {{k: v["count"]
                                       for k, v in by_labels.items()}}
exch = sum(s.labels["bytes"] for s in tel.trace.spans()
           if s.name == "exchange")
assert exch == eng.comm_stats.total()
with open(out_path, "w") as f:
    json.dump(dict(metrics=metrics, comm=dataclasses.asdict(eng.comm_stats),
                   answers=[np.asarray(answers[r]).tolist() for r in rids]),
              f)
print("JAX TRACE DONE")
"""


def _jax_params(tree) -> dict:
    return {"layers": [{key: np.asarray(a) for key, a in p.items()}
                       for p in tree["layers"]]}


def _jax_one_rank():
    """The same run on the JAX engine, 1-device Auto mesh, in process;
    returns its results and initial params."""
    import jax
    from jax.sharding import AxisType

    from repro.core.engine import DistGNNEngine as JEngine
    from repro.core.engine import EngineConfig as JConfig
    from repro.core.graph import sbm_graph as jsbm_graph
    from repro.core.serving import GNNQueryEngine as JQuery

    mesh = jax.make_mesh((1,), ("w",), axis_types=(AxisType.Auto,))
    eng = JEngine(jsbm_graph(**TRACE_GRAPH), mesh=mesh,
                  cfg=JConfig(interpret=True, **TRACE_CFG))
    tel = eng.enable_telemetry()
    state = eng.init_minibatch_state()
    init = _jax_params(state["params"])
    state, _, _ = eng.run_epoch_minibatch(NB, schedule="pipelined",
                                          state=state)
    qe = JQuery(eng, state["params"])
    rids = [qe.submit(r) for r in REQUESTS]
    answers = qe.flush()
    return dict(metrics=json.loads(json.dumps(compared_metrics(tel))),
                comm=dataclasses.asdict(eng.comm_stats),
                answers=[np.asarray(answers[r]).tolist() for r in rids]), init


def _hold_to_jax(ours, theirs):
    assert ours["metrics"] == theirs["metrics"]
    assert ours["comm"] == theirs["comm"]
    for a, b in zip(ours["answers"], theirs["answers"]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=ORACLE_TOL, rtol=0)


def test_traced_engine_contract_one_rank_equals_jax(tmp_path):
    theirs, init = _jax_one_rank()
    ours = json.loads(json.dumps(port_trace_run(str(tmp_path / "trace.json"),
                                                init)))
    _hold_to_jax(ours, theirs)
    m = ours["metrics"]
    assert m["counters/store.overlay_hit"] == {"device=0": 0}  # no remote
    assert m["gauges/layout.owned_vertices"] == {"device=0": 96}
    assert m["counters/serve.rounds"] == {"": 1}


def test_traced_process_epoch_replays_the_workers_spans():
    """The pool's epoch, traced: each worker's sample, sample_device and
    extract spans land on its own ``("sampler-proc", w)`` lane, the
    counters equal the thread epoch's, and the exchange bytes the
    CommStats total."""
    from repro_torch.core.engine import DistGNNEngine, EngineConfig
    from repro_torch.core.graph import sbm_graph

    runs = {}
    for mode in ("thread", "process"):
        eng = DistGNNEngine(sbm_graph(**TRACE_GRAPH),
                            EngineConfig(**TRACE_CFG), device=CPU)
        tel = eng.enable_telemetry()
        try:
            eng.run_epoch_minibatch(NB, "pipelined", prefetch_mode=mode)
        finally:
            eng.close_prefetch_pool()
        runs[mode] = (tel, dataclasses.asdict(eng.comm_stats),
                      eng.comm_stats.total())
    tel, comm, total = runs["process"]
    spans = tel.trace.spans()
    replayed = [s for s in spans if isinstance(s.tid, tuple)]
    assert {s.tid[0] for s in replayed} == {"sampler-proc"}
    assert {s.name for s in replayed} == {"sample", "sample_device",
                                          "extract"}
    assert {s.labels["step"] for s in replayed if s.name == "extract"} == \
        set(range(NB))
    assert sum(s.labels["bytes"] for s in spans
               if s.name == "exchange") == total
    assert compared_metrics(tel) == compared_metrics(runs["thread"][0])
    assert comm == runs["thread"][1]


def test_traced_full_graph_train_and_sweep_equal_jax():
    """`train` and the sweep, traced: one ``full_graph`` exchange a step and
    one ``inference`` exchange a sweep, their counters JAX's."""
    import jax
    from jax.sharding import AxisType

    from repro.core.engine import DistGNNEngine as JEngine
    from repro.core.engine import EngineConfig as JConfig
    from repro.core.graph import sbm_graph as jsbm_graph
    from repro_torch.core.engine import DistGNNEngine, EngineConfig
    from repro_torch.core.graph import sbm_graph

    cfg = dict(execution="p2p", partitioner="hash", hidden=8)
    mesh = jax.make_mesh((1,), ("w",), axis_types=(AxisType.Auto,))
    jeng = JEngine(jsbm_graph(**TRACE_GRAPH), mesh=mesh,
                   cfg=JConfig(interpret=True, **cfg))
    eng = DistGNNEngine(sbm_graph(**TRACE_GRAPH), EngineConfig(**cfg),
                        device=CPU)
    tels = []
    for e in (jeng, eng):
        tel = e.enable_telemetry()
        e.train(3)
        e.infer_full_graph(params=e.init_state()["params"])
        tels.append(tel)
    jtel, tel = tels
    assert compared_metrics(tel) == json.loads(json.dumps(
        compared_metrics(jtel)))
    exch = [s for s in tel.trace.spans() if s.name == "exchange"]
    assert [s.labels["stage"] for s in exch] == ["full_graph"] * 3 + [
        "inference"]
    assert sum(s.labels["bytes"] for s in exch) == eng.comm_stats.total()
    assert [s.labels["step"] for s in tel.trace.spans()
            if s.name == "train"] == [0, 1, 2]
    assert sum(s.name == "infer_sweep" for s in tel.trace.spans()) == 1
    assert [r["step"] for r in tel.run_summary()["steps"]] == [0, 1, 2]


def test_train_gnn_trace_out_one_rank(tmp_path):
    from repro_torch.launch import train_gnn

    for batching, extra in (("node_wise", ["--schedule", "pipelined"]),
                            ("full_graph", [])):
        path = tmp_path / batching / "t.json"
        res = train_gnn.main(["--device", "cpu", "--vertices", "96",
                              "--hidden", "8", "--epochs", "3", "--batching",
                              batching, "--trace-out", str(path), *extra])
        trace = json.loads(path.read_text())
        names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
        assert {"train", "exchange"} <= names, names
        steps = (tmp_path / batching / "t.json.steps.jsonl").read_text()
        assert [json.loads(line)["step"] for line in steps.splitlines()] == \
            [0, 1, 2]
        assert res["trace"]["trace"] == str(path)
        summary = res["trace"]["summary"]
        assert summary["spans"]["seconds_by_name"]["train"] > 0
        assert "layout.owned_vertices" in summary["imbalance"]["metrics"]
    assert train_gnn.trace_paths("/x/t.json", 0) == (
        "/x/t.json", "/x/t.json.steps.jsonl")
    assert train_gnn.trace_paths("/x/t.json", 3) == (
        "/x/t.rank3.json", "/x/t.rank3.json.steps.jsonl")


_RANK_CODE = """
import json, os, sys, traceback
try:
    tests, tmp, rank, world = json.loads(sys.argv[1])
    sys.path.insert(0, tests)
    import torch
    from repro_torch.core.execution import collectives
    from repro_torch.launch import train_gnn
    from test_torch_telemetry import port_trace_run
    collectives.init_group(f"file://{tmp}/rendezvous", world, rank,
                           torch.device("cpu"))
    import numpy as np
    given = np.load(f"{tmp}/init.npz")
    layers = sorted({int(key.split("/")[0]) for key in given.files})
    params = {"layers": [{key.split("/")[1]: given[key] for key in given.files
                          if key.startswith(f"{l}/")} for l in layers]}
    res = port_trace_run(f"{tmp}/contract{rank}.json", params)
    collectives.destroy_group()
    main = train_gnn.main([
        "--device", "cpu", "--world-size", str(world), "--rank", str(rank),
        "--init-method", f"file://{tmp}/train", "--vertices", "90",
        "--hidden", "8", "--epochs", "2", "--batching", "node_wise",
        "--trace-out", f"{tmp}/t.json"])
    res["main_trace"] = main["trace"]["trace"]
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(res, f)
except BaseException:
    traceback.print_exc()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(1)
"""


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The port's traced run on 4 gloo ranks and JAX's on 4 forced host
    devices, run together."""
    from test_torch_distributed import _run_ranks

    import jax

    from repro.core.graph import sbm_graph as jsbm_graph
    from repro.core.models.gnn import init_gnn_params as jinit_gnn_params

    tmp = tmp_path_factory.mktemp("torch_telemetry")
    # the JAX engine's init_minibatch_state() weights, drawn here with the
    # reference's own init_gnn_params and the seed's key
    classes = int(jsbm_graph(**TRACE_GRAPH).labels.max()) + 1
    tree = jinit_gnn_params("gcn", [TRACE_GRAPH["feature_dim"], 32, classes],
                            jax.random.PRNGKey(TRACE_CFG["seed"]))
    np.savez(tmp / "init.npz", **{f"{l}/{key}": np.asarray(a)
                                  for l, p in enumerate(tree["layers"])
                                  for key, a in p.items()})
    jax_path = str(tmp / "jax.json")
    cfg = dict(TRACE_CFG, fanouts=list(TRACE_CFG["fanouts"]))
    code = _JAX_TRACE.format(args=json.dumps(
        [TRACE_GRAPH, cfg, NB, [list(r) for r in REQUESTS], list(COMPARED),
         jax_path]))
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
            [TESTS, str(tmp), r, WORLD])] for r in range(WORLD)],
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
    return dict(tmp=tmp, jax=jax_res, ranks=ranks)


@pytest.mark.parametrize("rank", range(WORLD))
def test_traced_engine_contract_four_ranks_equals_jax(four, rank):
    ours = four["ranks"][rank]
    _hold_to_jax(ours, four["jax"])
    m = ours["metrics"]
    for name in ("counters/comm.pull_bytes", "gauges/layout.owned_vertices",
                 "gauges/frontier_occupancy", "counters/store.overlay_hit"):
        assert sorted(m[name]) == [f"device={d}" for d in range(WORLD)], name
    assert sum(m["counters/store.overlay_hit"].values()) > 0


def test_four_ranks_write_their_own_traces(four):
    tmp = four["tmp"]
    want = [str(tmp / "t.json")] + [str(tmp / f"t.rank{r}.json")
                                    for r in range(1, WORLD)]
    assert [res["main_trace"] for res in four["ranks"]] == want
    for path in want:
        with open(path) as f:
            trace = json.load(f)
        assert any(e["name"] == "train" for e in trace["traceEvents"])
        with open(path + ".steps.jsonl") as f:
            assert len(f.read().splitlines()) == 2
