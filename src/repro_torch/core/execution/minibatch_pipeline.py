"""Mini-batch execution models (the port's copy of
`repro/core/execution/minibatch_pipeline.py`, survey §6.1): conventional,
factored, operator-parallel, pipelined, and P3 pull-push, as an explicit
stage scheduler with per-stage timing, so the overlap claims are
measurable.

Stage latencies are measured on the host clock from the real sampler,
extract and train callables.  ``conventional`` / ``factored`` /
``operator_parallel`` run the stages one after another and MODEL the
overlap of their lanes from the stage times (their batches, and so their
results, are the conventional schedule's); ``pipelined`` EXECUTES it: a
`PrefetchWorker` thread (`run_pipelined`) or the sampling processes of a
`ProcPrefetchPool` (`run_pipelined_process`) really build batch i+1 while
the trainer lane runs step i, and ``wall`` is the measured wall clock up
to and including the end-of-epoch device synchronize.

With an enabled ``telemetry`` (`core/telemetry.py`; default the disabled
``NULL_TELEMETRY``) every schedule records its stages as ``sample``,
``extract`` and ``train`` spans labeled with the step, and the pipelined
ones the epoch's ``finalize`` span: the producer and trainer lanes are
distinct threads, so their overlap shows as overlapping intervals on two
rows of the trace.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from repro_torch.core.telemetry import NULL_TELEMETRY


@dataclasses.dataclass
class StageTimes:
    sample: float = 0.0
    extract: float = 0.0
    train: float = 0.0
    wall: float = 0.0

    def busy(self) -> float:
        return self.sample + self.extract + self.train


def run_conventional(batch_ids: List, sample_fn, extract_fn, train_fn, *,
                     telemetry=None) -> StageTimes:
    """Sequential sample -> extract -> train per batch (DistDGL default)."""
    tel = telemetry if telemetry is not None else NULL_TELEMETRY
    t = StageTimes()
    t0 = time.perf_counter()
    for i, ids in enumerate(batch_ids):
        with tel.span("sample", step=i):
            s0 = time.perf_counter()
            mb = sample_fn(ids)
            t.sample += time.perf_counter() - s0
        with tel.span("extract", step=i):
            s0 = time.perf_counter()
            feats = extract_fn(mb)
            t.extract += time.perf_counter() - s0
        with tel.span("train", step=i):
            s0 = time.perf_counter()
            train_fn(mb, feats)
            t.train += time.perf_counter() - s0
    t.wall = time.perf_counter() - t0
    return t


def run_factored(batch_ids: List, sample_fn, extract_fn, train_fn, *,
                 telemetry=None) -> StageTimes:
    """GNNLab factored model: a sampler lane and a trainer lane; the sampler
    works ahead (here: every batch first).  Wall = max(sampler lane,
    trainer lane) + the pipeline fill."""
    tel = telemetry if telemetry is not None else NULL_TELEMETRY
    t = StageTimes()
    prepared = []
    for i, ids in enumerate(batch_ids):  # sampler lane
        with tel.span("sample", step=i):
            s0 = time.perf_counter()
            prepared.append(sample_fn(ids))
            t.sample += time.perf_counter() - s0
    for i, mb in enumerate(prepared):  # trainer lane (extract + train)
        with tel.span("extract", step=i):
            s0 = time.perf_counter()
            feats = extract_fn(mb)
            t.extract += time.perf_counter() - s0
        with tel.span("train", step=i):
            s0 = time.perf_counter()
            train_fn(mb, feats)
            t.train += time.perf_counter() - s0
    # modeled overlap: the two lanes run concurrently on separate resources
    t.wall = (max(t.sample, t.extract + t.train)
              + min(t.sample, t.extract + t.train) / max(len(batch_ids), 1))
    return t


def run_operator_parallel(batch_ids: List, sample_fn, extract_fn, train_fn,
                          lanes: int = 2, *, telemetry=None) -> StageTimes:
    """ByteGNN/DSP operator-parallel: stages of different batches overlap as
    a DAG; with ``lanes`` lanes the wall approaches busy / lanes, bounded
    by the longest stage."""
    t = run_conventional(batch_ids, sample_fn, extract_fn, train_fn,
                         telemetry=telemetry)
    t.wall = max(max(t.sample, t.extract, t.train), t.busy() / lanes)
    return t


def run_pipelined(batch_ids: List, sample_fn, extract_fn, train_fn, *,
                  prefetch_depth: int = 2,
                  finalize_fn: Optional[Callable] = None,
                  telemetry=None) -> StageTimes:
    """Measured-lanes pipelined executor: the factored model made REAL.

    A `PrefetchWorker` thread runs sample_fn + extract_fn for batch i+1
    (bounded ``prefetch_depth`` batches ahead) while the trainer lane runs
    train_fn on batch i.  train_fn should DISPATCH the device step without
    blocking on its result (no per-step ``float()`` or synchronize) so the
    step, the host-to-device copy and host sampling genuinely overlap;
    ``finalize_fn`` is the end-of-epoch sync barrier (the engine's
    ``torch.cuda.synchronize``), so ``wall`` is an honest epoch time.

    Stage seconds are accumulated per lane (sample/extract on the worker
    thread, train on the trainer thread: disjoint writers, read after
    join), so ``busy() > wall`` is the direct measurement of overlap.  The
    spans of the two lanes land on two rows of the trace; the worker's
    queue depth and stalls ride `PrefetchWorker`'s own gauges."""
    from repro_torch.core.sampling.prefetch import PrefetchWorker

    tel = telemetry if telemetry is not None else NULL_TELEMETRY
    t = StageTimes()
    prod_i = [0]  # the producer thread's step counter (items run in order)

    def produce(ids):
        i = prod_i[0]
        prod_i[0] += 1
        with tel.span("sample", step=i):
            s0 = time.perf_counter()
            mb = sample_fn(ids)
            t.sample += time.perf_counter() - s0
        with tel.span("extract", step=i):
            s0 = time.perf_counter()
            feats = extract_fn(mb)
            t.extract += time.perf_counter() - s0
        return mb, feats

    t0 = time.perf_counter()
    worker = PrefetchWorker(batch_ids, produce, depth=prefetch_depth,
                            telemetry=tel)
    try:
        for train_i, (mb, feats) in enumerate(worker):
            with tel.span("train", step=train_i):
                s0 = time.perf_counter()
                train_fn(mb, feats)
                t.train += time.perf_counter() - s0
        if finalize_fn is not None:
            # the end-of-epoch device sync, counted on the trainer lane:
            # the one span that waits for the card (finalize_fn is it)
            with tel.span("finalize"):
                s0 = time.perf_counter()
                finalize_fn()
                t.train += time.perf_counter() - s0
    finally:
        worker.close()
    t.wall = time.perf_counter() - t0
    return t


def run_pipelined_process(batch_ids: List, pool, train_fn, *,
                          finalize_fn: Optional[Callable] = None,
                          telemetry=None) -> StageTimes:
    """GIL-free pipelined executor: sample+extract run in the WORKER
    PROCESSES of a `ProcPrefetchPool` (`sampling/proc_prefetch.py`), batches
    arrive through shared memory, and only train_fn runs here.

    Same lane accounting as `run_pipelined`, except the producer lane is
    measured remotely: each delivered ``meta`` carries ``sample_seconds`` /
    ``extract_seconds`` (0 for a batch the pool's LRU served).  Because the
    producers hold their own GILs, the overlap does not depend on the
    trainer releasing this process's.

    ``train_fn(item, arrays, meta)`` should dispatch without blocking;
    ``finalize_fn`` is the end-of-epoch sync, as in `run_pipelined`.  The
    pool outlives the call (workers and shm are reused across epochs):
    closing it is the owner's job.  The workers' spans arrive with each
    batch and the pool replays them onto per-worker lanes."""
    tel = telemetry if telemetry is not None else NULL_TELEMETRY
    t = StageTimes()
    t0 = time.perf_counter()
    it = pool.run(batch_ids)
    try:
        for train_i, (item, arrays, meta) in enumerate(it):
            t.sample += meta.get("sample_seconds", 0.0)
            t.extract += meta.get("extract_seconds", 0.0)
            with tel.span("train", step=train_i):
                s0 = time.perf_counter()
                train_fn(item, arrays, meta)
                t.train += time.perf_counter() - s0
        if finalize_fn is not None:
            with tel.span("finalize"):
                s0 = time.perf_counter()
                finalize_fn()
                t.train += time.perf_counter() - s0
    finally:
        it.close()
    t.wall = time.perf_counter() - t0
    return t


def pipelined_wall_model(t: StageTimes, num_batches: int) -> float:
    """Overlap-aware wall-clock model for the two-lane pipeline, held to the
    MEASURED lanes of `run_pipelined`: the lanes run concurrently, so the
    steady-state wall is the slower lane, plus the pipeline fill of one
    batch on the faster lane.  A lower bound for the measured wall
    (scheduling overheads only add), and below the blocking busy sum
    whenever both lanes do real work."""
    n = max(int(num_batches), 1)
    producer = t.sample + t.extract
    trainer = t.train
    return max(producer, trainer) + min(producer, trainer) / n


# schedule registry (`DistGNNEngine.run_epoch_minibatch` selects by name);
# every entry shares the (batch_ids, sample_fn, extract_fn, train_fn) ->
# StageTimes signature (``pipelined`` adds prefetch_depth / finalize_fn)
SCHEDULES: Dict[str, Callable] = {
    "conventional": run_conventional,
    "factored": run_factored,
    "operator_parallel": run_operator_parallel,
    "pipelined": run_pipelined,
}


@dataclasses.dataclass
class PullPushPlan:
    """P3: the first-hop aggregation runs model-parallel over column-sharded
    features (push the tiny graph, not the fat features), then switches to
    data parallel. comm_bytes compares against feature pulling."""
    graph_bytes: int
    hidden_bytes: int
    feature_bytes_baseline: int

    @property
    def saving(self) -> float:
        return 1.0 - (self.graph_bytes + self.hidden_bytes) / max(
            self.feature_bytes_baseline, 1)


def p3_plan(num_batch_vertices: int, num_batch_edges: int, feature_dim: int,
            hidden_dim: int, num_workers: int) -> PullPushPlan:
    """Byte accounting of P3 pull-push vs conventional feature pulling for one
    mini-batch (Gandhi & Iyer §5): conventional moves D-dim input features of
    every frontier vertex; P3 moves the subgraph structure + H-dim
    activations."""
    id_bytes = 8
    graph = num_batch_edges * 2 * id_bytes * (num_workers - 1) // num_workers
    hidden = num_batch_vertices * hidden_dim * 4
    feats = num_batch_vertices * feature_dim * 4 * (num_workers - 1) // num_workers
    return PullPushPlan(graph, hidden, feats)
