"""The port's producer lanes of the pipelined mini-batch epoch:
`repro_torch.core.sampling.prefetch.PrefetchWorker` (the prefetch thread)
and `repro_torch.core.sampling.proc_prefetch.ProcPrefetchPool` (the
sampling processes over a shared-memory batch ring), held to the failure
modes of the reference's `test_prefetch.py` and `test_proc_prefetch.py`,
and the pipelined executors' cost models held to the reference's number for
number.

Both lanes must never hang or orphan a thread, a process or a segment,
whichever lane dies and wherever: producer exceptions (first, middle, last
item, BaseException, and an unpicklable one, which becomes
`WorkerFailure`) relay to the consumer at their position; a consumer that
abandons the epoch while the producer is blocked on a full queue or ring
is unblocked by ``close()``; the tightest pipeline (depth 1, more workers
than slots) completes in order; an abandoned run resynchronizes the pool;
the LRU serves repeat batches without a worker; ``close()`` and
interpreter exit unlink every segment this process created (named with
its pid, under the port's prefix: the JAX tiers beside these count
``/dev/shm/repro-*`` as theirs); a worker imports no torch, jax or
`repro`; and a ring or graph the shared-memory mount cannot hold is
refused with its sizes.

This module imports numpy and the port's numpy-only modules at the top:
the pool's workers import it to unpickle its producers.  The reference is
imported inside the tests that compare with it."""
import os
import pickle
import subprocess
import sys
import threading
import time
from collections import defaultdict

import numpy as np
import pytest

from repro_torch.core.execution.minibatch_pipeline import (
    StageTimes,
    p3_plan,
    pipelined_wall_model,
    run_conventional,
    run_pipelined,
    run_pipelined_process,
)
from repro_torch.core.sampling import proc_prefetch
from repro_torch.core.sampling.prefetch import PrefetchWorker
from repro_torch.core.sampling.proc_prefetch import (
    SHM_PREFIX,
    ProcPrefetchPool,
    ProcPrefetchWorker,
    WorkerFailure,
    share_graph,
)

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")
LAYOUT = {"a": ((4,), np.dtype(np.int64)),
          "b": ((2, 3), np.dtype(np.float32))}


def _own_segments(pid=None):
    """This process's (or ``pid``'s) segments under the port's prefix:
    `_shm_name` puts the creator's pid in every name."""
    mark = f"-{(os.getpid() if pid is None else pid):x}-"
    return [f for f in os.listdir(proc_prefetch.SHM_DIR)
            if f.startswith(SHM_PREFIX) and mark in f]


def _threads():
    return sum(t.name == "prefetch-sampler" and t.is_alive()
               for t in threading.enumerate())


# -- producers the workers unpickle by qualified name ------------------------


def _produce(i):
    return ({"a": np.arange(4, dtype=np.int64) + i,
             "b": np.full((2, 3), float(i), np.float32)},
            {"item": i, "sample_seconds": 0.0, "extract_seconds": 0.0})


def _fail_at(i, at):
    if i == at:
        raise ValueError(f"boom at {i}")
    return _produce(i)


def _fail_first(i):
    return _fail_at(i, 0)


def _fail_mid(i):
    return _fail_at(i, 3)


def _fail_last(i):
    return _fail_at(i, 5)


def _fail_base(i):
    if i == 1:
        raise KeyboardInterrupt
    return _produce(i)


class _Unpicklable(Exception):
    def __init__(self):
        super().__init__("cursed")
        self.payload = lambda: None  # lambdas don't pickle


def _fail_unpicklable(i):
    if i == 2:
        raise _Unpicklable()
    return _produce(i)


_SEEN: dict = {}  # per-worker-process memory for _produce_once


def _produce_once(i):
    if i in _SEEN:
        raise RuntimeError(f"resampled item {i}")
    _SEEN[i] = True
    return _produce(i)


def _modules_probe(i):
    arrays, meta = _produce(i)
    meta["modules"] = sorted(m for m in sys.modules
                             if m.split(".")[0] in ("torch", "jax", "repro"))
    meta["pid"] = os.getpid()
    return arrays, meta


# ---------------------------------------------------------------------------
# the prefetch thread
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fail_at,n", [(0, 5), (2, 5), (4, 5)])
def test_thread_exception_relay_positions(fail_at, n):
    """A producer exception on the first, a middle or the last item surfaces
    in the consumer exactly after the preceding results, with the thread
    gone."""
    def produce(i):
        if i == fail_at:
            raise ValueError(f"boom at {i}")
        return i

    w = PrefetchWorker(range(n), produce, depth=2)
    got = []
    with pytest.raises(ValueError, match=f"boom at {fail_at}"):
        for item in w:
            got.append(item)
    assert got == list(range(fail_at))
    assert not w.alive
    w.close()  # close after a relayed failure is a no-op, not an error
    assert not w.alive


def test_thread_base_exception_relays():
    def produce(i):
        if i == 1:
            raise KeyboardInterrupt
        return i

    w = PrefetchWorker(range(3), produce, depth=1)
    it = iter(w)
    assert next(it) == 0
    with pytest.raises(KeyboardInterrupt):
        next(it)
    assert not w.alive


def test_thread_close_unblocks_producer_stuck_on_full_queue():
    """The consumer abandons at depth 1 with the producer mid-put: close()
    drains, signals and joins, in bounded time, idempotently; so does a
    close before the first item."""
    started = threading.Event()

    def produce(i):
        started.set()
        return i

    w = PrefetchWorker(range(10_000), produce, depth=1)
    assert started.wait(5.0)
    assert next(iter(w)) == 0
    t0 = time.monotonic()
    w.close()
    w.close()
    assert time.monotonic() - t0 < 5.0
    assert not w.alive
    w = PrefetchWorker(range(100), lambda i: i, depth=1)
    w.close()
    assert not w.alive
    assert _threads() == 0


def test_thread_depth1_no_deadlock_and_depth_guard():
    """The tightest pipeline, both lanes alternately slow: every item
    arrives in order; depth 0 is refused."""
    def produce(i):
        if i % 3 == 0:
            time.sleep(0.002)
        return i * 2

    w = PrefetchWorker(range(40), produce, depth=1)
    got = []
    for item in w:
        if len(got) % 4 == 0:
            time.sleep(0.002)
        got.append(item)
    assert got == [i * 2 for i in range(40)]
    w.close()
    assert not w.alive
    # the same under a very short switch interval: a lost or reordered put
    # would break the sequence
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        w = PrefetchWorker(range(2000), lambda i: i, depth=1)
        assert list(w) == list(range(2000))
        w.close()
    finally:
        sys.setswitchinterval(interval)
    assert not w.alive
    with pytest.raises(ValueError, match="depth"):
        PrefetchWorker([1], lambda i: i, depth=0)


class _Tally:
    """A telemetry stand-in: the counters and gauges `PrefetchWorker`
    records when one is attached."""
    enabled = True

    def __init__(self):
        self.counts = defaultdict(float)
        self.gauges = {}
        self._lock = threading.Lock()
        tally = self

        class _Counter:
            def __init__(self, name):
                self.name = name

            def add(self, v):
                with tally._lock:
                    tally.counts[self.name] += v

        class _Gauge:
            def __init__(self, name):
                self.name = name

            def set(self, v):
                tally.gauges[self.name] = v

        self._counter, self._gauge = _Counter, _Gauge

    def counter(self, name):
        return self._counter(name)

    def gauge(self, name):
        return self._gauge(name)


def test_thread_stall_counters_one_event_per_contiguous_stall():
    """With a telemetry attached, a stall counts once per contiguous stall
    (not once per poll), its duration on the *_seconds companion; with
    None nothing is recorded and nothing breaks."""
    tel = _Tally()
    w = PrefetchWorker(range(2), lambda i: i, depth=1, telemetry=tel)
    it = iter(w)
    time.sleep(0.35)  # item 0 queued at once; the producer stalls on item 1
    assert next(it) == 0
    time.sleep(0.35)  # and again on the sentinel
    assert next(it) == 1
    with pytest.raises(StopIteration):
        next(it)
    w.close()
    assert tel.counts["prefetch.producer_stall"] == 2
    assert 0.5 <= tel.counts["prefetch.producer_stall_seconds"] < 5.0
    tel2 = _Tally()
    w2 = PrefetchWorker(range(2), lambda i: time.sleep(0.3) or i, depth=2,
                        telemetry=tel2)
    it2 = iter(w2)
    assert (next(it2), next(it2)) == (0, 1)
    # read before the sentinel, which follows the last item at once
    events = tel2.counts["prefetch.consumer_stall"]
    secs = tel2.counts["prefetch.consumer_stall_seconds"]
    assert list(it2) == []
    w2.close()
    assert events == 2, events
    assert 0.3 <= secs < 5.0, secs
    assert "prefetch.queue_depth" in tel2.gauges
    w3 = PrefetchWorker(range(3), lambda i: i, depth=1, telemetry=None)
    assert list(w3) == [0, 1, 2]


def test_run_pipelined_joins_the_thread_when_either_lane_dies():
    """The pipelined epoch driver at depth 1: a train lane that dies
    mid-epoch propagates and leaves no live sampler thread; a sampler that
    dies does too; under a slow consumer results arrive in order."""
    calls = []

    def train(mb, feats):
        calls.append(feats)
        if len(calls) == 3:
            raise RuntimeError("device lane died")

    with pytest.raises(RuntimeError, match="device lane died"):
        run_pipelined(list(range(200)), lambda i: i, lambda mb: mb + 1,
                      train, prefetch_depth=1)
    assert calls == [1, 2, 3]

    def bad_sample(i):
        if i == 2:
            raise ValueError("sampler died")
        return i

    with pytest.raises(ValueError, match="sampler died"):
        run_pipelined(list(range(5)), bad_sample, lambda mb: mb,
                      lambda mb, feats: None)
    seen = []
    times = run_pipelined(
        list(range(20)), lambda i: i, lambda mb: mb,
        lambda mb, feats: (time.sleep(0.001), seen.append(feats)),
        finalize_fn=lambda: seen.append("end"))
    assert seen == list(range(20)) + ["end"]
    assert times.wall > 0 and times.train > 0
    deadline = time.monotonic() + 5.0
    while _threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert _threads() == 0


# ---------------------------------------------------------------------------
# the sampling-process pool
# ---------------------------------------------------------------------------


def test_pool_in_order_delivery_reuse_and_workers_import_no_torch():
    """Strict input order, the slot contents, and the SAME pool serving
    several epochs (monotone indices, the ring reused; cache_items=0 keeps
    every epoch on the ring).  The workers, forked from the forkserver
    while this process holds torch and jax, import neither, nor `repro`."""
    import torch  # noqa: F401  the parent the engine gives the pool

    pool = ProcPrefetchPool(_modules_probe, LAYOUT, depth=2, num_workers=3,
                            cache_items=0)
    pids = set()
    try:
        for _ in range(3):
            out = list(pool.run(list(range(7))))
            assert [o[0] for o in out] == list(range(7))
            for item, arrays, meta in out:
                np.testing.assert_array_equal(
                    arrays["a"], np.arange(4, dtype=np.int64) + item)
                assert arrays["b"][0, 0] == item and meta["item"] == item
                assert meta["modules"] == [], meta["modules"]
                pids.add(meta["pid"])
                arrays["a"][:] = -1  # delivered arrays are copies
        assert os.getpid() not in pids and len(pids) <= 3
        assert pool.slot_nbytes == 64 + 64  # two arrays, 64-byte aligned
    finally:
        pool.close()
    assert not pool.alive and not pool.workers_alive
    assert _own_segments() == []


def test_pool_lru_serves_repeats_without_a_worker():
    """A producer that FAILS on a repeat proves the second epoch never
    reached a worker; hits hand out copies, their producer seconds 0; a
    planned hit survives its eviction by the same epoch's misses."""
    pool = ProcPrefetchPool(_produce_once, LAYOUT, depth=2, num_workers=1)
    try:
        out1 = list(pool.run(list(range(5))))
        out2 = list(pool.run(list(range(5))))
        for (i1, a1, _), (i2, a2, m2) in zip(out1, out2):
            assert i1 == i2
            np.testing.assert_array_equal(a1["a"], a2["a"])
            assert m2["cache_hit"] and m2["sample_seconds"] == 0.0
            a2["a"][:] = -7
        assert list(pool.run(list(range(5))))[0][1]["a"][0] == 0
        out3 = list(pool.run([0, 6, 1]))
        assert [o[0] for o in out3] == [0, 6, 1]
        np.testing.assert_array_equal(out3[2][1]["a"],
                                      np.arange(4, dtype=np.int64) + 1)
        assert len(pool._cache) <= pool.cache_items
    finally:
        pool.close()
    pool = ProcPrefetchPool(_produce, LAYOUT, depth=1, num_workers=1,
                            cache_items=1)
    try:
        list(pool.run([0, 1]))  # cache = {1}
        out = list(pool.run([1, 0, 1]))  # miss 0 evicts 1 mid-epoch
        assert [o[0] for o in out] == [1, 0, 1]
        np.testing.assert_array_equal(out[2][1]["a"],
                                      np.arange(4, dtype=np.int64) + 1)
    finally:
        pool.close()
    assert _own_segments() == []


@pytest.mark.parametrize("workers", [3, (os.cpu_count() or 1) + 1],
                         ids=["3", "cores+1"])
def test_pool_depth1_more_workers_than_slots_no_deadlock(workers):
    """The tightest ring with more workers than slots, and with more
    workers than cores: the released-counter protocol keeps the writer of
    the next-released index unblocked, every batch arrives in order with
    its own contents, and the whole epoch ends in bounded time."""
    pool = ProcPrefetchPool(_produce, LAYOUT, depth=1, num_workers=workers,
                            cache_items=0)
    t0 = time.monotonic()
    try:
        out = list(pool.run(list(range(4 * workers))))
        assert [o[0] for o in out] == list(range(4 * workers))
        for item, arrays, _ in out:
            np.testing.assert_array_equal(
                arrays["a"], np.arange(4, dtype=np.int64) + item)
        assert time.monotonic() - t0 < 60.0
    finally:
        pool.close()
    assert _own_segments() == []


@pytest.mark.parametrize("produce,at,n", [(_fail_first, 0, 5),
                                          (_fail_mid, 3, 6),
                                          (_fail_last, 5, 6)],
                         ids=["first", "mid", "last"])
def test_pool_exception_relayed_at_batch_index(produce, at, n):
    pool = ProcPrefetchPool(produce, LAYOUT, depth=2, num_workers=2)
    got = []
    try:
        with pytest.raises(ValueError, match=f"boom at {at}"):
            for item, _, _ in pool.run(list(range(n))):
                got.append(item)
        assert got == list(range(at))
    finally:
        pool.close()
    assert _own_segments() == []


def test_pool_base_and_unpicklable_exceptions_relay():
    """KeyboardInterrupt in a worker reaches the consumer; an exception
    that cannot cross the process boundary arrives as a WorkerFailure
    carrying the remote traceback."""
    pool = ProcPrefetchPool(_fail_base, LAYOUT, depth=1, num_workers=2)
    try:
        it = pool.run(list(range(3)))
        assert next(it)[0] == 0
        with pytest.raises(KeyboardInterrupt):
            next(it)
    finally:
        pool.close()
    pool = ProcPrefetchPool(_fail_unpicklable, LAYOUT, depth=2, num_workers=1)
    try:
        with pytest.raises(WorkerFailure, match="cursed") as ei:
            list(pool.run(list(range(4))))
        assert "remote traceback" in str(ei.value)
    finally:
        pool.close()
    assert _own_segments() == []


def test_pool_close_unblocks_a_full_ring_and_an_abandoned_run_resyncs():
    """The consumer abandons with workers blocked on the full ring: close()
    stops, joins and unlinks in bounded time, idempotently.  An abandoned
    run() on a live pool drains, and the next epoch is clean."""
    w = ProcPrefetchWorker(list(range(10_000)), _produce, LAYOUT, depth=1,
                           num_workers=2)
    assert next(iter(w))[0] == 0
    t0 = time.monotonic()
    w.close()
    w.close()
    assert time.monotonic() - t0 < 10.0
    assert not w.alive
    pool = ProcPrefetchPool(_produce, LAYOUT, depth=2, num_workers=2)
    try:
        it = pool.run(list(range(6)))
        assert next(it)[0] == 0
        it.close()  # abandon with 5 outstanding
        assert [o[0] for o in pool.run(list(range(4)))] == list(range(4))
        out = run_pipelined_process([7, 8], pool, lambda *a: None)
        assert out.wall > 0 and out.sample == 0.0
    finally:
        pool.close()
    assert _own_segments() == []


def test_pool_validation_and_shm_room():
    """The reference's guards, and the shared-memory room: a ring or a
    graph the mount cannot hold is refused with its sizes before any
    segment is made."""
    with pytest.raises(ValueError, match="depth"):
        ProcPrefetchPool(_produce, LAYOUT, depth=0)
    with pytest.raises(ValueError, match="num_sample_workers"):
        ProcPrefetchPool(_produce, LAYOUT, num_workers=0)
    with pytest.raises(ValueError, match="cache_items"):
        ProcPrefetchPool(_produce, LAYOUT, cache_items=-1)
    pool = ProcPrefetchPool(_produce, LAYOUT, depth=1, num_workers=1)
    it = pool.run([0])
    with pytest.raises(RuntimeError, match="one run"):
        pool.run([1])
    list(it)
    pool.close()
    with pytest.raises(RuntimeError, match="closed"):
        pool.run([2])
    assert proc_prefetch.shm_free_bytes() > 0
    big = {"adj0": ((1, 1 << 20, 1 << 20), np.dtype(np.float32))}
    with pytest.raises(OSError, match=f"2 slots of {4 << 40} bytes"):
        ProcPrefetchPool(_produce, big, depth=2, num_workers=1)
    from repro_torch.core.graph import sbm_graph

    g = sbm_graph(64, num_blocks=4, p_in=0.1, p_out=0.02, seed=0)
    saved = proc_prefetch.SHM_DIR
    proc_prefetch.SHM_DIR = os.path.join(TESTS, "no-such-mount")
    try:  # no mount to read: nothing to refuse
        assert proc_prefetch.shm_free_bytes() is None
        proc_prefetch.require_shm(1 << 60, "anything")
    finally:
        proc_prefetch.SHM_DIR = saved
    need = proc_prefetch.graph_shm_nbytes(g)
    assert need == (g.indptr.nbytes + g.indices.nbytes + g.labels.nbytes
                    + g.train_mask.nbytes)
    with pytest.raises(OSError, match="the shared graph needs"):
        proc_prefetch.require_shm(proc_prefetch.shm_free_bytes() + 1,
                                  "the shared graph")
    assert _own_segments() == []


def test_share_graph_round_trip():
    """share_graph -> materialize reproduces the graph read-only, and a
    pickled handle attaches in another process's place (the pickle holds
    names, not arrays)."""
    from repro_torch.core.graph import sbm_graph

    g = sbm_graph(64, num_blocks=4, p_in=0.1, p_out=0.02, seed=0)
    shared, arena = share_graph(g)
    try:
        assert len(_own_segments()) == 4
        blob = pickle.dumps(shared)
        assert len(blob) < 2048
        for handle in (shared, pickle.loads(blob)):
            g2 = handle.materialize()
            for name in ("indptr", "indices", "labels", "train_mask"):
                np.testing.assert_array_equal(getattr(g2, name),
                                              getattr(g, name))
            assert g2.num_vertices == g.num_vertices
            assert g2.features is None
            assert not g2.indices.flags.writeable
            del g2
    finally:
        arena.close()
    assert _own_segments() == []


def test_fresh_interpreter_imports_and_lifecycle():
    """In a fresh interpreter: importing the producer modules leaves torch,
    jax and `repro` out of sys.modules; a pool's whole lifecycle, and a
    second pool reclaimed by GC only, exit with no resource-tracker
    warning and none of that process's segments left."""
    code = """
import os, sys
import repro_torch.core.sampling.host_batch
import repro_torch.core.sampling.prefetch
import repro_torch.core.sampling.proc_prefetch
leaked = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'repro')]
assert not leaked, leaked
print('PURE')
# the producer lives in an importable module: the workers unpickle it
from test_torch_prefetch import LAYOUT, _produce
from repro_torch.core.sampling.proc_prefetch import ProcPrefetchPool

pool = ProcPrefetchPool(_produce, LAYOUT, depth=2, num_workers=2)
assert [o[0] for o in pool.run(list(range(5)))] == list(range(5))
pool.close()
pool2 = ProcPrefetchPool(_produce, LAYOUT, depth=1, num_workers=1)
next(iter(pool2.run(list(range(3)))))
del pool2
print('LIFECYCLE_OK', os.getpid())
"""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + TESTS)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "PURE" in proc.stdout and "LIFECYCLE_OK" in proc.stdout
    assert "leaked shared_memory" not in proc.stderr, proc.stderr
    assert "KeyError" not in proc.stderr, proc.stderr
    pid = int(proc.stdout.split("LIFECYCLE_OK")[1].split()[0])
    assert _own_segments(pid) == []


# ---------------------------------------------------------------------------
# the executors' cost models against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lanes", [(0.3, 0.1, 0.2), (0.01, 0.0, 2.5),
                                   (0.0, 0.0, 0.0), (1.5, 2.25, 0.125)])
def test_wall_model_and_p3_plan_match_the_reference(lanes):
    from repro.core.execution import minibatch_pipeline as ref

    sample, extract, train = lanes
    for n in (0, 1, 5, 64):
        ours = pipelined_wall_model(StageTimes(sample, extract, train, 9.0), n)
        theirs = ref.pipelined_wall_model(
            ref.StageTimes(sample, extract, train, 9.0), n)
        assert ours == theirs
        assert ours <= sample + extract + train or n == 0
    for args in ((1000, 5000, 602, 64, 8), (1000, 5000, 16, 64, 8),
                 (67584, 1081344, 256, 256, 4), (7, 3, 1, 1, 1)):
        ours, theirs = p3_plan(*args), ref.p3_plan(*args)
        assert (ours.graph_bytes, ours.hidden_bytes,
                ours.feature_bytes_baseline) == (
            theirs.graph_bytes, theirs.hidden_bytes,
            theirs.feature_bytes_baseline)
        assert ours.saving == theirs.saving


def test_wall_model_against_measured_lanes():
    """With sleeping (GIL-releasing) stages the pipelined executor lands
    below the blocking serial sum and not far below the model's two-lane
    bound, with busy() > wall: the lanes really overlapped."""
    ids = list(range(6))
    sample = lambda i: time.sleep(0.008) or i  # noqa: E731
    extract = lambda mb: time.sleep(0.002) or mb  # noqa: E731
    train = lambda mb, f: time.sleep(0.012)  # noqa: E731
    blocking = run_conventional(ids, sample, extract, train)
    piped = run_pipelined(ids, sample, extract, train, prefetch_depth=2)
    model = pipelined_wall_model(piped, len(ids))
    assert piped.wall < 0.9 * blocking.wall, (piped.wall, blocking.wall)
    assert piped.wall >= 0.8 * model, (piped.wall, model)
    assert piped.busy() > piped.wall
