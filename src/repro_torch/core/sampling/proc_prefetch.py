"""GIL-free batch prefetch (the port's copy of
`repro/core/sampling/proc_prefetch.py`): a process pool producing into a
shared-memory ring (survey §6.1 pipelining without the thread sampler's
GIL fight).

The thread `PrefetchWorker` overlaps host sampling with the device step, but
both lanes share one GIL: the sampler's Python loops and the trainer's
dispatch take turns.  `ProcPrefetchPool` moves the producer into worker
*processes* (DGL `multiprocessing/pytorch.py` idiom): the GIL is
per-process, so sampling overlaps the trainer unconditionally and fans out
across cores.

Data never rides a pickle:

* big read-only inputs (the graph's CSR arrays and labels) go into POSIX
  shared memory ONCE: `share_graph` publishes a `Graph` and workers attach
  read-only at first use (`SharedGraph.materialize`);
* finished batches land in a ring of ``depth`` shared-memory slots sized
  from the producer's static `array_layout()`; only a small metadata dict
  crosses the mp.Queue per batch.

Ring protocol (deadlock-free by construction): batch index ``i`` always
writes slot ``i % depth``, and a worker may write only once
``i < released + depth`` (a shared counter + Condition).  The consumer
delivers strictly in input order, copies the arrays out, and releases the
slot immediately, so release order == index order, and with any
``num_workers`` and ``depth >= 1`` the writer of the next-released index is
never blocked by a later one.

Contracts (mirroring the thread `PrefetchWorker`):

* strict in-order delivery: with deterministic producers a pooled epoch is
  bitwise-identical to a blocking one;
* a producer exception is re-raised in the consumer at the position it
  occurred (relayed across the process boundary);
* `close()` always stops workers, joins them, and closes and unlinks every
  shm segment, including when the CONSUMER dies mid-epoch while workers are
  blocked on a full ring; a GC / interpreter-exit finalizer guarantees the
  unlink even if close() is never called;
* a pool or a shared graph that the shared-memory mount cannot hold is
  refused up front with the sizes (`require_shm`): tmpfs maps a segment
  lazily, and a write past the mount's size kills the writer with SIGBUS.

Segment names start with ``SHM_PREFIX`` and carry the creating process's
pid, so a process can find its own segments under ``/dev/shm``.  The module
is numpy-only (its import chain too): a worker never imports torch.
With an enabled `core.telemetry.Telemetry` attached the pool records its
stall counters and ring gauges and replays each worker's sample and extract
spans (timed on the shared CLOCK_MONOTONIC timeline) onto the parent's
tracer as a ``("sampler-proc", rank)`` lane; with None they are skipped.
"""
from __future__ import annotations

import contextlib
import dataclasses
import errno
import multiprocessing as mp
import os
import pickle
import queue
import time
import traceback
import uuid
import weakref
from collections import OrderedDict
from multiprocessing import shared_memory
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import Graph

_ALIGN = 64  # slot-internal array alignment (cache line)
SHM_PREFIX = "rtorch-"  # every segment this module creates
SHM_DIR = "/dev/shm"  # where Linux keeps POSIX shared memory


# ---------------------------------------------------------------------------
# shared-memory plumbing
# ---------------------------------------------------------------------------


def _attach_shm(name: str) -> shared_memory.SharedMemory:
    """Attach to an existing segment.  Python <= 3.12 re-registers attached
    segments with the resource tracker as if the attacher owned them — but
    every process in this pool (any start method) shares the PARENT's tracker
    process, whose per-type cache is a set: the child's register is a
    duplicate no-op, and the single unregister fired by the parent's
    `unlink()` leaves the set clean.  So: no child-side unregister (that
    would steal the parent's registration and make the later unlink
    KeyError inside the tracker), and no "leaked shared_memory" warnings
    as long as the owning arena really unlinks — which tests assert."""
    return shared_memory.SharedMemory(name=name)


def _shm_name(tag: str) -> str:
    return f"{SHM_PREFIX}{tag}-{os.getpid():x}-{uuid.uuid4().hex[:12]}"


def shm_free_bytes() -> Optional[int]:
    """Free bytes of the shared-memory mount; None where there is none to
    read (no ``SHM_DIR``)."""
    try:
        st = os.statvfs(SHM_DIR)
    except OSError:
        return None
    return int(st.f_bavail) * int(st.f_frsize)


def require_shm(nbytes: int, what: str) -> None:
    """Refuse ``what`` when the shared-memory mount has less than ``nbytes``
    free: a segment is sized by ftruncate, which succeeds past the mount's
    size, and the first write beyond it is a SIGBUS."""
    free = shm_free_bytes()
    if free is not None and int(nbytes) > free:
        raise OSError(
            errno.ENOSPC,
            f"{what} needs {int(nbytes)} bytes of shared memory and "
            f"{SHM_DIR} has {free} bytes free: give the mount more room "
            f"(a container's --shm-size), or lower the depth or the batch")


@dataclasses.dataclass(frozen=True)
class SharedArrayRef:
    """Picklable handle to one numpy array living in a shm segment."""

    name: str
    shape: Tuple[int, ...]
    dtype: str


class _ShmArena:
    """Owner-side registry of created segments: close+unlink exactly once,
    from close() or the GC finalizer."""

    def __init__(self):
        self.segments: List[shared_memory.SharedMemory] = []

    def share(self, arr: np.ndarray, tag: str) -> SharedArrayRef:
        arr = np.ascontiguousarray(arr)
        shm = shared_memory.SharedMemory(
            create=True, size=max(int(arr.nbytes), 1), name=_shm_name(tag))
        self.segments.append(shm)
        view = np.ndarray(arr.shape, arr.dtype, buffer=shm.buf)
        view[...] = arr
        return SharedArrayRef(shm.name, tuple(arr.shape), str(arr.dtype))

    def create(self, nbytes: int, tag: str) -> shared_memory.SharedMemory:
        shm = shared_memory.SharedMemory(
            create=True, size=max(int(nbytes), 1), name=_shm_name(tag))
        self.segments.append(shm)
        return shm

    def close(self):
        segs, self.segments = self.segments, []
        for shm in segs:
            try:
                shm.close()
            except Exception:
                pass
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
            except Exception:
                pass


class SharedGraph:
    """Picklable handle to a `Graph`'s host arrays in POSIX shared memory.

    Workers call `materialize()` once at init to attach read-only views and
    rebuild a `Graph` around them — the CSR arrays are mapped, not copied,
    so k workers cost one graph, not k.  Features are deliberately absent:
    the host stages never read them (byte accounting needs only the feature
    DIM, carried by `HostBatchBuilder.feature_dim`)."""

    def __init__(self, refs: Dict[str, Optional[SharedArrayRef]],
                 num_vertices: int):
        self._refs = refs
        self._num_vertices = int(num_vertices)

    def __getstate__(self):
        return {"refs": self._refs, "num_vertices": self._num_vertices}

    def __setstate__(self, state):
        self._refs = state["refs"]
        self._num_vertices = state["num_vertices"]

    def materialize(self) -> Graph:
        handles = []

        def attach(ref: Optional[SharedArrayRef]):
            if ref is None:
                return None
            shm = _attach_shm(ref.name)
            handles.append(shm)  # keep the mapping alive with the Graph
            a = np.ndarray(ref.shape, np.dtype(ref.dtype), buffer=shm.buf)
            a.flags.writeable = False
            return a

        g = Graph(indptr=attach(self._refs["indptr"]),
                  indices=attach(self._refs["indices"]),
                  num_vertices=self._num_vertices,
                  labels=attach(self._refs["labels"]),
                  train_mask=attach(self._refs["train_mask"]))
        g._shm_handles = handles  # noqa: SLF001 — lifetime anchor
        return g


def share_graph(g: Graph) -> Tuple[SharedGraph, _ShmArena]:
    """Publish the host-stage-relevant arrays of ``g`` into shared memory.
    Returns (picklable handle, owner arena) — the caller owns the arena and
    must `close()` it (the pool does, when built via its ``shared_inputs``)."""
    arrays = dict(indptr=g.indptr, indices=g.indices, labels=g.labels,
                  train_mask=g.train_mask)
    require_shm(graph_shm_nbytes(g), "the shared graph")
    arena = _ShmArena()

    def share(arr, tag):
        return None if arr is None else arena.share(np.asarray(arr), tag)

    tags = dict(indptr="csr", indices="csr", labels="lab", train_mask="msk")
    refs = {name: share(a, tags[name]) for name, a in arrays.items()}
    return SharedGraph(refs, g.num_vertices), arena


def graph_shm_nbytes(g: Graph) -> int:
    """Bytes `share_graph` puts in shared memory for ``g``."""
    return sum(int(np.asarray(a).nbytes) for a in (
        g.indptr, g.indices, g.labels, g.train_mask) if a is not None)


def _slot_layout(layout: Dict[str, Tuple[Tuple[int, ...], np.dtype]]
                 ) -> Tuple[int, Dict[str, Tuple[int, Tuple[int, ...],
                                                 np.dtype]]]:
    """(slot_nbytes, name -> (offset, shape, dtype)) for one ring slot."""
    off = 0
    table = {}
    for name in sorted(layout):
        shape, dtype = layout[name]
        dtype = np.dtype(dtype)
        table[name] = (off, tuple(int(s) for s in shape), dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        off += (nbytes + _ALIGN - 1) // _ALIGN * _ALIGN
    return max(off, 1), table


def _slot_views(buf, table) -> Dict[str, np.ndarray]:
    return {name: np.ndarray(shape, dtype, buffer=buf, offset=off)
            for name, (off, shape, dtype) in table.items()}


# ---------------------------------------------------------------------------
# worker process
# ---------------------------------------------------------------------------


class WorkerFailure(RuntimeError):
    """Raised in the consumer when a producer exception could not itself be
    pickled across the process boundary; carries the remote traceback."""


def _relayable(exc: BaseException, tb: str) -> BaseException:
    """The exception object itself when it pickles, else a WorkerFailure
    wrapping the remote traceback (the relay queue must never die trying)."""
    try:
        pickle.loads(pickle.dumps(exc))
        return exc
    except Exception:
        return WorkerFailure(
            f"unpicklable producer exception {type(exc).__name__}: {exc}\n"
            f"--- remote traceback ---\n{tb}")


def _produce_one(rank, produce, views, depth, idx, item, released, cond,
                 stop, ready_q) -> None:
    """Produce one batch into slot ``idx % depth`` and post its metadata."""
    pool_meta = dict(worker=rank, stall_events=0, stall_seconds=0.0)
    try:
        arrays, meta = produce(item)
    except BaseException as exc:  # noqa: BLE001 — relayed
        ready_q.put(("exc", idx, item,
                     _relayable(exc, traceback.format_exc())))
        return
    # ring backpressure: slot i % depth is ours once i < released + depth;
    # released advances in index order, so the wait is FIFO
    stalled_at = None
    with cond:
        while not stop.is_set() and idx - released.value >= depth:
            if stalled_at is None:
                stalled_at = time.perf_counter()
                pool_meta["stall_events"] = 1
            cond.wait(timeout=0.05)
    if stalled_at is not None:
        pool_meta["stall_seconds"] = time.perf_counter() - stalled_at
    if stop.is_set():
        return
    slot = views[idx % depth]
    for name, a in arrays.items():
        np.copyto(slot[name], a, casting="no")
    meta = dict(meta)
    meta["_pool"] = pool_meta
    ready_q.put(("ok", idx, item, meta))


def _worker_main(rank: int, produce: Callable, slot_names: Sequence[str],
                 table, task_q, ready_q, released, cond, stop) -> None:
    """One sampling worker: pull chunks of (idx, item) tasks, produce each,
    wait for slot ``idx % depth``'s turn, write arrays, post metadata.

    Tasks arrive as CHUNKS (lists of (idx, item) pairs) so an epoch costs
    O(chunks) queue round-trips, not O(batches)."""
    depth = len(slot_names)
    slots = [_attach_shm(n) for n in slot_names]
    views = [_slot_views(s.buf, table) for s in slots]
    try:
        while not stop.is_set():
            try:
                chunk = task_q.get(timeout=0.1)
            except queue.Empty:
                continue
            if chunk is None:
                break
            for idx, item in chunk:
                if stop.is_set():
                    break
                _produce_one(rank, produce, views, depth, idx, item,
                             released, cond, stop, ready_q)
    finally:
        for s in slots:
            s.close()


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _suppress_main_fixup():
    """Stop forkserver/spawn children from re-running ``__main__``.

    `spawn.get_preparation_data` ships the parent's main-module spec/path so
    the child can recreate it — pointless here (workers run the importable
    `_worker_main` and the pickled `produce`; nothing resolves against
    ``__mp_main__``) and actively harmful: it crashes under stdin-driven
    parents (``__file__ == '<stdin>'``) and re-imports the whole test
    harness under pytest.  Hiding ``__spec__``/``__file__`` for the brief
    single-threaded Process.start() window makes preparation skip the main
    fixup entirely."""
    import __main__ as main_mod

    saved = {}
    for attr in ("__spec__", "__file__"):
        if hasattr(main_mod, attr):
            saved[attr] = getattr(main_mod, attr)
            setattr(main_mod, attr, None) if attr == "__spec__" else \
                delattr(main_mod, attr)
    try:
        yield
    finally:
        for attr, val in saved.items():
            setattr(main_mod, attr, val)


def _default_context() -> mp.context.BaseContext:
    """forkserver when the platform has it, else spawn.  Never fork: the
    parent that owns the pool also owns a CUDA context, which a forked
    child cannot use, and forking a multithreaded process can deadlock the
    child on a lock some other thread held at fork time.  The forkserver
    process is itself spawn-started single-threaded, so the per-worker
    forks it serves are safe AND cheap (no torch import: workers inherit
    the server's numpy-only image; `produce` must pickle by qualified name,
    which `HostBatchBuilder.produce` does, carrying a `SharedGraph` handle
    instead of the graph)."""
    try:
        return mp.get_context("forkserver")
    except ValueError:  # pragma: no cover — non-POSIX
        return mp.get_context("spawn")


def _shutdown(procs, stop, cond, task_q, ready_q, arena, extra_arenas):
    """The one shutdown path (close() and the GC finalizer): wake everyone,
    drain, join, terminate stragglers, then unlink every owned segment."""
    stop.set()
    try:
        with cond:
            cond.notify_all()
    except Exception:
        pass
    for _ in procs:
        try:
            task_q.put_nowait(None)
        except Exception:
            break
    deadline = time.perf_counter() + 5.0
    for p in procs:
        try:
            # keep the ready queue drained so a worker blocked on its feeder
            # thread (queue full) can exit
            while True:
                try:
                    ready_q.get_nowait()
                except queue.Empty:
                    break
            p.join(timeout=max(0.05, deadline - time.perf_counter()))
            if p.is_alive():
                p.terminate()
                p.join(timeout=1.0)
        except Exception:
            pass
    for q_ in (task_q, ready_q):
        try:
            # never join the feeder: undrained tasks mean a full pipe with
            # no reader left, and join_thread() would wait on it forever
            q_.cancel_join_thread()
            q_.close()
        except Exception:
            pass
    arena.close()
    for a in extra_arenas:
        a.close()


class ProcPrefetchPool:
    """Persistent sampling-process pool over a shared-memory batch ring.

    ``produce(item) -> (arrays, meta)`` runs in the workers; ``layout`` is
    the static name -> (shape, dtype) contract sizing the ring slots (e.g.
    `HostBatchBuilder.array_layout()`).  The callable must pickle (default
    forkserver/spawn contexts — see `_default_context`).  ``shared_inputs``
    takes ownership of arenas whose segments (e.g. `share_graph`'s) must
    outlive the workers — they are unlinked on close().

    One epoch = ``run(items)``: an iterator of (item, arrays, meta) in input
    order.  The pool survives across runs (workers and shm are reused), so
    process startup is paid once, not per epoch.

    ``cache_items`` bounds an LRU of finished batches keyed by item.  The
    engine's sampling is DETERMINISTIC in (seed, step, device) — a batch is
    a pure function of its item — so serving a repeat item from the cache
    is bitwise-identical to reproducing it, and a repeat epoch skips both
    the sampling work and the IPC round-trip (the epoch-to-epoch sample
    reuse that arXiv:2105.02315 argues sampled training should exploit).
    Set 0 for producers that are NOT pure functions of their item."""

    def __init__(self, produce: Callable, layout, depth: int = 2,
                 num_workers: int = 2, telemetry=None,
                 mp_context: Optional[str] = None,
                 shared_inputs: Sequence[_ShmArena] = (),
                 cache_items: int = 64):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        if num_workers < 1:
            raise ValueError(
                f"num_sample_workers must be >= 1, got {num_workers}")
        if cache_items < 0:
            raise ValueError(
                f"cache_items must be >= 0, got {cache_items}")
        self._tel = (telemetry if telemetry is not None
                     and getattr(telemetry, "enabled", False) else None)
        ctx = (mp.get_context(mp_context) if mp_context
               else _default_context())
        self.depth = depth
        self.num_workers = num_workers
        self.cache_items = cache_items
        self._cache: "OrderedDict" = OrderedDict()
        nbytes, self._table = _slot_layout(layout)
        require_shm(depth * nbytes,
                    f"the batch ring ({depth} slots of {nbytes} bytes)")
        self.slot_nbytes = nbytes
        self._arena = _ShmArena()
        self._slots = [self._arena.create(nbytes, f"ring{i}")
                       for i in range(depth)]
        self._slot_views = [_slot_views(s.buf, self._table)
                            for s in self._slots]
        self._task_q = ctx.Queue()
        self._ready_q = ctx.Queue()
        self._stop = ctx.Event()
        self._released = ctx.Value("l", 0, lock=False)
        self._cond = ctx.Condition()
        self._next_idx = 0  # global monotone batch index across runs
        self._run_active = False
        self._procs = [
            ctx.Process(
                target=_worker_main,
                args=(r, produce, [s.name for s in self._slots], self._table,
                      self._task_q, self._ready_q, self._released, self._cond,
                      self._stop),
                name=f"proc-prefetch-{r}", daemon=True)
            for r in range(num_workers)]
        with _suppress_main_fixup():
            for p in self._procs:
                p.start()
        # guaranteed cleanup: shm segments are system-global, so unlinking
        # must not depend on close() being reached on every path
        self._finalizer = weakref.finalize(
            self, _shutdown, self._procs, self._stop, self._cond,
            self._task_q, self._ready_q, self._arena, tuple(shared_inputs))

    # -- epoch driver ------------------------------------------------------

    def run(self, items: Sequence) -> "_RunIterator":
        if not self.alive:
            raise RuntimeError("ProcPrefetchPool is closed")
        if self._run_active:
            raise RuntimeError("one run() at a time per pool")
        self._run_active = True
        return _RunIterator(self, list(items))

    def _release_through(self, idx: int) -> None:
        with self._cond:
            self._released.value = idx + 1
            self._cond.notify_all()

    # -- the finished-batch LRU (see class docstring) ----------------------

    def _cache_get(self, item) -> Optional[Tuple[Dict, Dict]]:
        if self.cache_items <= 0:
            return None
        try:
            hit = self._cache.get(item)
        except TypeError:  # unhashable items are simply never cached
            return None
        if hit is not None:
            self._cache.move_to_end(item)
        return hit

    def _cache_put(self, item, arrays: Dict, meta: Dict) -> None:
        if self.cache_items <= 0:
            return
        try:
            hash(item)
        except TypeError:
            return
        # private copies; lane seconds zeroed — a future hit does NO
        # sampling work, and its meta should say so
        m = {k: v for k, v in meta.items() if k not in ("spans", "_pool")}
        for k in ("sample_seconds", "extract_seconds"):
            if k in m:
                m[k] = 0.0
        m["cache_hit"] = True
        self._cache[item] = ({k: v.copy() for k, v in arrays.items()}, m)
        while len(self._cache) > self.cache_items:
            self._cache.popitem(last=False)

    # -- lifecycle ---------------------------------------------------------

    def close(self):
        """Idempotent: stop + join workers, close + UNLINK all shm."""
        self._finalizer()

    @property
    def alive(self) -> bool:
        return self._finalizer.alive

    @property
    def workers_alive(self) -> bool:
        return any(p.is_alive() for p in self._procs)


class _RunIterator:
    """In-order consumer for one epoch: reorder-buffers ready metadata,
    copies arrays out of the slot, releases it, yields (item, arrays, meta).

    The copy is deliberate: the engine hands the arrays to
    ``torch.from_numpy``, which ALIASES host numpy buffers (and on the CPU
    ``.to("cpu")`` keeps the alias): a view into a ring slot would be
    overwritten two batches later.  One memcpy per batch is orders
    of magnitude cheaper than the pickle round-trip it replaces."""

    def __init__(self, pool: ProcPrefetchPool, items: List):
        self._pool = pool
        self._items = items
        self._pos = 0
        self._pending: Dict[int, Tuple] = {}
        self._failed = False
        # per-epoch plan: a cache HIT pins its payload here (immune to LRU
        # eviction by this epoch's own misses) and gets no ring index;
        # misses take the next CONSECUTIVE indices (the released-counter
        # protocol needs a gap-free index sequence — slot = idx % depth)
        self._plan: List[Tuple[Optional[int], Optional[Tuple]]] = []
        tasks = []
        for item in items:
            hit = pool._cache_get(item)
            if hit is not None:
                self._plan.append((None, hit))
            else:
                idx = pool._next_idx
                pool._next_idx += 1
                self._plan.append((idx, None))
                tasks.append((idx, item))
        self._expected = tasks[0][0] if tasks else pool._next_idx
        self._end = pool._next_idx
        # chunked submission: ~2 chunks per worker costs O(workers) queue
        # round-trips per epoch instead of O(batches); the ring still paces
        # item-by-item, so depth and in-order delivery are unaffected
        step = max(1, -(-len(tasks) // max(1, 2 * pool.num_workers)))
        for lo in range(0, len(tasks), step):
            pool._task_q.put(tasks[lo:lo + step])

    def __iter__(self):
        return self

    def _poll(self, block: bool) -> bool:
        """Pull one ready message into the reorder buffer. False on timeout."""
        try:
            kind, idx, item, payload = self._pool._ready_q.get(
                timeout=0.1 if block else 0.0)
        except queue.Empty:
            return False
        self._pending[idx] = (kind, item, payload)
        return True

    def __next__(self):
        pool = self._pool
        if self._pos >= len(self._plan):
            self._finish()
            raise StopIteration
        tel = pool._tel
        item = self._items[self._pos]
        plan_idx, pinned = self._plan[self._pos]
        if plan_idx is None:  # cache hit: no ring round-trip
            self._pos += 1
            arrays, meta = pinned
            if tel is not None:
                tel.counter("proc_prefetch.cache_hit").add(1)
            if self._pos >= len(self._plan):
                self._finish()
            # consumers may mutate delivered arrays — hand out copies
            return item, {k: v.copy() for k, v in arrays.items()}, dict(meta)
        stalled_at = None
        dead_since = None
        while self._expected not in self._pending:
            got = self._poll(block=True)
            if got:
                continue
            if tel is not None and stalled_at is None:
                stalled_at = time.perf_counter()
                tel.counter("proc_prefetch.consumer_stall").add(1)
            if not pool.workers_alive or pool._stop.is_set():
                # grace window: final messages may still be in the queue's
                # feeder pipe after the last worker exited
                dead_since = dead_since or time.perf_counter()
                if time.perf_counter() - dead_since > 5.0:
                    self._failed = True
                    pool._run_active = False
                    raise RuntimeError(
                        "proc-prefetch workers exited without delivering "
                        f"batch {self._pos}")
        if tel is not None and stalled_at is not None:
            tel.counter("proc_prefetch.consumer_stall_seconds").add(
                time.perf_counter() - stalled_at)
        idx = self._expected
        kind, w_item, payload = self._pending.pop(idx)
        self._expected += 1
        self._pos += 1
        if kind == "exc":
            pool._release_through(idx)  # no slot write; keep order invariant
            self._failed = True
            pool._run_active = False
            raise payload
        # copy out, then free the slot for index idx + depth
        slot = pool._slot_views[idx % pool.depth]
        arrays = {name: slot[name].copy() for name in slot}
        pool._release_through(idx)
        meta = payload
        pool._cache_put(item, arrays, meta)
        if tel is not None:
            self._record(tel, meta)
        if self._pos >= len(self._plan):
            self._finish()
        return item, arrays, meta

    def _record(self, tel, meta: Dict) -> None:
        pm = meta.get("_pool", {})
        rank = pm.get("worker", 0)
        if pm.get("stall_events"):
            tel.counter("proc_prefetch.producer_stall",
                        worker=rank).add(pm["stall_events"])
            tel.counter("proc_prefetch.producer_stall_seconds",
                        worker=rank).add(pm["stall_seconds"])
        tel.gauge("proc_prefetch.ready_depth").set(len(self._pending))
        tel.gauge("proc_prefetch.shm_slots_occupied").set(
            min(self._pool.depth, len(self._pending)))
        for name, t0, dur, labels in meta.get("spans", ()):
            tel.record_span(name, t0, dur, tid=("sampler-proc", rank),
                            **labels)

    def _finish(self):
        self._pool._run_active = False

    def close(self):
        """Abort this run without killing the pool: drain every outstanding
        index (releasing slots in order) so the NEXT run starts clean.  If
        workers stopped responding, the pool is closed instead."""
        if self._expected >= self._end and not self._pending:
            self._pool._run_active = False
            return
        pool = self._pool
        deadline = time.perf_counter() + 10.0
        while self._expected < self._end:
            if self._expected in self._pending:
                kind, _, _ = self._pending.pop(self._expected)
                pool._release_through(self._expected)
                self._expected += 1
                continue
            if not self._poll(block=True):
                if not pool.workers_alive or \
                        time.perf_counter() > deadline:
                    pool.close()  # unresponsive: fail safe, unlink shm
                    return
        pool._run_active = False


# ---------------------------------------------------------------------------
# one-shot wrapper (the thread-PrefetchWorker-shaped surface)
# ---------------------------------------------------------------------------


class ProcPrefetchWorker:
    """One-epoch convenience mirroring the thread `PrefetchWorker` contract:
    iterate (item, arrays, meta) in order; `close()` tears the whole pool
    down (processes joined, shm unlinked).  For reuse across epochs hold a
    `ProcPrefetchPool` instead."""

    def __init__(self, items: Sequence, produce: Callable, layout,
                 depth: int = 2, num_workers: int = 2, telemetry=None,
                 mp_context: Optional[str] = None,
                 shared_inputs: Sequence[_ShmArena] = ()):
        self._pool = ProcPrefetchPool(
            produce, layout, depth=depth, num_workers=num_workers,
            telemetry=telemetry, mp_context=mp_context,
            shared_inputs=shared_inputs)
        self._it = self._pool.run(items)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            self._pool.close()
            raise

    def close(self):
        self._pool.close()

    @property
    def alive(self) -> bool:
        return self._pool.alive and self._pool.workers_alive
