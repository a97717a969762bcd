"""Background batch prefetch (the port's copy of
`repro/core/sampling/prefetch.py`, survey §6.1 pipelining made real).

`PrefetchWorker` runs a producer callable (the engine's host sampling and
padded-batch extraction, with this rank's upload) on a dedicated thread,
buffering at most ``depth`` finished batches in a bounded queue.  While the
card executes step i the worker is already building the batch for step
i+1: the double-buffered sampler lane of GNNLab's factored schedule, with
the overlap measured on the wall clock, not modeled.

Contracts:

* results arrive strictly in input order (host sampling is deterministic in
  (seed, step, rank), so the pipelined epoch is bitwise-identical to the
  blocking one);
* a producer exception is re-raised in the consumer at the position it
  occurred, after the thread has exited;
* ``close()`` always stops and joins the thread, including when the
  CONSUMER dies mid-epoch while the worker is blocked on a full queue.

With an enabled `core.telemetry.Telemetry` the worker records the
``prefetch.queue_depth`` gauge and one ``prefetch.producer_stall`` /
``prefetch.consumer_stall`` count (and ``*_seconds``) per contiguous stall;
with None, or a disabled one, they are skipped.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Sequence

_DONE = object()


class _Raise:
    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchWorker:
    """Iterate produced items: ``for out in PrefetchWorker(items, produce)``.

    The producer thread starts immediately and works ahead of the consumer,
    bounded by ``depth`` buffered results."""

    def __init__(self, items: Sequence, produce: Callable, depth: int = 2,
                 telemetry=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        # telemetry (optional, anything with gauge(name).set and
        # counter(name).add): queue-depth gauge and stall counters, recorded
        # from both lanes
        self._tel = (telemetry if telemetry is not None
                     and getattr(telemetry, "enabled", False) else None)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._items = list(items)
        self._produce = produce
        self._done = False
        self._thread = threading.Thread(
            target=self._run, name="prefetch-sampler", daemon=True)
        self._thread.start()

    # -- producer side -----------------------------------------------------

    def _run(self):
        try:
            for item in self._items:
                if self._stop.is_set() or not self._offer(self._produce(item)):
                    return
            self._offer(_DONE)
        except BaseException as exc:  # noqa: BLE001 — relayed to the consumer
            self._offer(_Raise(exc))

    def _offer(self, out) -> bool:
        """Bounded put that stays responsive to close(): never blocks forever
        on a consumer that stopped consuming."""
        stalled_at = None
        while not self._stop.is_set():
            try:
                self._q.put(out, timeout=0.05)
                if self._tel is not None:
                    self._tel.gauge("prefetch.queue_depth").set(
                        self._q.qsize())
                    if stalled_at is not None:
                        self._tel.counter(
                            "prefetch.producer_stall_seconds").add(
                                time.perf_counter() - stalled_at)
                return True
            except queue.Full:
                # producer ahead of the trainer by the full depth: the
                # backpressure stall.  ONE event per contiguous stall (not
                # per 0.05 s poll: a count proportional to the polling
                # cadence measures the poll loop, not the pipeline); the
                # duration rides the companion *_seconds counter
                if self._tel is not None and stalled_at is None:
                    stalled_at = time.perf_counter()
                    self._tel.counter("prefetch.producer_stall").add(1)
                continue
        return False

    # -- consumer side -----------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        stalled_at = None
        while True:
            try:
                out = self._q.get(timeout=0.1)
                if self._tel is not None:
                    self._tel.gauge("prefetch.queue_depth").set(
                        self._q.qsize())
                    if stalled_at is not None:
                        self._tel.counter(
                            "prefetch.consumer_stall_seconds").add(
                                time.perf_counter() - stalled_at)
                break
            except queue.Empty:
                # trainer starved: the producer lane is the bottleneck.
                # ONE event per contiguous stall, duration on *_seconds
                if self._tel is not None and stalled_at is None:
                    stalled_at = time.perf_counter()
                    self._tel.counter("prefetch.consumer_stall").add(1)
                if not self._thread.is_alive():
                    # the thread may have enqueued its final item or the
                    # sentinel between our timeout and the liveness check:
                    # drain once more before declaring it dead
                    try:
                        out = self._q.get_nowait()
                        break
                    except queue.Empty:
                        self._done = True
                        raise RuntimeError("prefetch worker exited without "
                                           "delivering a result")
        if out is _DONE:
            self._done = True
            raise StopIteration
        if isinstance(out, _Raise):
            self._done = True
            self._thread.join(timeout=5.0)
            raise out.exc
        return out

    def close(self):
        """Idempotent shutdown: signal the thread, unblock any pending put by
        draining the queue, and join."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()
