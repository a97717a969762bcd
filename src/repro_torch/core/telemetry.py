"""Run-wide telemetry (the port's copy of `repro/core/telemetry.py`): span
tracing, labeled metrics, imbalance profiling.

The survey names three core challenges: massive feature communication,
accuracy loss, and workload imbalance.  CommStats bytes measure the first
and the oracle tiers the second; this module is the characterization layer
for the third: *which device, which stage, how skewed, where did the
step's wall time go*.

Three pieces, all stdlib-only (no torch, no numpy: telemetry must be
importable and overhead-bounded everywhere, the prefetch thread and the
sampling worker processes included):

``Tracer``
    ``with tel.span("extract", step=i, device=d):`` context managers with
    monotonic ``perf_counter`` timestamps and thread-id tagging, so the
    prefetch / trainer / serving lanes interleave as distinct rows.  Spans
    record their nesting depth (per-thread stack) and wrap host-side stage
    boundaries only: a span never waits for the card unless it opts in
    with ``sync=callable`` (e.g. ``lambda: torch.cuda.synchronize(dev)``),
    so a traced step dispatches as an untraced one does.

``MetricRegistry``
    Labeled counters / gauges / fixed-bucket latency histograms.  Histograms
    keep the raw samples next to the bucket counts, so ``percentile(q)`` is
    EXACT: bit-identical to ``numpy.percentile`` (same virtual-index +
    symmetric-lerp arithmetic), asserted by the test tier.

Exporters
    ``chrome_trace()``: Chrome trace-event JSON (``ph/ts/dur/pid/tid``),
    loadable in Perfetto / ``chrome://tracing``, one row per device (pid)
    and lane/thread (tid); ``write_step_log()``: JSONL step records; and
    ``run_summary()``: a self-describing dict (metric totals, per-stage
    span seconds, the workload-imbalance report, and any static
    per-executable facts attached via ``attach_executable``: the port has
    no compiled executable to read, so its callers attach the card's
    memory facts, ``torch.cuda.max_memory_allocated`` and
    ``memory_reserved``).

Telemetry is off-by-default-free: a disabled ``Telemetry`` hands out
singleton no-op spans and metrics (identity-stable, so the disabled path
allocates nothing per call); the overhead bound is asserted in
``tests/test_torch_telemetry.py``.
"""
from __future__ import annotations

import json
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Telemetry",
    "Tracer",
    "MetricRegistry",
    "Span",
    "DEFAULT_LATENCY_BUCKETS",
    "exact_percentile",
]


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class _NullSpan:
    """Disabled-mode span: a no-op context manager, one shared instance."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **labels):
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One recorded interval: name + labels + [t0, t0+dur) on thread `tid`.

    ``labels`` carries the structured facts (step, device, bytes, ...) that
    ride into the Chrome trace ``args`` and the imbalance report."""

    __slots__ = ("name", "labels", "t0", "dur", "tid", "depth", "seq",
                 "_tracer", "_sync")

    def __init__(self, tracer: "Tracer", name: str,
                 sync: Optional[Callable], labels: Dict):
        self._tracer = tracer
        self._sync = sync
        self.name = name
        self.labels = labels
        self.t0 = 0.0
        self.dur = 0.0
        self.tid = 0
        self.depth = 0
        self.seq = -1

    def set(self, **labels) -> "Span":
        """Attach/override labels while the span is live (e.g. counts known
        only at the end of the stage)."""
        self.labels.update(labels)
        return self

    def __enter__(self) -> "Span":
        tr = self._tracer
        stack = tr._stack()
        self.depth = len(stack)
        stack.append(self)
        self.tid = threading.get_ident()
        self.t0 = tr.clock()  # last: exclude our own setup from the interval
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            self._sync()  # opt-in device fence INSIDE the interval
        tr = self._tracer
        self.dur = tr.clock() - self.t0
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        with tr._lock:
            self.seq = len(tr._spans)
            tr._spans.append(self)
        return False


class Tracer:
    """Span recorder with a process-wide monotonic origin."""

    def __init__(self, enabled: bool = True,
                 clock: Callable[[], float] = time.perf_counter):
        self.enabled = bool(enabled)
        self.clock = clock
        self.origin = clock()
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, sync: Optional[Callable] = None, **labels):
        """Context manager for one interval; no-op singleton when disabled."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, sync, labels)

    def instant(self, name: str, **labels) -> None:
        """Zero-duration marker (e.g. the byte accounting of an exchange
        that itself runs inside the step, on the card)."""
        if not self.enabled:
            return
        sp = Span(self, name, None, labels)
        sp.tid = threading.get_ident()
        sp.t0 = self.clock()
        with self._lock:
            sp.seq = len(self._spans)
            self._spans.append(sp)

    def record_span(self, name: str, t0: float, dur: float,
                    tid=None, **labels) -> None:
        """Record an ALREADY-MEASURED interval — the replay path for spans
        timed in another process (the process-pool sampling workers ship
        (name, t0, dur, labels) tuples back with each batch).  ``t0`` must be
        on this tracer's clock; the default `time.perf_counter` is
        CLOCK_MONOTONIC on Linux, shared across processes on one host, so
        worker intervals land on the same timeline as local spans.  ``tid``
        is the trace lane key — any hashable; worker processes pass e.g.
        ``("proc", rank)`` so each gets its own Chrome-trace row."""
        if not self.enabled:
            return
        sp = Span(self, name, None, dict(labels))
        sp.tid = threading.get_ident() if tid is None else tid
        sp.t0 = float(t0)
        sp.dur = float(dur)
        with self._lock:
            sp.seq = len(self._spans)
            self._spans.append(sp)

    def spans(self) -> List[Span]:
        """All finished spans, ordered by start time (stable on record seq)."""
        with self._lock:
            out = list(self._spans)
        return sorted(out, key=lambda s: (s.t0, s.seq))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

class _NullMetric:
    """Disabled-mode counter/gauge/histogram: every mutator is a no-op."""

    __slots__ = ()
    value = 0.0

    def add(self, n=1):
        return self

    def set(self, v):
        return self

    def record(self, v):
        return self

    def percentile(self, q):
        return 0.0


NULL_METRIC = _NullMetric()


def exact_percentile(samples: Sequence[float], q: float) -> float:
    """``numpy.percentile(samples, q)`` (linear interpolation) replicated in
    stdlib arithmetic — same virtual index ``(q/100)*(n-1)`` and the same
    symmetric lerp (switches to the ``b - (b-a)*(1-t)`` form at t >= 0.5),
    so results are bit-identical to numpy's."""
    xs = sorted(float(x) for x in samples)
    n = len(xs)
    if n == 0:
        return 0.0
    if n == 1:
        return xs[0]
    pos = (q / 100.0) * (n - 1)
    lo = int(math.floor(pos))
    hi = int(math.ceil(pos))
    a, b = xs[lo], xs[hi]
    t = pos - lo
    r = a + (b - a) * t
    if t >= 0.5:
        r = b - (b - a) * (1.0 - t)
    return r


# Upper bucket bounds (seconds) for latency histograms: ~1/3 decade steps
# from 0.1 ms to 10 s; the last bucket is the +inf overflow.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0, 3.0, 10.0)


class Counter:
    __slots__ = ("name", "labels", "value", "_lock")

    def __init__(self, name: str, labels: Dict, lock: threading.Lock):
        self.name = name
        self.labels = labels
        self.value = 0
        self._lock = lock

    def add(self, n=1) -> "Counter":
        with self._lock:
            self.value += n
        return self


class Gauge:
    __slots__ = ("name", "labels", "value", "_lock")

    def __init__(self, name: str, labels: Dict, lock: threading.Lock):
        self.name = name
        self.labels = labels
        self.value = 0.0
        self._lock = lock

    def set(self, v) -> "Gauge":
        with self._lock:
            self.value = v
        return self


class Histogram:
    """Fixed-bucket histogram that also retains the raw samples, so bucket
    counts are exportable AND percentiles are exact (not interpolated from
    bucket edges)."""

    __slots__ = ("name", "labels", "buckets", "counts", "samples", "total",
                 "_lock")

    def __init__(self, name: str, labels: Dict, lock: threading.Lock,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        self.name = name
        self.labels = labels
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # last = overflow
        self.samples: List[float] = []
        self.total = 0.0
        self._lock = lock

    def record(self, v) -> "Histogram":
        v = float(v)
        i = 0
        for b in self.buckets:
            if v <= b:
                break
            i += 1
        with self._lock:
            self.counts[i] += 1
            self.samples.append(v)
            self.total += v
        return self

    @property
    def count(self) -> int:
        return len(self.samples)

    def percentile(self, q: float) -> float:
        with self._lock:
            xs = list(self.samples)
        return exact_percentile(xs, q)


class MetricRegistry:
    """Labeled metric store: ``registry.counter("comm.pull_bytes",
    device=3).add(n)`` — one object per (kind, name, label set), created on
    first use.  Disabled registries hand out the shared no-op metric."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple, object] = {}

    def _get(self, kind: str, cls, name: str, labels: Dict, **kw):
        if not self.enabled:
            return NULL_METRIC
        key = (kind, name, tuple(sorted(labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, dict(labels), self._lock,
                                             **kw)
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, buckets: Sequence[float] = None,
                  **labels) -> Histogram:
        kw = {} if buckets is None else {"buckets": buckets}
        return self._get("histogram", Histogram, name, labels, **kw)

    # -- aggregation ------------------------------------------------------
    def _iter(self, kind: str):
        with self._lock:
            items = list(self._metrics.items())
        for (k, name, labkey), m in items:
            if k == kind:
                yield name, dict(labkey), m

    def counter_total(self, name: str):
        """Sum of a counter over every label set (e.g. across devices)."""
        return sum(m.value for n, _, m in self._iter("counter") if n == name)

    def per_device(self, name: str) -> Dict[int, float]:
        """device-label -> value for a counter or gauge family."""
        out: Dict[int, float] = {}
        for kind in ("counter", "gauge"):
            for n, labels, m in self._iter(kind):
                if n == name and "device" in labels:
                    d = int(labels["device"])
                    out[d] = out.get(d, 0) + m.value
        return out

    def as_dict(self) -> Dict:
        """Export every metric; label sets keyed as "k=v,k=v" strings."""

        def lkey(labels):
            return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))

        counters: Dict[str, Dict] = {}
        gauges: Dict[str, Dict] = {}
        hists: Dict[str, Dict] = {}
        for name, labels, m in self._iter("counter"):
            counters.setdefault(name, {})[lkey(labels)] = m.value
        for name, labels, m in self._iter("gauge"):
            gauges.setdefault(name, {})[lkey(labels)] = m.value
        for name, labels, m in self._iter("histogram"):
            hists.setdefault(name, {})[lkey(labels)] = dict(
                count=m.count, sum=m.total,
                p50=m.percentile(50.0), p99=m.percentile(99.0),
                buckets=list(m.buckets), counts=list(m.counts))
        return dict(counters=counters, gauges=gauges, histograms=hists)


# ---------------------------------------------------------------------------
# the facade + exporters
# ---------------------------------------------------------------------------

def _imbalance(per_device: Dict[int, float]) -> Dict:
    vals = list(per_device.values())
    mean = sum(vals) / len(vals)
    mx = max(vals)
    return dict(per_device={str(d): per_device[d] for d in sorted(per_device)},
                max=mx, mean=mean,
                max_over_mean=(mx / mean) if mean > 0 else 0.0)


def _jsonable(v):
    return v if isinstance(v, (int, float, str, bool, type(None))) else str(v)


class Telemetry:
    """One run's tracer + metric registry + step log, with the exporters.

    ``Telemetry(enabled=False)`` (the engine's default) is free: spans and
    metrics are shared no-op singletons, and every exporter returns empty
    structures."""

    def __init__(self, enabled: bool = True,
                 clock: Callable[[], float] = time.perf_counter):
        self.enabled = bool(enabled)
        self.trace = Tracer(self.enabled, clock)
        self.metrics = MetricRegistry(self.enabled)
        self._lock = threading.Lock()
        self._steps: List[Dict] = []
        self._executables: Dict[str, Dict] = {}

    # -- recording (delegates) -------------------------------------------
    def span(self, name: str, sync: Optional[Callable] = None, **labels):
        return self.trace.span(name, sync=sync, **labels)

    def instant(self, name: str, **labels) -> None:
        self.trace.instant(name, **labels)

    def record_span(self, name: str, t0: float, dur: float,
                    tid=None, **labels) -> None:
        self.trace.record_span(name, t0, dur, tid=tid, **labels)

    def counter(self, name: str, **labels):
        return self.metrics.counter(name, **labels)

    def gauge(self, name: str, **labels):
        return self.metrics.gauge(name, **labels)

    def histogram(self, name: str, buckets: Sequence[float] = None, **labels):
        return self.metrics.histogram(name, buckets=buckets, **labels)

    def log_step(self, **fields) -> None:
        """Append one JSONL step record (written by `write_step_log`)."""
        if not self.enabled:
            return
        with self._lock:
            self._steps.append({k: _jsonable(v) for k, v in fields.items()})

    def attach_executable(self, name: str, summary: Dict) -> None:
        """Record static per-executable facts into the run summary (the
        port's callers attach the card's memory facts:
        ``torch.cuda.max_memory_allocated``, ``memory_reserved``)."""
        if not self.enabled:
            return
        with self._lock:
            self._executables[name] = dict(summary)

    # -- analysis ---------------------------------------------------------
    def imbalance_report(self) -> Dict:
        """Workload imbalance per stage: anything recorded with a ``device``
        label — span seconds, byte counters, occupancy/layout gauges —
        grouped per device and reduced to max / mean / max-over-mean."""
        span_groups: Dict[str, Dict[int, float]] = {}
        for s in self.trace.spans():
            d = s.labels.get("device")
            if d is None:
                continue
            g = span_groups.setdefault(s.name, {})
            g[int(d)] = g.get(int(d), 0.0) + s.dur
        spans = {name: _imbalance(g) for name, g in span_groups.items()
                 if sum(g.values()) > 0}
        metric_groups: Dict[str, Dict[int, float]] = {}
        for kind in ("counter", "gauge"):
            for name, labels, m in self.metrics._iter(kind):
                if "device" in labels:
                    g = metric_groups.setdefault(name, {})
                    d = int(labels["device"])
                    g[d] = g.get(d, 0) + m.value
        metrics = {name: _imbalance(g) for name, g in metric_groups.items()}
        return dict(spans=spans, metrics=metrics)

    def span_seconds(self) -> Dict[str, float]:
        """Total recorded seconds per span name (the per-stage wall
        breakdown; nested spans double-count by design)."""
        out: Dict[str, float] = {}
        for s in self.trace.spans():
            out[s.name] = out.get(s.name, 0.0) + s.dur
        return out

    def run_summary(self) -> Dict:
        """The self-describing run artifact: metric totals, per-stage span
        seconds, the imbalance report, static executable facts, step log."""
        spans = self.trace.spans()
        counts: Dict[str, int] = {}
        for s in spans:
            counts[s.name] = counts.get(s.name, 0) + 1
        with self._lock:
            steps = list(self._steps)
            execs = {k: dict(v) for k, v in self._executables.items()}
        return dict(
            enabled=self.enabled,
            spans=dict(count=len(spans), count_by_name=counts,
                       seconds_by_name=self.span_seconds()),
            metrics=self.metrics.as_dict(),
            imbalance=self.imbalance_report(),
            executables=execs,
            steps=steps,
        )

    # -- exporters --------------------------------------------------------
    def chrome_trace(self) -> Dict:
        """Chrome trace-event JSON: complete ("X") events with microsecond
        ts/dur relative to the tracer origin; pid = ``device`` label (0 when
        unlabeled), tid = lane (thread) index in order of first appearance —
        one row per device/lane in Perfetto / chrome://tracing."""
        origin = self.trace.origin
        tid_of: Dict[int, int] = {}
        events: List[Dict] = []
        for s in self.trace.spans():
            d = s.labels.get("device")
            pid = int(d) if d is not None else 0
            tid = tid_of.setdefault(s.tid, len(tid_of))
            events.append(dict(
                name=s.name, ph="X",
                ts=(s.t0 - origin) * 1e6, dur=s.dur * 1e6,
                pid=pid, tid=tid,
                args={k: _jsonable(v) for k, v in s.labels.items()}))
        meta: List[Dict] = []
        for pid in sorted({e["pid"] for e in events}):
            meta.append(dict(name="process_name", ph="M", pid=pid, tid=0,
                             args={"name": f"device {pid}"}))
        for ident, tid in sorted(tid_of.items(), key=lambda kv: kv[1]):
            meta.append(dict(name="thread_name", ph="M", pid=0, tid=tid,
                             args={"name": f"lane {tid}"}))
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def write_step_log(self, path: str) -> None:
        """JSONL: one line per `log_step` record."""
        with self._lock:
            steps = list(self._steps)
        with open(path, "w") as f:
            for rec in steps:
                f.write(json.dumps(rec) + "\n")


# A process-wide disabled instance: integration points that receive
# ``telemetry=None`` can fall back to this instead of branching everywhere.
NULL_TELEMETRY = Telemetry(enabled=False)
