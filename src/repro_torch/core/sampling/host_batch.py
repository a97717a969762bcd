"""Host-side mini-batch construction (the port's copy of
`repro/core/sampling/host_batch.py`, numpy only).

`HostBatchBuilder` is the engine's sample and extract stages: `sample` draws
each rank's targets from its own partition block and expands them with the
configured sampler, deterministic in (seed, step, rank); `extract` pads every
rank's MiniBatch to the static caps, relabels the frontiers into the
engine's vertex space and builds the execution model's fetch plan (cache
hits short-circuit the exchange), returning flat numpy arrays of the shapes
`array_layout` names and, per rank, the CommStats byte deltas the batch
costs.  Every rank builds the whole [k, ...] batch, as the reference's one
host does: p2p's send table needs every destination's needs.  The engine
uploads its own rank's slice.

`produce` is the process-pool producer (`sampling/proc_prefetch.py`): the
pool ships one builder to each sampling worker, which produces finished
padded batches into shared-memory ring slots.  Three properties make that
work:

* **numpy-only**: nothing in this module (or its import chain) imports
  torch; a worker never touches the parent's CUDA context, and does not pay
  the import.  The upload and the CommStats accounting stay engine-side
  (`DistGNNEngine._finish_batch`): the builder returns plain numpy arrays
  plus a small metadata dict carrying the per-rank byte deltas and the
  stage timings.
* **picklable**: every field is plain data; the graph handle may be a
  `Graph` or anything with a ``materialize()`` method returning one
  (`proc_prefetch.SharedGraph`, which attaches to the parent's CSR arrays
  in POSIX shared memory).  The lazily-derived caches live outside the
  dataclass fields and are rebuilt after unpickling.
* **deterministic**: sampling is seeded by (seed, step, rank), so a pooled
  epoch is bitwise-identical to a blocking one whichever worker produced
  which batch.

With trainable features the batch also carries ``emb_ids``, per owner the
sorted distinct local rows any rank's frontier reads (the row-sparse
optimizer's ids), and each rank's CommStats delta adds the gradient rows
the step sends back (`embedding_update_bytes`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.execution.bucketing import bucketed_send_table, halo_slot
from repro_torch.core.feature_store import touched_rows_from_frontier
from repro_torch.core.partition.edge_cut import Partition
from repro_torch.core.sampling.distributed import (
    CommStats,
    embedding_update_bytes,
    feature_fetch_bytes,
)
from repro_torch.core.sampling.partition_batch import partition_targets
from repro_torch.core.sampling.samplers import (
    layer_wise_sample,
    node_wise_sample,
    pad_minibatch,
    subgraph_sample,
)


class _SpanRecorder:
    """Collects (name, t0, dur, labels) tuples with `time.perf_counter`
    timestamps: CLOCK_MONOTONIC on Linux, shared across processes on one
    host, so a parent can lay a worker's spans onto its own timeline."""

    def __init__(self):
        self.spans: List[Tuple[str, float, float, Dict]] = []

    @contextlib.contextmanager
    def span(self, name: str, **labels):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter() - t0, labels))


@dataclasses.dataclass
class HostBatchBuilder:
    """The engine's host sampling and padded-batch extraction, built once
    per mini-batch plan by `DistGNNEngine._build_minibatch_plan`;
    `sample`/`extract` are the in-process path, `produce` the
    worker-process entry point (sample + extract + timing in one call)."""

    # config scalars (a slice of EngineConfig)
    batching: str
    execution: str
    seed: int
    batch_size: int
    fanouts: Tuple[int, ...]
    layer_sizes: Tuple[int, ...]
    walk_length: int
    num_layers: int
    # static plan (engine layout + fetch-plan caps)
    k: int
    nb: int
    caps: Tuple[int, ...]
    fcap: int
    fcap_widths: Optional[Tuple[int, ...]]  # p2p only
    Ccap: int
    feature_dim: int
    # O(V) layout arrays
    assignment: np.ndarray
    new_of_old: np.ndarray
    labels: np.ndarray
    train_mask: Optional[np.ndarray]
    # per-rank resident-cache plan
    cache_slots: List[Dict[int, int]]  # old global id -> overlay row
    cache_sets: List[frozenset]
    # Graph, or anything with .materialize() -> Graph (attached lazily)
    graph: object
    # trainable features: the touched-row cap of ``emb_ids`` and each
    # rank's overlay row count (the refresh's rows in the byte model)
    trainable_features: bool = False
    tcap: int = 0
    overlay_rows: Tuple[int, ...] = ()

    # -- lazy derived state (rebuilt after unpickling) ---------------------

    def __getstate__(self):
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def __setstate__(self, state):
        for name, v in state.items():
            setattr(self, name, v)

    def _g(self):
        g = self.__dict__.get("_g_cache")
        if g is None:
            g = (self.graph.materialize()
                 if hasattr(self.graph, "materialize") else self.graph)
            self.__dict__["_g_cache"] = g
        return g

    def _part(self) -> Partition:
        p = self.__dict__.get("_part_cache")
        if p is None:
            p = Partition(assignment=self.assignment, num_parts=self.k)
            self.__dict__["_part_cache"] = p
        return p

    # -- the two stages ----------------------------------------------------

    def sample(self, step_idx: int, span_factory=None) -> List:
        """Per rank, draw targets from its OWNED partition block and expand
        them with the configured sampler.  Deterministic in (seed, step,
        rank), so the reference step and any rerun, in any process, see the
        same batches.  ``span_factory(name, **labels)`` is an optional span
        context factory (the engine's telemetry, or a `_SpanRecorder` in a
        worker): one ``sample_device`` span a rank."""
        g = self._g()
        part = self._part()
        mbs = []
        for d in range(self.k):
            ctx = (contextlib.nullcontext() if span_factory is None
                   else span_factory("sample_device", step=step_idx, device=d))
            with ctx:
                rng = np.random.default_rng([self.seed, 7919, step_idx, d])
                targets = partition_targets(g, part, d, self.batch_size, rng)
                if self.batching == "node_wise":
                    mb = node_wise_sample(g, targets, self.fanouts, rng)
                elif self.batching == "layer_wise":
                    mb = layer_wise_sample(g, targets, self.layer_sizes, rng)
                else:  # subgraph
                    mb = subgraph_sample(g, targets, self.walk_length, rng,
                                         num_layers=self.num_layers)
                mbs.append(mb)
        return mbs

    def extract(self, mbs) -> Tuple[Dict[str, np.ndarray], Dict]:
        """Pad each rank's MiniBatch to the static caps, relabel frontiers
        into the engine's new-id space, and build the execution model's
        fetch plan (cache hits short-circuit the exchange).

        Returns ``(arrays, meta)``: ``arrays`` the flat numpy batch
        (`array_layout()` shapes and dtypes exactly); ``meta["per_device"]``
        per rank the CommStats byte deltas this batch costs, the frontier
        occupancy and the cache hits."""
        k, nb, L = self.k, self.nb, self.num_layers
        Vp = k * nb
        caps, fcap, Ccap = self.caps, self.fcap, self.Ccap
        D = self.feature_dim
        part = self._part()
        frontier = np.full((k, caps[0]), Vp, np.int64)
        y = np.zeros((k, caps[-1]), np.int32)
        w = np.zeros((k, caps[-1]), np.float32)
        adj = [np.zeros((k, caps[l + 1], caps[l]), np.float32)
               for l in range(L)]
        self_idx = [np.zeros((k, caps[l + 1]), np.int32) for l in range(L)]
        cache_ids = np.full((k, caps[0]), Ccap, np.int32)
        if self.execution == "broadcast":
            bc_ids = np.full((k, caps[0]), Vp, np.int64)
        elif self.execution == "ring":
            ring_ids = np.full((k, k, caps[0]), nb, np.int32)
        else:
            widths = list(self.fcap_widths)
            B, wdt = len(widths), widths[0]
            need_lists = [[np.zeros(0, np.int64) for _ in range(k)]
                          for _ in range(k)]
            tab_ids = np.full((k, caps[0]), nb + B * k * wdt, np.int32)
        per_device = []
        for d, mb in enumerate(mbs):
            padded = pad_minibatch(mb, caps)
            for l in range(L):
                adj[l][d] = padded["adj"][l]
                self_idx[l][d] = padded["self_idx"][l]
            tgt, tmask = padded["tgt"], padded["tmask"]
            safe_tgt = np.clip(tgt, 0, None)
            y[d] = np.where(tgt >= 0, self.labels[safe_tgt], 0)
            # loss only on OWNED train targets: subgraph walks visit remote
            # vertices, and a boundary vertex reached by two ranks' walks
            # would otherwise count twice in the summed loss and gradient
            tw = tmask * np.where(
                tgt >= 0, self.assignment[safe_tgt] == d, False)
            if self.train_mask is not None:
                tw = tw * np.where(
                    tgt >= 0, self.train_mask[safe_tgt], False)
            w[d] = tw
            old = padded["frontier"]
            slot = self.cache_slots[d]
            occ = remote = cache_hits = 0
            # p2p: halo slot of each needed local src row, per source rank
            need = [dict() for _ in range(k)]
            for j in range(caps[0]):
                o = int(old[j])
                if o < 0:
                    continue
                occ += 1
                fn = int(self.new_of_old[o])
                frontier[d, j] = fn
                s = fn // nb
                remote += s != d
                cslot = slot.get(o, -1)
                if s != d and cslot >= 0:
                    cache_hits += 1
                    cache_ids[d, j] = cslot
                    continue  # served by the resident cache
                if self.execution == "broadcast":
                    bc_ids[d, j] = fn
                elif self.execution == "ring":
                    ring_ids[d, s, j] = fn % nb
                else:  # p2p
                    if s == d:
                        tab_ids[d, j] = fn % nb
                    else:
                        li = fn % nb
                        pos = need[s].setdefault(li, len(need[s]))
                        tab_ids[d, j] = int(halo_slot(pos, s, wdt, k, nb))
            if self.execution == "p2p":
                for s in range(k):
                    if s != d and need[s]:
                        assert len(need[s]) <= fcap, (
                            f"p2p halo cap overflow: device {d} needs "
                            f"{len(need[s])} rows from {s}, fcap={fcap}")
                        # dict preserves insertion order == pos order
                        need_lists[s][d] = np.fromiter(
                            need[s], np.int64, len(need[s]))
            # byte accounting into a throwaway CommStats: the engine applies
            # the deltas when it takes the batch in
            delta = CommStats()
            feature_fetch_bytes(part, d, mb.layer_vertices[0], D,
                                cached_ids=self.cache_sets[d], stats=delta)
            if self.trainable_features:
                embedding_update_bytes(
                    part, d, mb.layer_vertices[0], D,
                    cached_ids=self.cache_sets[d],
                    overlay_rows=self.overlay_rows[d], stats=delta)
            per_device.append(dict(
                stats={f.name: getattr(delta, f.name)
                       for f in dataclasses.fields(CommStats)
                       if getattr(delta, f.name)},
                occupancy=occ, remote=remote, cache_hits=cache_hits))
        arrays = dict(frontier=frontier.astype(np.int32), y=y, w=w,
                      cache_ids=cache_ids)
        for l in range(L):
            arrays[f"adj{l}"] = adj[l]
            arrays[f"self_idx{l}"] = self_idx[l]
        if self.execution == "broadcast":
            arrays["bc_ids"] = bc_ids.astype(np.int32)
        elif self.execution == "ring":
            arrays["ring_ids"] = ring_ids
        else:
            # the one write side matching halo_slot's read side, shared with
            # the full-graph plan
            arrays["send_rows"] = bucketed_send_table(need_lists, k, widths)
            arrays["tab_ids"] = tab_ids
        if self.trainable_features:
            # per OWNER the touched local rows, sorted: every row any
            # rank's frontier reads, hit or miss (a hit reads the refreshed
            # overlay, whose gradient still lands on the owner's shard)
            arrays["emb_ids"] = touched_rows_from_frontier(
                frontier, k, nb, self.tcap)
        return arrays, dict(per_device=per_device)

    # -- worker-process entry point ----------------------------------------

    def produce(self, step) -> Tuple[Dict[str, np.ndarray], Dict]:
        """sample + extract for one step with stage timing: the
        `ProcPrefetchPool` producer.  The returned meta adds
        ``sample_seconds`` / ``extract_seconds`` (the producer lane's
        seconds for StageTimes) and ``spans``, the two stages' spans and
        each rank's ``sample_device`` span, replayed onto the parent's
        tracer as this worker's lane."""
        step = int(step)
        rec = _SpanRecorder()
        t0 = time.perf_counter()
        with rec.span("sample", step=step):
            mbs = self.sample(step, span_factory=rec.span)
        t1 = time.perf_counter()
        with rec.span("extract", step=step):
            arrays, meta = self.extract(mbs)
        t2 = time.perf_counter()
        meta["sample_seconds"] = t1 - t0
        meta["extract_seconds"] = t2 - t1
        meta["spans"] = rec.spans
        return arrays, meta

    # -- the shm ring contract ---------------------------------------------

    def array_layout(self) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
        """name -> (shape, dtype) of every array `extract` returns: static
        across batches (the padding caps), so ring slots are sized once."""
        k, caps, L = self.k, self.caps, self.num_layers
        lay: Dict[str, Tuple[Tuple[int, ...], np.dtype]] = {
            "frontier": ((k, caps[0]), np.dtype(np.int32)),
            "y": ((k, caps[-1]), np.dtype(np.int32)),
            "w": ((k, caps[-1]), np.dtype(np.float32)),
            "cache_ids": ((k, caps[0]), np.dtype(np.int32)),
        }
        for l in range(L):
            lay[f"adj{l}"] = ((k, caps[l + 1], caps[l]),
                              np.dtype(np.float32))
            lay[f"self_idx{l}"] = ((k, caps[l + 1]), np.dtype(np.int32))
        if self.execution == "broadcast":
            lay["bc_ids"] = ((k, caps[0]), np.dtype(np.int32))
        elif self.execution == "ring":
            lay["ring_ids"] = ((k, k, caps[0]), np.dtype(np.int32))
        else:
            B, wdt = len(self.fcap_widths), self.fcap_widths[0]
            lay["send_rows"] = ((k, B, k, wdt), np.dtype(np.int32))
            lay["tab_ids"] = ((k, caps[0]), np.dtype(np.int32))
        if self.trainable_features:
            lay["emb_ids"] = ((k, self.tcap), np.dtype(np.int32))
        return lay
