"""Low-latency GNN query serving (the port's copy of
`repro/core/serving.py`, the latency tier).

`GNNQueryEngine` is the persistent engine that answers "embed these K target
vertices now" on top of a trained `DistGNNEngine`, riding the padded
node-wise sampler path:

  - STATIC shapes: every serve round is padded to the engine's mini-batch
    frontier caps (fixed fanouts), so every round runs the same shapes
    through the same kernels.  The reference's contract is one compile of
    its jitted serve step; the port compiles nothing, and its counterpart
    is `round_shapes()`, the number of distinct shape signatures of the
    rounds served, which stays 1;
  - REQUEST COALESCING: `submit()` queues requests, `flush()` dedupes the
    pending target set, splits it by owner (targets are sampled on the
    rank that owns them, the invariant the p2p halo caps are measured
    under), and packs it into the fewest padded rounds the per-owner cap
    (cfg.batch_size) allows;
  - the RESIDENT FEATURE CACHE (the FeatureStore hot-row overlay) is the
    serving hot set: remote frontier rows it holds never touch the wire, so
    a fully cache-resident query costs zero exchange bytes (bytes ride the
    engine's CommStats accounting).

A round is the mini-batch step minus loss and gradients, under
``torch.no_grad()``: `DistGNNEngine._fetch_frontier` (the cache rows plus
the misses through the execution model: under p2p the ELL forward kernel at
K = 1 gathers each installment's send rows) and `padded_minibatch_forward`
over the dense blocks, then one all_gather of the [cap_L, C] output rows so
that every rank holds every owner's rows.  Over k ranks every rank is given
the same requests, as with every SPMD entry point, builds the same rounds
(sampling is deterministic in (seed, round, owner)) and returns the same
answers.

The throughput tier, embeddings for EVERY vertex in O(L) layer-wise sweeps,
is `DistGNNEngine.infer_full_graph`; this module is the K-target
point-query complement.  Its spans (``serve_build``, ``serve_compute``,
``serve_flush``), ``serve.*`` counters and the ``serve.flush_latency_s``
histogram land in the engine's telemetry.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core.execution.pipeline_exchange import zero_pad_row
from repro_torch.core.models.gnn import padded_minibatch_forward
from repro_torch.core.sampling.samplers import node_wise_sample


@dataclasses.dataclass
class ServingStats:
    """Host-side serving counters; wire bytes live in engine.comm_stats."""
    queries: int = 0  # requests answered
    rounds: int = 0  # serve rounds run
    targets: int = 0  # deduped target vertices embedded
    latencies_s: List[float] = dataclasses.field(default_factory=list)

    def percentile_ms(self, q: float) -> float:
        if not self.latencies_s:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies_s), q) * 1e3)

    def qps(self) -> float:
        wall = sum(self.latencies_s)
        return self.queries / wall if wall > 0 else 0.0


def _shapes(value) -> tuple:
    """The shapes of every tensor in a batch entry (a tensor, or nested
    tuples and lists of them; None entries are skipped)."""
    if isinstance(value, torch.Tensor):
        return (tuple(value.shape),)
    if isinstance(value, (tuple, list)):
        return tuple(_shapes(v) for v in value if v is not None)
    return ()


class GNNQueryEngine:
    """Persistent K-target embedding server over a DistGNNEngine.

    The engine must be built with ``batching='node_wise'`` (the fixed-fanout
    padded sampler path whose caps make every round's shapes static) and
    frozen features: for ``trainable_features`` models, publish the trained
    table first (``engine.publish_embeddings(state)``) and serve from a
    non-trainable engine on the same store and partition.
    """

    def __init__(self, engine, params):
        c = engine.cfg
        if c.batching != "node_wise":
            raise ValueError(
                "GNNQueryEngine rides the node-wise padded sampler path: "
                f"build the engine with batching='node_wise' "
                f"(got batching={c.batching!r})")
        if c.trainable_features:
            raise ValueError(
                "GNNQueryEngine serves FROZEN layer-0 rows: write the "
                "trained table back with engine.publish_embeddings(state) "
                "and build a non-trainable engine on the same graph/"
                "partition for serving")
        self.engine = engine
        self.params = params
        self.stats = ServingStats()
        # ride the engine's telemetry: serve spans land in the same trace
        # as training, on their own lane when called from another thread
        self.telemetry = engine.telemetry
        self._pending: List[tuple] = []  # (rid, target ids)
        self._next_rid = 0
        self._qctr = 0  # monotone round counter keying the sampling streams
        self._signatures = set()  # shape signatures of the rounds served
        self._table0 = None  # the reference round's [Vp + 1, D] table

    def round_shapes(self) -> int:
        """Distinct shape signatures of the rounds served: 1 after any
        number of rounds (the static-shape contract), 0 before the first."""
        return len(self._signatures)

    # -- round construction ----------------------------------------------
    def build_round(self, round_targets: Sequence[np.ndarray]) -> Dict:
        """One padded serve round from per-owner OWNED target lists (each
        <= cfg.batch_size): deterministic node-wise sampling keyed by a
        monotone round counter, then the engine's extract stage (static
        caps, cache short-circuit, exchange plan, CommStats bytes, this
        rank's upload)."""
        eng, c = self.engine, self.engine.cfg
        assignment = eng.playout.part.assignment
        qi = self._qctr
        self._qctr += 1
        mbs = []
        for d, tg in enumerate(round_targets):
            tg = np.asarray(tg, np.int64)
            if len(tg) > c.batch_size:
                raise ValueError(f"device {d} round has {len(tg)} targets > "
                                 f"batch_size {c.batch_size}")
            if len(tg) and np.any(assignment[tg] != d):
                raise ValueError(f"device {d} given targets it does not own")
            rng = np.random.default_rng([c.seed, 70657, qi, d])
            mbs.append(node_wise_sample(eng.g, tg, c.fanouts, rng))
        with self.telemetry.span("serve_build", round=qi):
            return eng._make_batch(mbs, step=qi)

    def serve_round(self, batch: Dict) -> torch.Tensor:
        """Run one built round: this rank's block (the frontier fetch, then
        the padded forward, under no gradient), then one all_gather of its
        [cap_L, C] rows.  Returns every owner's final-layer rows of its
        padded targets, [k, cap_L, C], on every rank."""
        eng = self.engine
        with self.telemetry.span("serve_compute"):
            with torch.no_grad():
                F = eng._fetch_frontier(eng.store.device_table(), batch)
                H = padded_minibatch_forward(
                    self.params, batch["adj"], F, model=eng.cfg.model,
                    self_idx=batch["self_idx"])
                out = eng.gather_rows(H).view(eng.k, *H.shape)
        self._signatures.add(tuple(
            (key, _shapes(batch[key])) for key in sorted(batch)
            if key != "arrays"))
        self.stats.rounds += 1
        self.telemetry.counter("serve.rounds").add(1)
        return out

    def reference_round(self, batch: Dict) -> torch.Tensor:
        """Single-device oracle for the SAME padded round: features gathered
        straight from the global table (pad frontier id Vp reads a zero
        row), the forward run over each of the k owners' blocks (the other
        ranks' uploaded from the batch's host arrays), no collective: the
        serving analog of `make_reference_minibatch_step`.  [k, cap_L,
        C]."""
        eng = self.engine
        if self._table0 is None:
            X = eng._global_features()
            self._table0 = torch.cat([X, zero_pad_row(X)], 0)
        blocks = [batch if b == eng.rank
                  else eng._upload_block(batch["arrays"], b)
                  for b in range(eng.k)]
        with torch.no_grad():
            return torch.stack([padded_minibatch_forward(
                self.params, bl["adj"],
                torch.index_select(self._table0, 0, bl["frontier"]),
                model=eng.cfg.model, self_idx=bl["self_idx"])
                for bl in blocks])

    # -- request coalescing ----------------------------------------------
    def submit(self, targets) -> int:
        """Queue one "embed these targets" request; answered at `flush`."""
        targets = np.asarray(targets, np.int64).ravel()
        if targets.size == 0:
            raise ValueError("empty query")
        V = self.engine.g.num_vertices
        if targets.min() < 0 or targets.max() >= V:
            raise ValueError("target ids out of range")
        rid = self._next_rid
        self._next_rid += 1
        self._pending.append((rid, targets))
        return rid

    def flush(self) -> Dict[int, np.ndarray]:
        """Answer every pending request in one coalesced pass: dedupe the
        union of pending targets, split by owner, pack into ceil(max owned
        share / batch_size) padded rounds, serve, scatter rows back per
        request (shared targets are embedded once).  The same dict on
        every rank."""
        if not self._pending:
            return {}
        tel = self.telemetry
        t0 = time.perf_counter()
        eng = self.engine
        assignment = eng.playout.part.assignment
        cap = eng.cfg.batch_size
        requested = sum(len(tg) for _, tg in self._pending)
        with tel.span("serve_flush", requests=len(self._pending)) as flush_sp:
            seen = {}
            per_dev: List[List[int]] = [[] for _ in range(eng.k)]
            for _, tg in self._pending:
                for v in tg.tolist():
                    if v not in seen:
                        seen[v] = True
                        per_dev[int(assignment[v])].append(v)
            num_rounds = max(1, max(-(-len(x) // cap) for x in per_dev))
            # per-flush coalescing facts, on the span AND as counters
            flush_sp.set(targets_requested=requested,
                         targets_unique=len(seen), rounds=num_rounds)
            emb: Dict[int, np.ndarray] = {}
            for r in range(num_rounds):
                round_tgts = [np.asarray(x[r * cap:(r + 1) * cap], np.int64)
                              for x in per_dev]
                H = self.serve_round(self.build_round(round_tgts)).cpu().numpy()
                for d, tg in enumerate(round_tgts):
                    for j, v in enumerate(tg.tolist()):
                        emb[v] = H[d, j]
            out = {rid: np.stack([emb[int(v)] for v in tg])
                   for rid, tg in self._pending}
        self.stats.queries += len(self._pending)
        self.stats.targets += len(emb)
        dt = time.perf_counter() - t0
        self.stats.latencies_s.append(dt)
        tel.counter("serve.queries").add(len(self._pending))
        tel.counter("serve.targets_requested").add(requested)
        tel.counter("serve.targets_unique").add(len(emb))
        tel.histogram("serve.flush_latency_s").record(dt)
        self._pending = []
        return out

    def query(self, targets) -> np.ndarray:
        """Embed these targets now (one-request submit + flush)."""
        rid = self.submit(targets)
        return self.flush()[rid]
