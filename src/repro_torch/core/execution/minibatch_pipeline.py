"""Mini-batch execution schedules (the port's copy of the blocking part of
`repro/core/execution/minibatch_pipeline.py`, survey §6.1): conventional,
factored and operator-parallel, as an explicit stage scheduler with
per-stage timing.

Each runs the real sample, extract and train callables one after another
and times every stage on the host clock; ``conventional`` reports the
measured wall, ``factored`` and ``operator_parallel`` MODEL the overlap of
their lanes from the stage times (their batches, and so their results, are
the conventional schedule's).  The pipelined schedules, which execute the
overlap, arrive with their own slice.  ``telemetry`` is accepted for the
reference's signature; the port has no spans yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List


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
    t = StageTimes()
    t0 = time.perf_counter()
    for ids in batch_ids:
        s0 = time.perf_counter()
        mb = sample_fn(ids)
        t.sample += time.perf_counter() - s0
        s0 = time.perf_counter()
        feats = extract_fn(mb)
        t.extract += time.perf_counter() - s0
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
    t = StageTimes()
    prepared = []
    for ids in batch_ids:  # sampler lane
        s0 = time.perf_counter()
        prepared.append(sample_fn(ids))
        t.sample += time.perf_counter() - s0
    for mb in prepared:  # trainer lane (extract + train)
        s0 = time.perf_counter()
        feats = extract_fn(mb)
        t.extract += time.perf_counter() - s0
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


# schedule registry (`DistGNNEngine.run_epoch_minibatch` selects by name);
# every entry shares the (batch_ids, sample_fn, extract_fn, train_fn) ->
# StageTimes signature
SCHEDULES: Dict[str, Callable] = {
    "conventional": run_conventional,
    "factored": run_factored,
    "operator_parallel": run_operator_parallel,
}
