"""Cost-model partition autotuner (the port's copy of
`repro/core/partition/autotune.py`): pick (family, cut, threshold,
execution, pipeline knobs) for a graph BEFORE training, then hold the
choice to account.

The survey's §4/§6 levers — edge-cut vs vertex-cut vs hybrid, the degree
threshold, the execution model, feature-chunking and p2p bucketing — trade
wire bytes against balance differently on every graph.  The repo's layouts
already carry exact per-step accounting (`PartitionLayout.wire_fields_per_step`
and `.device_bytes_per_step`, each locked to the engine's CommStats by the
oracle tiers), so the planner does not need heuristics ABOUT the cost: it
builds every candidate's real layout and reads the real numbers.

The flow:

  ``enumerate_plans``  builds one `CandidatePlan` per (family variant,
                       execution model): the candidate's ACTUAL layout is
                       constructed and its predicted step bytes / bottleneck
                       device bytes / layout-gauge balance claim recorded.
                       Pipeline knobs (exchange_chunks, p2p_buckets) come
                       from peak-buffer heuristics, not cost guesses.
  ``choose_plan``      argmin over the predictions (objective: the bottleneck
                       device's bytes, or the total).  Because every
                       candidate is scored by the SAME exact models the
                       engine accounts with, the chosen plan can never be
                       >= 1.5x worse in predicted critical-path bytes than
                       the best candidate — it IS the argmin.
  ``validate_plan``    the trust-but-verify stage: run a short traced dryrun
                       (telemetry enabled) on the port's engine, over the
                       ranks of the process group (one without one),
                       compare the MEASURED comm.* counter totals against
                       ``steps * predicted`` and the measured
                       layout-imbalance gauges against the plan's balance
                       claim, and raise `PlanRejected` if either drifts past
                       the bound: a plan whose accounting no longer matches
                       reality must not be acted on.
  ``autotune``         enumerate -> choose -> (optionally) validate.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.execution import collectives
from repro_torch.core.graph import Graph
from repro_torch.core.partition.layout_api import get_layout_builder
from repro_torch.core.telemetry import Telemetry


class PlanRejected(RuntimeError):
    """A validated dryrun disagreed with the plan's predictions."""


def graph_stats(g: Graph) -> Dict:
    """The degree-profile summary the planner (and its report) keys off."""
    deg = g.degree().astype(np.float64)
    if len(deg) == 0:
        return dict(num_vertices=0, num_edges=0, avg_degree=0.0,
                    max_degree=0.0, p90=0.0, p95=0.0, p99=0.0)
    return dict(
        num_vertices=int(g.num_vertices),
        num_edges=int(len(g.indices)),
        avg_degree=float(deg.mean()),
        max_degree=float(deg.max()),
        p90=float(np.percentile(deg, 90.0)),
        p95=float(np.percentile(deg, 95.0)),
        p99=float(np.percentile(deg, 99.0)),
    )


@dataclasses.dataclass
class CandidatePlan:
    """One fully-specified engine configuration plus the predictions it was
    scored by — predictions travel WITH the plan so a later validation run
    can hold the plan to exactly what enumeration claimed."""
    family: str                    # edge_cut | vertex_cut | hybrid
    execution: str                 # broadcast | ring | p2p
    k: int                         # devices the predictions were made for
    model: str = "gcn"             # the model/widths the plan was SCORED
    hidden: int = 32               #   for — engine_config() pins them so a
    num_layers: int = 2            #   validation dryrun measures the same
    #                                  exchange widths enumeration predicted
    partitioner: str = "metis_like"
    vertex_cut: str = "cartesian2d"
    hub_threshold: Optional[float] = None
    sorted_masters: bool = False
    exchange_chunks: int = 1
    p2p_buckets: int = 1
    cache_policy: str = "none"
    predicted_step_bytes: int = 0         # sum of per-step wire fields
    predicted_bottleneck_bytes: int = 0   # max over devices (critical path)
    balance_claim: Dict = dataclasses.field(default_factory=dict)
    #   gauge name -> claimed max-over-mean of the layout's per-device gauge

    def label(self) -> str:
        bits = [self.family, self.execution]
        if self.family == "edge_cut":
            bits.append(self.partitioner)
        elif self.family == "vertex_cut":
            bits.append(self.vertex_cut)
        else:
            bits.append(f"thr={self.hub_threshold}")
        return "/".join(bits)

    def engine_config(self, **overrides):
        """The EngineConfig this plan stands for (imported lazily: the
        engine imports layout_api, the planner imports both)."""
        from repro_torch.core.engine import EngineConfig
        kw = dict(partition_family=self.family, execution=self.execution,
                  model=self.model, hidden=self.hidden,
                  num_layers=self.num_layers,
                  partitioner=self.partitioner, vertex_cut=self.vertex_cut,
                  hub_threshold=self.hub_threshold,
                  sorted_masters=self.sorted_masters,
                  exchange_chunks=self.exchange_chunks,
                  p2p_buckets=self.p2p_buckets,
                  cache_policy=self.cache_policy)
        kw.update(overrides)
        return EngineConfig(**kw)


def _gauge_imbalance(lay) -> Dict:
    """max-over-mean of every device-labeled layout gauge, read through the
    SAME telemetry_gauges path the traced dryrun populates."""
    tel = Telemetry(enabled=True)
    lay.telemetry_gauges(tel)
    out = {}
    for name, labels, m in tel.metrics._iter("gauge"):
        if "device" in labels:
            g = out.setdefault(name, {})
            g[int(labels["device"])] = float(m.value)
    claim = {}
    for name, per_dev in out.items():
        vals = np.array(list(per_dev.values()), np.float64)
        mean = vals.mean()
        claim[name] = float(vals.max() / mean) if mean > 0 else 1.0
    return claim


def _pipeline_knobs(g: Graph, k: int, dims, execution: str,
                    table_budget_bytes: int) -> Tuple[int, int]:
    """Peak-buffer heuristics for the overlap knobs: chunk the exchange when
    the gathered table would exceed the budget; bucket the p2p sends when a
    single installment would."""
    peak = g.num_vertices * max(int(d) for d in dims) * 4
    chunks = max(1, int(-(-peak // table_budget_bytes)))
    buckets = 1
    if execution == "p2p" and peak > table_budget_bytes:
        buckets = min(4, 1 << (chunks - 1).bit_length())
    return chunks, buckets


def enumerate_plans(g: Graph, k: int, dims, model: str = "gcn", *,
                    partitioners=("metis_like",),
                    vertex_cuts=("cartesian2d", "libra"),
                    hub_thresholds=None,
                    executions=("broadcast", "ring", "p2p"),
                    table_budget_bytes: int = 64 << 20,
                    ) -> List[CandidatePlan]:
    """Build every candidate's REAL layout and score it with the exact
    per-step accounting the engine itself will report.  ``dims`` is the
    engine's layer-width list [D_in, hidden..., num_classes] (hidden widths
    uniform — that is the engine's layer-width shape)."""
    L = len(dims) - 1
    hidden = int(dims[1]) if L > 1 else int(dims[-1])
    stats = graph_stats(g)
    if hub_thresholds is None:
        hub_thresholds = sorted({stats["p90"], stats["p95"], stats["p99"],
                                 float("inf")})
    plans: List[CandidatePlan] = []
    variants = ([("edge_cut", dict(partitioner=p)) for p in partitioners]
                + [("vertex_cut", dict(vertex_cut=c, sorted_masters=True))
                   for c in vertex_cuts]
                + [("hybrid", dict(hub_threshold=t)) for t in hub_thresholds])
    for family, var in variants:
        for exe in executions:
            chunks, buckets = _pipeline_knobs(g, k, dims, exe,
                                              table_budget_bytes)
            plan = CandidatePlan(family=family, execution=exe, k=k,
                                 model=model, hidden=hidden, num_layers=L,
                                 exchange_chunks=chunks, p2p_buckets=buckets,
                                 **var)
            cfg = plan.engine_config()
            lay = get_layout_builder(family)(g, k, cfg)
            wf = lay.wire_fields_per_step(model, list(dims))
            db = lay.device_bytes_per_step(model, list(dims))
            plan.predicted_step_bytes = int(sum(wf.values()))
            plan.predicted_bottleneck_bytes = int(np.asarray(db).max())
            plan.balance_claim = _gauge_imbalance(lay)
            plans.append(plan)
    return plans


def choose_plan(plans: List[CandidatePlan],
                objective: str = "bottleneck") -> CandidatePlan:
    """Argmin over the recorded predictions.  ``bottleneck`` minimizes the
    busiest device's wire bytes (the critical path); ``total`` minimizes the
    summed step bytes.  The loser metric breaks ties, then enumeration order
    keeps the choice deterministic."""
    if not plans:
        raise ValueError("choose_plan: no candidate plans")
    if objective not in ("bottleneck", "total"):
        raise ValueError("objective must be 'bottleneck' or 'total'")
    if objective == "bottleneck":
        key = lambda ip: (ip[1].predicted_bottleneck_bytes,  # noqa: E731
                          ip[1].predicted_step_bytes, ip[0])
    else:
        key = lambda ip: (ip[1].predicted_step_bytes,  # noqa: E731
                          ip[1].predicted_bottleneck_bytes, ip[0])
    return min(enumerate(plans), key=key)[1]


def validate_plan(g: Graph, plan: CandidatePlan, *, steps: int = 2,
                  drift: float = 0.25, device="cuda") -> Dict:
    """Trust-but-verify: run ``steps`` traced training steps under the plan
    and hold the measurements to the plan's claims.

      * wire bytes — the summed ``comm.*`` counter totals (the telemetry
        mirror of CommStats, which the oracle tiers lock to the layouts'
        cost models) must be within ``drift`` of ``steps * predicted``;
      * balance — every layout gauge's measured max-over-mean must be within
        ``drift`` (relative) of the plan's balance claim.

    The dryrun runs on ``device`` ("cuda" unless the caller asks for the
    CPU) over the process group's ranks (`collectives.world_size()`, 1
    without a group), which must be the plan's k.  Every rank applies
    every rank's accounting, so each rank measures the same report.

    Raises `PlanRejected` on any violation; returns the measurement report
    otherwise."""
    from repro_torch.core.engine import DistGNNEngine
    n_dev = collectives.world_size()
    if n_dev != plan.k:
        raise PlanRejected(
            f"plan was scored for k={plan.k} devices but the dryrun mesh has "
            f"{n_dev}: the predictions do not transfer")
    eng = DistGNNEngine(g, cfg=plan.engine_config(), device=device)
    tel = eng.enable_telemetry()
    eng.train(steps)
    measured_fields = {name: int(tel.metrics.counter_total("comm." + name))
                       for name in eng._wire_fields}
    measured = sum(measured_fields.values())
    predicted = steps * plan.predicted_step_bytes
    report = dict(plan=plan.label(), steps=steps, predicted_bytes=predicted,
                  measured_bytes=measured, measured_fields=measured_fields,
                  ratio=(measured / predicted if predicted else
                         (1.0 if measured == 0 else float("inf"))),
                  balance=dict())
    if predicted == 0:
        if measured != 0:
            raise PlanRejected(
                f"{plan.label()}: predicted zero wire bytes but measured "
                f"{measured}")
    elif not (1.0 - drift <= report["ratio"] <= 1.0 + drift):
        raise PlanRejected(
            f"{plan.label()}: measured wire bytes {measured} vs predicted "
            f"{predicted} (ratio {report['ratio']:.3f}) drifts past "
            f"+/-{drift:.0%}")
    imb = tel.imbalance_report()["metrics"]
    for name, claimed in plan.balance_claim.items():
        got = imb.get(name, {}).get("max_over_mean")
        report["balance"][name] = dict(claimed=claimed, measured=got)
        if got is None or abs(got - claimed) > drift * max(claimed, 1.0):
            raise PlanRejected(
                f"{plan.label()}: balance gauge {name} measured {got} vs "
                f"claimed {claimed:.3f} drifts past +/-{drift:.0%}")
    return report


def autotune(g: Graph, k: int, dims, model: str = "gcn", *,
             objective: str = "bottleneck", validate: bool = True,
             steps: int = 2, drift: float = 0.25, device="cuda",
             **enum_kwargs) -> Tuple[CandidatePlan, Dict]:
    """enumerate -> choose -> (optionally) validate.  Returns the chosen
    plan and a report carrying the graph stats, the scored candidates and —
    when validated — the dryrun measurements."""
    plans = enumerate_plans(g, k, dims, model, **enum_kwargs)
    best = choose_plan(plans, objective=objective)
    report = dict(
        graph=graph_stats(g), objective=objective, chosen=best.label(),
        candidates=[dict(label=p.label(),
                         step_bytes=p.predicted_step_bytes,
                         bottleneck_bytes=p.predicted_bottleneck_bytes)
                    for p in plans])
    if validate:
        report["validation"] = validate_plan(g, best, steps=steps,
                                             drift=drift, device=device)
    return best, report
