"""The port's trainable features: layer-0 rows as learnable embeddings,
updated by the row-sparse AdamW, on one rank and on four gloo ranks, held
to the JAX engine with ``trainable_features=True`` (Pallas interpret, an
Auto-axis mesh: on jax's default Explicit mesh the JAX trainable path
raises a ShardingTypeError).

The functions: `row_adamw_update` and `sparse_adamw_ids` (dedup on and
off, no ids, every row, no valid row) against `repro.optim.sparse_optim`
on seeded numpy inputs, untouched rows bitwise unchanged;
`overlay_refresh_plan`, `touched_rows_from_frontier`,
`FeatureStore.from_flat`, `embedding_update_bytes` and
`embedding_grad_bytes_per_step` equal to `repro`'s.

One rank, from the JAX engine's own initial weights: the full-graph step
for gcn and gat under the edge cut (broadcast, ring, p2p), the vertex cut
(p2p, gcn) and the hybrid cut (p2p, gat), at exchange_chunks 1 and 2; the
mini-batch step for gcn under node_wise, layer_wise and subgraph x
broadcast, ring and p2p, cache none and static_degree.  Per step the loss
and the logits, then the params and the embed, emb_m and emb_v tables
within 1e-4 of JAX's and of the port's own reference step, emb_t equal,
CommStats equal (embed_grad_bytes too), a second engine bitwise equal, the
table moved, the rows no step touched (and the rows whose gradient was 0
at every step) with their values and zero moments bitwise, the store
unchanged; then `infer_full_graph(state)` and the `publish_embeddings`
handoff.

Four gloo ranks (four CPU processes beside one JAX subprocess on four
forced host devices): the full-graph step (edge cut p2p gcn at chunks 2 and
buckets 2, vertex cut broadcast gcn, hybrid p2p sage) and the mini-batch
step on `powerlaw_graph(120, 8, seed=2)` (node_wise p2p with the
static_degree cache at 12, whose live overlay refresh is not empty and
routes the cache hits' gradients to their owners; subgraph ring; layer_wise
broadcast): the same gates on every rank, every rank's numbers equal, and
the collective calls exact, the reverse of every fetch exchange included.

gat's embedding cases run at embed_lr 0.01 and embed_eps 1e-6: a vertex
whose layer-0 gradient is zero in exact arithmetic gets fp32 noise of
~1e-10 through the softmax, and AdamW's first step maps g to
lr * g / (|g| + eps); at eps 1e-8 two correct implementations then move
such a row by up to ~3e-3 apart.  Each rank process has its own time
limit, and a rank that raises exits at once."""
import dataclasses
import json
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from conftest import run_with_devices
from repro.core.engine import DistGNNEngine as JDistGNNEngine
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.feature_store import FeatureStore as JFeatureStore
from repro.core.feature_store import (
    overlay_refresh_plan as joverlay_refresh_plan,
)
from repro.core.feature_store import (
    touched_rows_from_frontier as jtouched_rows_from_frontier,
)
from repro.core.graph import powerlaw_graph as jpowerlaw_graph
from repro.core.graph import sbm_graph as jsbm_graph
from repro.core.sampling.distributed import CommStats as JCommStats
from repro.core.sampling.distributed import (
    embedding_update_bytes as jembedding_update_bytes,
)
from repro.optim.sparse_optim import row_adamw_update as jrow_adamw_update
from repro.optim.sparse_optim import sparse_adamw_ids as jsparse_adamw_ids
from repro_torch.core.engine import EMBED_KEYS, DistGNNEngine, EngineConfig
from repro_torch.core.feature_store import (
    FeatureStore,
    overlay_refresh_plan,
    touched_rows_from_frontier,
)
from repro_torch.core.graph import powerlaw_graph, sbm_graph
from repro_torch.core.models.gnn import PARAM_KEYS, params_from_numpy
from repro_torch.core.partition.cost_models import (
    embedding_grad_bytes_per_step,
)
from repro_torch.core.partition.layout_api import EdgeCutLayout
from repro_torch.core.sampling.cache import device_cache_ids
from repro_torch.core.sampling.distributed import (
    CommStats,
    embedding_update_bytes,
)
from repro_torch.kernels.ell_spmm import ell_spmm, ell_spmm_transpose
from repro_torch.optim.sparse_optim import row_adamw_update, sparse_adamw_ids
from test_torch_distributed import _run_ranks

ORACLE_TOL = 1e-4
CPU = torch.device("cpu")
STEPS = 3
WORLD = 4
RANK_TIMEOUT = 240  # seconds, for each rank process
SBM = dict(num_vertices=96, num_blocks=8, p_in=0.08, p_out=0.01)
POWERLAW = dict(num_vertices=120, avg_degree=8, seed=2)
# the full-graph settings of every engine case, and gat's embedding
# settings (the module docstring says why)
FULL = dict(hidden=16, lr=0.3, embed_lr=0.05, trainable_features=True)
GAT_EMBED = dict(embed_lr=0.01, embed_eps=1e-6)
MB = dict(hidden=16, num_layers=2, batch_size=8, fanouts=(3, 3),
          layer_sizes=(16, 16), walk_length=3, lr=0.3, embed_lr=0.05,
          trainable_features=True)
HP = dict(lr=0.05, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tiny tensors: more only
    contend with the other test workers' processes on a shared host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(ours, theirs, what=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               atol=ORACLE_TOL, rtol=0, err_msg=what)


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------


def _table(seed, N=24, D=5):
    rng = np.random.default_rng(seed)
    return (rng, rng.standard_normal((N, D)).astype(np.float32),
            (0.1 * rng.standard_normal((N, D))).astype(np.float32),
            (0.1 * np.abs(rng.standard_normal((N, D)))).astype(np.float32),
            rng.integers(0, 4, N).astype(np.int32))


@pytest.mark.parametrize("touched", ["all", "none", "some"])
def test_row_adamw_update_matches_the_reference(touched):
    rng, p, m, v, t = _table(0)
    N = len(p)
    g = rng.standard_normal(p.shape).astype(np.float32)
    tch = {"all": np.ones(N, bool), "none": np.zeros(N, bool),
           "some": rng.random(N) < 0.5}[touched]
    ours = row_adamw_update(*map(torch.from_numpy, (p, g, m, v, t)),
                            torch.from_numpy(tch.astype(np.float32)), **HP)
    theirs = jrow_adamw_update(*map(jnp.asarray, (p, g, m, v, t)),
                               jnp.asarray(tch.astype(np.float32)), **HP)
    for a, b, x in zip(ours, theirs, (p, m, v, t)):
        assert a.numpy().dtype == np.asarray(b).dtype == x.dtype
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)
        assert np.array_equal(a.numpy()[~tch], x[~tch])  # bitwise frozen
        if tch.any():
            assert not np.array_equal(a.numpy()[tch], x[tch])
    assert np.array_equal(ours[3].numpy(), t + tch)


SPARSE_CASES = {
    "distinct": (np.array([3, 7, 24, 19, 0, 11], np.int64), False),
    "dedup": (np.array([3, 7, 3, 24, 19, 0, 7, 7], np.int64), True),
    "empty": (np.zeros(0, np.int64), False),
    "every_row": (np.arange(24)[::-1].copy(), False),
    "no_valid_row": (np.full(5, 24, np.int64), True),
}


@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_sparse_adamw_ids_matches_the_reference(case):
    ids, dedup = SPARSE_CASES[case]
    rng, p, m, v, t = _table(1)
    N = len(p)
    grads = rng.standard_normal((len(ids), p.shape[1])).astype(np.float32)
    ours = sparse_adamw_ids(*map(torch.from_numpy, (p, m, v, t, ids, grads)),
                            dedup=dedup, **HP)
    theirs = jsparse_adamw_ids(*map(jnp.asarray, (p, m, v, t, ids, grads)),
                               dedup=dedup, **HP)
    applied = np.zeros(N, bool)
    applied[ids[ids < N]] = True
    for a, b, x in zip(ours, theirs, (p, m, v, t)):
        assert a.shape == x.shape and a.numpy().dtype == x.dtype
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)
        assert np.array_equal(a.numpy()[~applied], x[~applied])
    assert np.array_equal(ours[3].numpy(), t + applied)
    # an explicit ``valid`` (a subset of the real entries) drops the rest
    valid = (np.arange(len(ids)) % 2 == 0) & (ids < N)
    ours = sparse_adamw_ids(*map(torch.from_numpy, (p, m, v, t, ids, grads)),
                            valid=torch.from_numpy(valid), dedup=dedup, **HP)
    theirs = jsparse_adamw_ids(*map(jnp.asarray, (p, m, v, t, ids, grads)),
                               valid=jnp.asarray(valid), dedup=dedup, **HP)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("buckets", [1, 2])
def test_overlay_plan_touched_rows_and_byte_models_match(buckets):
    """The live overlay's plan, the touched-row lists and the trainable
    byte models equal `repro`'s on the static_degree overlay of a
    power-law graph at k = 4."""
    g, k = powerlaw_graph(**POWERLAW), 4
    lay = EdgeCutLayout(g, k, EngineConfig(execution="broadcast",
                                           partitioner="hash"))
    part, nb, new_of_old = lay.part, lay.nb, lay.new_of_old
    cache = [device_cache_ids(g, part.assignment, d, "static_degree", 12)
             for d in range(k)]
    sids = [new_of_old[a] for a in cache]
    assert all(len(a) for a in sids)
    ours = overlay_refresh_plan(sids, k, nb, 12, buckets=buckets)
    theirs = joverlay_refresh_plan(sids, k, nb, 12, buckets=buckets)
    assert np.array_equal(ours[0], theirs[0])
    assert np.array_equal(ours[1], theirs[1])
    assert ours[2] == theirs[2] and (len(ours[2]) > 1) == (buckets > 1)
    rng = np.random.default_rng(buckets)
    frontier = rng.integers(0, k * nb + 1, (k, 40))
    assert np.array_equal(touched_rows_from_frontier(frontier, k, nb, nb),
                          jtouched_rows_from_frontier(frontier, k, nb, nb))
    with pytest.raises(ValueError, match="cap overflow"):
        touched_rows_from_frontier(frontier, k, nb, 1)
    flat = rng.standard_normal((k * nb, 3)).astype(np.float32)
    ids = np.array([0, nb - 1, nb, k * nb - 1, k * nb])
    store = FeatureStore.from_flat(flat, k, CPU)
    assert (store.k, store.rows, store.dim) == (k, nb, 3)
    assert np.array_equal(store.flat(), flat)
    assert np.array_equal(store.lookup(ids),
                          JFeatureStore.from_flat(flat, k).lookup(ids))
    for d in range(k):
        verts = rng.integers(0, g.num_vertices, 30)
        stats, jstats = CommStats(), JCommStats()
        b = embedding_update_bytes(part, d, verts, 32, cache[d],
                                   overlay_rows=len(cache[d]), stats=stats)
        jb = jembedding_update_bytes(part, d, verts, 32, cache[d],
                                     overlay_rows=len(cache[d]), stats=jstats)
        assert b == jb == stats.embed_grad_bytes == jstats.embed_grad_bytes
        assert b > 2 * len(cache[d]) * 32 * 4
    dims = [32, 16, 5]
    for execution in ("broadcast", "p2p"):
        assert embedding_grad_bytes_per_step(
            g, execution, dims, k=k, part=part, nb=nb) == (
            k * (k - 1) * nb if execution == "broadcast"
            else part.communication_volume(g)) * dims[0] * 4


# ---------------------------------------------------------------------------
# one rank: the full-graph step
# ---------------------------------------------------------------------------

MESH1 = None


def _mesh1():
    global MESH1
    if MESH1 is None:
        MESH1 = jax.make_mesh((1,), ("w",), axis_types=(AxisType.Auto,))
    return MESH1


def _full_cfg(model, family, execution, chunks):
    kw = dict(FULL, model=model, partition_family=family, execution=execution,
              exchange_chunks=chunks, partitioner="hash")
    if model == "gat":
        kw.update(GAT_EMBED)
    return kw


FULL_CASES = ([(m, "edge_cut", e, c) for m in ("gcn", "gat")
               for e in ("broadcast", "ring", "p2p") for c in (1, 2)]
              + [("gcn", "vertex_cut", "p2p", c) for c in (1, 2)]
              + [("gat", "hybrid", "p2p", c) for c in (1, 2)])


def _port_full(kw, params):
    """STEPS steps and, beside them from the same initial state, STEPS
    reference steps; then `train` for CommStats."""
    eng = DistGNNEngine(sbm_graph(**SBM), EngineConfig(**kw), device=CPU)
    store0 = eng.store.flat().copy()
    state = ref_state = eng.init_state(params)
    embed0 = state["embed"].clone()
    assert state["embed"].data_ptr() != eng.store.device_table().data_ptr()
    step, ref_step = eng.make_step(), eng.make_reference_step()
    out = dict(losses=[], logits=[], ref_losses=[], ref_logits=[],
               zero_grad=torch.ones(eng.Vp, dtype=torch.bool))
    for _ in range(STEPS):
        state, metrics, logits = step(state)
        ref_state, ref_metrics, ref_logits = ref_step(ref_state)
        out["losses"].append(float(metrics["loss"]))
        out["logits"].append(logits.numpy())
        out["ref_losses"].append(float(ref_metrics["loss"]))
        out["ref_logits"].append(ref_logits.numpy())
        out["zero_grad"] &= (state["emb_m"] == 0).all(1)
    assert np.array_equal(eng.store.flat(), store0)
    assert torch.equal(eng.store.device_table(), torch.from_numpy(store0))
    eng.train(STEPS)
    out.update(eng=eng, state=state, ref_state=ref_state, embed0=embed0,
               comm=dataclasses.asdict(eng.comm_stats))
    return out


def _hold_embed(run, jstate, touched, what):
    """The embedding gates of one run against JAX's final state."""
    for key in ("embed", "emb_m", "emb_v"):
        _close(run["state"][key], jstate[key], f"{what} {key}")
        _close(run["ref_state"][key], jstate[key], f"{what} reference {key}")
    assert np.array_equal(run["state"]["emb_t"].numpy(),
                          np.asarray(jstate["emb_t"]))
    assert np.array_equal(run["ref_state"]["emb_t"].numpy(),
                          np.asarray(jstate["emb_t"]))
    state, embed0 = run["state"], run["embed0"]
    moved = (state["embed"] != embed0).any(1)
    assert bool(moved.any()), f"{what}: the table did not move"
    # rows no step touched: values and zero moments bit for bit
    frozen = ~touched
    assert torch.equal(state["embed"][frozen], embed0[frozen])
    for key in ("emb_m", "emb_v", "emb_t"):
        assert not state[key][frozen].any(), key


@pytest.mark.parametrize("case", FULL_CASES,
                         ids=["-".join(map(str, c)) for c in FULL_CASES])
def test_one_rank_full_graph_matches_jax_and_its_reference(case):
    model, family, execution, chunks = case
    kw = _full_cfg(*case)
    jeng = JDistGNNEngine(jsbm_graph(**SBM), mesh=_mesh1(),
                          cfg=JEngineConfig(interpret=True, **kw))
    jstate = jeng.init_state()
    params = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]),
                               CPU)
    jstep = jeng.make_step()
    jlosses, jlogits = [], []
    for _ in range(STEPS):
        jstate, jm, jl = jstep(jstate)
        jlosses.append(float(jm["loss"]))
        jlogits.append(np.asarray(jl))
    jeng.train(STEPS)
    launches = (ell_spmm.launches, ell_spmm_transpose.launches)
    run, again = _port_full(kw, params), _port_full(kw, params)
    assert (ell_spmm.launches, ell_spmm_transpose.launches) == launches
    eng = run["eng"]
    np.testing.assert_array_equal(eng.emb_touched,
                                  np.asarray(jeng.emb_touched))
    _close(run["losses"], jlosses, "losses")
    _close(run["ref_losses"], jlosses, "reference losses")
    for ours, ref, theirs in zip(run["logits"], run["ref_logits"], jlogits):
        _close(ours, theirs, "logits")
        _close(ref, theirs, "reference logits")
    for ours, ref, theirs in zip(run["state"]["params"]["layers"],
                                 run["ref_state"]["params"]["layers"],
                                 jstate["params"]["layers"]):
        for key in PARAM_KEYS[model]:
            _close(ours[key], theirs[key], key)
            _close(ref[key], theirs[key], f"reference {key}")
    touched = torch.from_numpy(eng.emb_touched > 0)
    _hold_embed(run, jstate, touched, "-".join(map(str, case)))
    # a row whose gradient was 0 at every step keeps its value bit for bit
    still = run["zero_grad"]
    assert torch.equal(run["state"]["embed"][still], run["embed0"][still])
    assert run["comm"] == dataclasses.asdict(jeng.comm_stats)
    assert eng._emb_bytes_per_step == jeng._emb_bytes_per_step
    assert run["losses"] == again["losses"]
    for a, b in zip(run["logits"] + run["ref_logits"],
                    again["logits"] + again["ref_logits"]):
        assert np.array_equal(a, b)
    for key in EMBED_KEYS:
        assert torch.equal(run["state"][key], again["state"][key]), key
    for a, b in zip(run["state"]["params"]["layers"],
                    again["state"]["params"]["layers"]):
        assert all(torch.equal(a[key], b[key]) for key in a)


def test_trainable_inference_and_the_publish_handoff():
    """After training, `infer_full_graph(state)` is within 1e-4 of JAX's
    and of the reference sweep over the trained table; the store is the
    untrained table until `publish_embeddings`, which writes the trained
    rows, after which a frozen engine on that table sweeps what the
    trainable one does (`test_serving.py::test_publish_embeddings_handoff`);
    a trainable sweep without a state is refused."""
    kw = _full_cfg("gcn", "edge_cut", "p2p", 1)
    jeng = JDistGNNEngine(jsbm_graph(**SBM), mesh=_mesh1(),
                          cfg=JEngineConfig(interpret=True, **kw))
    jstate = jeng.init_state()
    params = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]),
                               CPU)
    for _ in range(2):
        jstate, _, _ = jeng.make_step()(jstate)
    g = sbm_graph(**SBM)
    eng = DistGNNEngine(g, EngineConfig(**kw), device=CPU)
    store0 = eng.store.flat().copy()
    state = eng.init_state(params)
    for _ in range(2):
        state, _, _ = eng.make_step()(state)
    H = eng.infer_full_graph(state)
    _close(H, jeng.infer_full_graph(jstate), "sweep")
    _close(H, eng.infer_full_graph(state, reference=True), "reference sweep")
    _close(H, eng.infer_full_graph(params=state["params"], state=state),
           "params=")
    with pytest.raises(ValueError, match="pass state="):
        eng.infer_full_graph(params=state["params"])
    assert np.array_equal(eng.store.flat(), store0)
    eng.publish_embeddings(state)
    assert np.array_equal(eng.store.flat(), state["embed"].numpy())
    assert torch.equal(eng.store.device_table(), state["embed"])
    frozen = DistGNNEngine(g, dataclasses.replace(
        eng.cfg, trainable_features=False), device=CPU)
    frozen.store.update_rows(np.arange(frozen.store.num_rows),
                             eng.store.flat())
    H_serve = frozen.infer_full_graph(params=state["params"])
    assert float((H - H_serve).abs().max()) <= 1e-5
    with pytest.raises(ValueError, match="protocol='sync'"):
        DistGNNEngine(g, dataclasses.replace(eng.cfg, protocol="variation"),
                      device=CPU)


# ---------------------------------------------------------------------------
# one rank: the mini-batch step
# ---------------------------------------------------------------------------

MB_CASES = [(b, e, cache) for b in ("node_wise", "layer_wise", "subgraph")
            for e in ("broadcast", "ring", "p2p")
            for cache in ("none", "static_degree")]


def _mb_cfg(batching, execution, cache, **extra):
    return dict(MB, model="gcn", batching=batching, execution=execution,
                exchange_chunks=2 if execution == "p2p" else 1,
                p2p_buckets=2, partitioner="hash", cache_policy=cache,
                cache_capacity=12 if cache != "none" else 0, **extra)


def _port_mb(kw, params):
    eng = DistGNNEngine(sbm_graph(**SBM), EngineConfig(**kw), device=CPU)
    store0 = eng.store.flat().copy()
    step, ref_step = (eng.make_minibatch_step(),
                      eng.make_reference_minibatch_step())
    state = ref_state = eng.init_minibatch_state(params)
    embed0 = state["embed"].clone()
    eng.comm_stats.reset()
    out = dict(losses=[], logits=[], ref_losses=[], ref_logits=[],
               touched=torch.zeros(eng.Vp, dtype=torch.bool))
    for i in range(STEPS):
        batch = eng.sample_minibatch(i)
        ids = batch["emb_ids"]
        out["touched"][ids[ids < eng.nb]] = True
        state, metrics, logits = step(state, batch)
        ref_state, ref_metrics, ref_logits = ref_step(ref_state, batch)
        out["losses"].append(float(metrics["loss"]))
        out["logits"].append(logits.numpy())
        out["ref_losses"].append(float(ref_metrics["loss"]))
        out["ref_logits"].append(ref_logits.numpy())
    assert np.array_equal(eng.store.flat(), store0)
    out.update(eng=eng, state=state, ref_state=ref_state, embed0=embed0,
               comm=dataclasses.asdict(eng.comm_stats))
    return out


@pytest.mark.parametrize("case", MB_CASES,
                         ids=["-".join(c) for c in MB_CASES])
def test_one_rank_minibatch_matches_jax_and_its_reference(case):
    kw = _mb_cfg(*case)
    jeng = JDistGNNEngine(jsbm_graph(**SBM), mesh=_mesh1(),
                          cfg=JEngineConfig(interpret=True, **kw))
    jstate = jeng.init_minibatch_state()
    params = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]),
                               CPU)
    jstep = jeng.make_minibatch_step()
    jeng.comm_stats.reset()
    jlosses, jlogits = [], []
    for i in range(STEPS):
        jstate, jm, jl = jstep(jstate, jeng.sample_minibatch(i))
        jlosses.append(float(jm["loss"]))
        jlogits.append(np.asarray(jl))
    run, again = _port_mb(kw, params), _port_mb(kw, params)
    eng = run["eng"]
    assert eng.tcap == jeng.tcap and list(eng.caps) == list(jeng.caps)
    _close(run["losses"], jlosses, "losses")
    _close(run["ref_losses"], jlosses, "reference losses")
    for ours, ref, theirs in zip(run["logits"], run["ref_logits"], jlogits):
        _close(ours, theirs, "logits")
        _close(ref, theirs, "reference logits")
    for ours, ref, theirs in zip(run["state"]["params"]["layers"],
                                 run["ref_state"]["params"]["layers"],
                                 jstate["params"]["layers"]):
        for key in ("w", "b"):
            _close(ours[key], theirs[key], key)
            _close(ref[key], theirs[key], f"reference {key}")
    touched = run["touched"]
    assert bool((~touched).any()), "every row was touched"
    assert torch.equal(run["state"]["emb_t"] > 0, touched)
    _hold_embed(run, jstate, touched, "-".join(case))
    assert run["comm"] == dataclasses.asdict(jeng.comm_stats)
    assert run["losses"] == again["losses"]
    for a, b in zip(run["logits"] + run["ref_logits"],
                    again["logits"] + again["ref_logits"]):
        assert np.array_equal(a, b)
    for key in EMBED_KEYS:
        assert torch.equal(run["state"][key], again["state"][key]), key


def test_minibatch_schedules_and_train_with_trainable_features():
    """The blocking and pipelined schedules (thread and process) of a
    trainable engine give the step loop's losses and tables bit for bit;
    `train` and `train(reference=True)` run from the trainable states."""
    kw = _mb_cfg("node_wise", "p2p", "none")
    eng = DistGNNEngine(sbm_graph(**SBM), EngineConfig(**kw), device=CPU)
    run = _port_mb(kw, None)
    for schedule, mode in (("conventional", None), ("factored", None),
                           ("pipelined", "thread"), ("pipelined", "process")):
        state, losses, _ = eng.run_epoch_minibatch(
            STEPS, schedule, prefetch_mode=mode)
        assert losses == run["losses"], (schedule, mode)
        for key in EMBED_KEYS:
            assert torch.equal(state[key], run["state"][key]), key
        assert dataclasses.asdict(eng.comm_stats) == run["comm"]
    eng.close_prefetch_pool()
    losses, _ = eng.train(STEPS)
    assert losses == run["losses"]
    ref_losses, _ = eng.train(STEPS, reference=True)
    assert ref_losses == run["ref_losses"]


# ---------------------------------------------------------------------------
# four gloo ranks against JAX on four forced host devices
# ---------------------------------------------------------------------------


def _four(model, batching, execution, family="edge_cut", chunks=1,
          buckets=1, cache="none", graph="sbm", partitioner="hash"):
    return dict(model=model, batching=batching, execution=execution,
                family=family, chunks=chunks, buckets=buckets, cache=cache,
                graph=graph, partitioner=partitioner)


# metis_like's unequal parts leave pad rows, which no step touches
FOUR = [_four("gcn", "full_graph", "p2p", chunks=2, buckets=2,
              partitioner="metis_like"),
        _four("gcn", "full_graph", "broadcast", family="vertex_cut"),
        _four("sage", "full_graph", "p2p", family="hybrid"),
        _four("gcn", "node_wise", "p2p", cache="static_degree",
              graph="powerlaw"),
        _four("gcn", "subgraph", "ring", graph="powerlaw"),
        _four("gcn", "layer_wise", "broadcast", graph="powerlaw")]
FOUR_TAGS = [f"{c['model']}-{c['family']}-{c['batching']}-{c['execution']}"
             for c in FOUR]

_CONFIG_CODE = """
def config(c, cls, **extra):
    kw = dict(model=c["model"], batching=c["batching"],
              execution=c["execution"], partition_family=c["family"],
              exchange_chunks=c["chunks"], p2p_buckets=c["buckets"],
              partitioner=c["partitioner"], cache_policy=c["cache"],
              cache_capacity=12 if c["cache"] != "none" else 0,
              trainable_features=True, lr=0.3, embed_lr=0.05, hidden=16,
              **extra)
    if c["batching"] != "full_graph":
        kw.update(num_layers=2, batch_size=8, fanouts=(3, 3),
                  layer_sizes=(16, 16), walk_length=3)
    return cls(**kw)
"""

_JAX_CODE = """
import dataclasses, json
import jax, numpy as np
from jax.sharding import AxisType
from repro.core.engine import DistGNNEngine, EngineConfig
from repro.core.graph import powerlaw_graph, sbm_graph
{config}
configs, tags, graphs, steps, out_path = json.loads({args!r})
mesh = jax.make_mesh((4,), ("w",), axis_types=(AxisType.Auto,))
built = dict(sbm=sbm_graph(**graphs["sbm"]),
             powerlaw=powerlaw_graph(**graphs["powerlaw"]))
out = {{}}
for c, tag in zip(configs, tags):
    eng = DistGNNEngine(built[c["graph"]], mesh=mesh,
                        cfg=config(c, EngineConfig, interpret=True))
    full = c["batching"] == "full_graph"
    state = eng.init_state() if full else eng.init_minibatch_state()
    for l, p in enumerate(state["params"]["layers"]):
        for key, a in p.items():
            out[f"{{tag}}/init/{{l}}/{{key}}"] = np.asarray(a)
    out[f"{{tag}}/embed0"] = np.asarray(state["embed"])
    eng.comm_stats.reset()
    step = eng.make_step() if full else eng.make_minibatch_step()
    for i in range(steps):
        if full:
            state, metrics, logits = step(state)
        else:
            state, metrics, logits = step(state, eng.sample_minibatch(i))
        out[f"{{tag}}/loss/{{i}}"] = np.array(float(metrics["loss"]))
        out[f"{{tag}}/logits/{{i}}"] = np.asarray(logits)
    for l, p in enumerate(state["params"]["layers"]):
        for key, a in p.items():
            out[f"{{tag}}/final/{{l}}/{{key}}"] = np.asarray(a)
    for key in ("embed", "emb_m", "emb_v", "emb_t"):
        out[f"{{tag}}/{{key}}"] = np.asarray(state[key])
    if full:
        eng.train(steps)
    out[f"{{tag}}/comm"] = np.array(json.dumps(
        dataclasses.asdict(eng.comm_stats)))
np.savez(out_path, **out)
print("JAX DONE", len(configs))
"""

_RANK_CODE = """
import dataclasses, json, os, sys, traceback
try:
    import numpy as np
    import torch
    from repro_torch.core.engine import DistGNNEngine, EngineConfig
    from repro_torch.core.execution import collectives
    from repro_torch.core.graph import powerlaw_graph, sbm_graph
    from repro_torch.core.models.gnn import PARAM_KEYS, params_from_numpy
{config}
    (configs, tags, graphs, steps, rank, world, tmp, init_path,
     out_path) = json.loads(sys.argv[1])
    collectives.init_group(f"file://{{tmp}}/rendezvous", world, rank, "cpu")
    built = dict(sbm=sbm_graph(**graphs["sbm"]),
                 powerlaw=powerlaw_graph(**graphs["powerlaw"]))
    given = np.load(init_path)
    out = {{}}

    def plan(eng):
        # what the collective counts depend on
        lay, c = eng.playout, eng.cfg
        out = dict(L=len(eng.dims) - 1, C=c.exchange_chunks, k=eng.k)
        if c.batching != "full_graph":
            out["B"] = len(eng.fcap_widths) if c.execution == "p2p" else 0
            out["B_ov"] = len(eng._ov_send) if eng._has_overlay else 0
            out["has_overlay"] = bool(eng._has_overlay)
        elif c.partition_family == "edge_cut":
            out["B"] = len(lay.p2p_widths) if c.execution == "p2p" else 0
        else:
            out["S"] = (sum(lay._vc_plan[key].shape[1]
                            for key in ("send1", "send2"))
                        if lay.sync_active and c.execution == "p2p" else 0)
            out["sync"] = bool(lay.sync_active)
            out["Bh"] = (len(lay.halo_widths) if lay.halo_active
                         and c.execution == "p2p" else 0)
            out["halo"] = bool(lay.halo_active)
        return out

    def run(c, tag):
        eng = DistGNNEngine(built[c["graph"]], config(c, EngineConfig),
                            device="cpu")
        full = c["batching"] == "full_graph"
        L = len(eng.dims) - 1
        params = params_from_numpy({{"layers": [
            {{key: given[f"{{tag}}/init/{{l}}/{{key}}"]
             for key in PARAM_KEYS[c["model"]]}} for l in range(L)]}},
            eng.device)
        store0 = eng.store.flat().copy()
        if full:
            step, ref_step = eng.make_step(), eng.make_reference_step()
            state = eng.init_state(params)
            ref_state = eng.init_state(params, reference=True)
        else:
            step = eng.make_minibatch_step()
            ref_step = eng.make_reference_minibatch_step()
            state = eng.init_minibatch_state(params)
            ref_state = eng.init_minibatch_state(params, reference=True)
            eng.comm_stats.reset()
            batches = [eng.sample_minibatch(i) for i in range(steps)]
        # the rows whose values no step may change: the pad rows (no
        # vertex's replica slot under the replica families; a replica
        # takes its master's delta); under mini-batch the JAX run's rows
        # with no update
        own = slice(eng.rank * eng.nb, (eng.rank + 1) * eng.nb)
        vids = eng.playout.ref_vert_ids
        pads = (eng.emb_touched[own] == 0 if vids is None
                else vids.reshape(-1)[own] == eng.g.num_vertices)
        res = dict(embed0=state["embed"].numpy().copy(), pads=pads,
                   plan=np.array(json.dumps(plan(eng))))
        collectives.zero_calls()
        logits_rows = []
        for i in range(steps):
            if full:
                state, metrics, logits = step(state)
            else:
                state, metrics, logits = step(state, batches[i])
            res[f"loss/{{i}}"] = np.array(float(metrics["loss"]))
            logits_rows.append(logits)
        calls = collectives.read_calls()
        for i, lg in enumerate(logits_rows):
            res[f"logits/{{i}}"] = (eng.gather_rows(lg) if full else
                                   eng.gather_rows(lg[0]).view(
                                       eng.k, *lg.shape[1:])).numpy()
        collectives.zero_calls()
        for i in range(steps):
            if full:
                ref_state, ref_metrics, ref_logits = ref_step(ref_state)
            else:
                ref_state, ref_metrics, ref_logits = ref_step(ref_state,
                                                              batches[i])
            res[f"ref_loss/{{i}}"] = np.array(float(ref_metrics["loss"]))
            res[f"ref_logits/{{i}}"] = ref_logits.numpy()
        res["calls"] = np.array(json.dumps(dict(
            steps=calls, ref=collectives.read_calls())))
        for name, st in (("", state), ("ref_", ref_state)):
            for l, p in enumerate(st["params"]["layers"]):
                for key, a in p.items():
                    res[f"{{name}}final/{{l}}/{{key}}"] = a.numpy()
            for key in ("embed", "emb_m", "emb_v", "emb_t"):
                res[f"{{name}}{{key}}"] = st[key].numpy()
        res["store_unchanged"] = np.array(
            np.array_equal(eng.store.flat(), store0))
        if full:
            res["sweep"] = eng.infer_full_graph(state).numpy()
            res["ref_sweep"] = eng.infer_full_graph(
                state, reference=True).numpy()
            eng.train(steps)
        res["comm"] = np.array(json.dumps(dataclasses.asdict(
            eng.comm_stats)))
        return res

    for c, tag in zip(configs, tags):
        for run_i in (0, 1):  # a second engine and run: bitwise equal
            for name, a in run(c, tag).items():
                out[f"{{tag}}/{{run_i}}/{{name}}"] = a
    collectives.destroy_group()
    np.savez(out_path, **out)
except BaseException:
    traceback.print_exc()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(1)
"""


def _indent(code, n):
    return "".join(" " * n + line if line.strip() else line
                   for line in code.splitlines(True))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX on 4 host devices and the port on 4 gloo ranks, run together;
    the ranks start from the JAX run's own initial weights, drawn here
    with the reference's `init_gnn_params` and the seed's key (the JAX run
    writes its weights too, and they must be the same)."""
    from repro.core.models.gnn import init_gnn_params as jinit_gnn_params

    tmp = tmp_path_factory.mktemp("torch_embeddings")
    graphs = dict(sbm=SBM, powerlaw=POWERLAW)
    built = dict(sbm=jsbm_graph(**SBM), powerlaw=jpowerlaw_graph(**POWERLAW))
    init = {}
    for c, tag in zip(FOUR, FOUR_TAGS):
        g = built[c["graph"]]
        L = 2
        dims = ([g.features.shape[1]] + [16] * (L - 1)
                + [int(g.labels.max()) + 1])
        tree = jinit_gnn_params(c["model"], dims, jax.random.PRNGKey(0))
        for l, p in enumerate(tree["layers"]):
            for key, a in p.items():
                init[f"{tag}/init/{l}/{key}"] = np.asarray(a)
    init_path = str(tmp / "init.npz")
    np.savez(init_path, **init)
    jax_path = str(tmp / "jax.npz")
    code = _JAX_CODE.format(config=_CONFIG_CODE, args=json.dumps(
        [FOUR, FOUR_TAGS, graphs, STEPS, jax_path]))
    jax_error = []

    def jax_side():
        try:
            run_with_devices(code, n_devices=WORLD, timeout=RANK_TIMEOUT)
        except BaseException as e:  # re-raised below, in the test's thread
            jax_error.append(e)

    jax_thread = threading.Thread(target=jax_side)
    jax_thread.start()
    rank_code = _RANK_CODE.format(config=_indent(_CONFIG_CODE, 4))
    rank_paths = [str(tmp / f"rank{r}.npz") for r in range(WORLD)]
    try:
        _run_ranks([[sys.executable, "-c", rank_code, json.dumps([
            FOUR, FOUR_TAGS, graphs, STEPS, r, WORLD, str(tmp), init_path,
            rank_paths[r]])] for r in range(WORLD)], timeout=RANK_TIMEOUT)
    finally:
        jax_thread.join()
    if jax_error:
        raise jax_error[0]
    return dict(init=init, jax=dict(np.load(jax_path)),
                ranks=[dict(np.load(p)) for p in rank_paths])


def _jx(runs, tag):
    return {key[len(tag) + 1:]: a for key, a in runs["jax"].items()
            if key.startswith(tag + "/")}


@pytest.mark.parametrize("i", range(len(FOUR)), ids=FOUR_TAGS)
def test_four_ranks_match_jax_and_the_port_reference(runs, i):
    """Per step the loss and every rank's logits, the final params, this
    rank's rows of embed, emb_m and emb_v within 1e-4 of JAX's (and the
    reference step's whole tables), emb_t equal; the table moved, the rows
    no step touched frozen bit for bit with zero moments, the store
    unchanged; full graph: the sweep over the trained state within 1e-4 of
    the reference sweep."""
    c, tag = FOUR[i], FOUR_TAGS[i]
    jx = _jx(runs, tag)
    for key, a in runs["init"].items():  # the JAX run's own weights
        if key.startswith(tag + "/"):
            assert np.array_equal(jx[key[len(tag) + 1:]], a), key
    Vp = jx["embed"].shape[0]
    nb = Vp // WORLD
    for r, res in enumerate(runs["ranks"]):
        run = f"{tag}/0"
        own = slice(r * nb, (r + 1) * nb)
        for s in range(STEPS):
            for pre in ("", "ref_"):
                _close(res[f"{run}/{pre}loss/{s}"], jx[f"loss/{s}"],
                       f"{tag} {pre}loss")
                assert res[f"{run}/{pre}logits/{s}"].shape == \
                    jx[f"logits/{s}"].shape
                _close(res[f"{run}/{pre}logits/{s}"], jx[f"logits/{s}"],
                       f"{tag} {pre}logits")
        for pre in ("", "ref_"):
            for key in [k for k in res if k.startswith(f"{run}/{pre}final/")]:
                _close(res[key], jx["final/" + key.split("final/")[1]],
                       f"{tag} {key}")
        for key in ("embed", "emb_m", "emb_v"):
            _close(res[f"{run}/{key}"], jx[key][own], f"{tag} {key}")
            _close(res[f"{run}/ref_{key}"], jx[key], f"{tag} ref {key}")
        assert np.array_equal(res[f"{run}/emb_t"], jx["emb_t"][own])
        assert np.array_equal(res[f"{run}/ref_emb_t"], jx["emb_t"])
        embed0, embed = res[f"{run}/embed0"], res[f"{run}/embed"]
        assert np.array_equal(embed0, jx["embed0"][own])
        assert (embed != embed0).any(), f"{tag}: rank {r}'s rows did not move"
        untouched = jx["emb_t"][own] == 0
        frozen = (untouched if c["batching"] != "full_graph"
                  else res[f"{run}/pads"])
        assert np.array_equal(embed[frozen], embed0[frozen])
        for key in ("emb_m", "emb_v", "emb_t"):
            assert not res[f"{run}/{key}"][untouched].any(), key
        assert bool(res[f"{run}/store_unchanged"])
        if c["batching"] == "full_graph":
            _close(res[f"{run}/sweep"], res[f"{run}/ref_sweep"],
                   f"{tag} sweep")
    assert (jx["emb_t"] > 0).any()
    # rows no step updated: pads, non-masters, rows no frontier read
    assert (jx["emb_t"] == 0).any()


@pytest.mark.parametrize("i", range(len(FOUR)), ids=FOUR_TAGS)
def test_four_ranks_agree_rerun_bitwise_and_count_collectives(runs, i):
    """Every rank reports the same loss, logits and params; a second
    engine's run is bitwise equal to the first on every rank; CommStats
    equal JAX's; the collectives are counted exactly, the reverse of every
    exchange that feeds the layer-0 rows included; the references call
    none."""
    c, tag = FOUR[i], FOUR_TAGS[i]
    first = runs["ranks"][0]
    shared = [key[len(tag) + 3:] for key in first
              if key.startswith(f"{tag}/0/") and ("loss" in key
                                                  or "logits" in key
                                                  or "final" in key
                                                  or key.endswith("/comm")
                                                  or "ref_" in key)]
    assert len(shared) > 10
    for res in runs["ranks"]:
        for name in shared:
            assert np.array_equal(res[f"{tag}/0/{name}"],
                                  first[f"{tag}/0/{name}"]), name
        for key in [k for k in res if k.startswith(f"{tag}/0/")]:
            again = f"{tag}/1/" + key[len(tag) + 3:]
            assert np.array_equal(res[key], res[again]), key
    jcomm = json.loads(str(runs["jax"][f"{tag}/comm"]))
    none = dict(all_gather=0, reduce_scatter=0, all_to_all=0, ppermute=0,
                all_reduce=0)
    for res in runs["ranks"]:
        comm = json.loads(str(res[f"{tag}/0/comm"]))
        assert comm == jcomm
        assert comm["embed_grad_bytes"] > 0
        p = json.loads(str(res[f"{tag}/0/plan"]))
        T, L, C, k = STEPS, p["L"], p["C"], p["k"]
        ex = c["execution"]
        if c["batching"] != "full_graph":
            if ex == "broadcast":
                want = dict(all_gather=C * T, reduce_scatter=C * T)
            elif ex == "ring":
                want = dict(ppermute=2 * (k - 1) * T)
            else:
                want = dict(all_to_all=2 * (C * p["B"] + p["B_ov"]) * T)
            assert p.get("has_overlay", False) == (c["cache"] != "none")
            if c["cache"] != "none":
                assert p["B_ov"] > 0 and comm["cache_hit_bytes"] > 0
        elif c["family"] == "edge_cut":
            want = (dict(all_to_all=2 * L * C * p["B"] * T) if ex == "p2p"
                    else dict(all_gather=L * C * T,
                              reduce_scatter=L * C * T))
        elif ex == "p2p":
            S, Bh = p["S"], p["Bh"]
            assert p["sync"] and p["halo"]
            want = dict(all_to_all=T * C * (2 * L * (Bh + S) + 2 * S))
        else:  # the vertex cut's broadcast combine, twice more a step
            want = dict(all_gather=(L + 2) * C * T, reduce_scatter=L * C * T)
        calls = json.loads(str(res[f"{tag}/0/calls"]))
        assert calls["steps"] == {**none, **want, "all_reduce": T}
        assert calls["ref"] == none
