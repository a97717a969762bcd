"""The port's historical-embedding protocols: `repro_torch.core.protocols`
function by function against `repro.core.protocols` on seeded numpy inputs
(the three refreshes, `block_refresh` under each protocol, and
`pipegcn_mix` with its gradient against `jax.vjp`; history within 1e-6,
ages and pushed rows exact), then the one-rank engine under each protocol
against the JAX engine on a 1-device Auto-axis mesh (Pallas interpret): the
step and the reference step's losses and logits within 1e-4, each layer's
history within 1e-4, ages and rows pushed equal.  On one rank no row is a
boundary row; the boundary rows' refreshes run on four gloo ranks in
`test_torch_distributed.py`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.core.engine import DistGNNEngine as JDistGNNEngine
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.graph import er_graph as jer_graph
from repro.core.protocols import async_hist as jah
from repro_torch.core.engine import DistGNNEngine, EngineConfig
from repro_torch.core.graph import er_graph
from repro_torch.core.models.gnn import PARAM_KEYS, params_from_numpy
from repro_torch.core.protocols import async_hist as ah

HIST_TOL = 1e-6  # one function's history against JAX's
ORACLE_TOL = 1e-4  # the repo's oracle bound for every step
CPU = torch.device("cpu")
V, D, K = 48, 6, 4  # rows, width, partitions of the function-level inputs
GRAPH = dict(num_vertices=120, avg_degree=3, feature_dim=24, num_classes=5,
             seed=1)
STEPS = 4
PROTOCOLS = ("epoch_fixed", "epoch_adaptive", "variation")
KW = dict(staleness=2, eps=0.05, hard_bound=4)


def _inputs(seed):
    """hist, h_new [V, D], assignment [V], boundary mask [V] and ages [K]:
    partition p's rows drift from hist by a scale that puts its relative
    drift far from eps on either side (p = 0, 2 above, p = 1, 3 below), and
    the ages run past each bound."""
    rng = np.random.default_rng(seed)
    hist = rng.standard_normal((V, D)).astype(np.float32)
    assignment = rng.integers(0, K, V).astype(np.int64)
    scale = np.array([1.0, 0.01, 0.8, 0.02], np.float32)[assignment]
    h_new = (hist + scale[:, None]
             * rng.standard_normal((V, D)).astype(np.float32))
    bmask = rng.random(V) < 0.5
    age = np.array([0, 1, 3, 4], np.int32)
    return hist, h_new.astype(np.float32), assignment, bmask, age


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(ours, theirs, tol=HIST_TOL):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), atol=tol,
                               rtol=0)


def test_state_constructors_equal():
    for ours, theirs in (
            (ah.HistoricalState.create(V, D, K), jah.HistoricalState.create(V, D, K)),
            (ah.PipeGCNState.create(3, V, D), jah.PipeGCNState.create(3, V, D))):
        for name in vars(theirs):
            a, b = getattr(ours, name), np.asarray(getattr(theirs, name))
            assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)


@pytest.mark.parametrize("step", [0, 1, 2, 3])
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_refresh_functions_match_jax(protocol, step):
    hist, h_new, assignment, bmask, age = _inputs(step)
    jstate = jah.HistoricalState(jnp.asarray(hist), jnp.asarray(age),
                                 jnp.asarray(np.float32(7.0)))
    state = ah.HistoricalState(_t(hist), _t(age), torch.tensor(7.0))
    extra = (dict(staleness=2) if protocol != "variation"
             else dict(eps=0.05, hard_bound=4))
    h_used, new = ah.STALENESS_MODELS[protocol](
        state, _t(h_new), step, _t(assignment), _t(bmask), **extra)
    jh_used, jnew = jah.STALENESS_MODELS[protocol](
        jstate, jnp.asarray(h_new), jnp.asarray(step), jnp.asarray(assignment),
        jnp.asarray(bmask), **extra)
    _close(h_used, jh_used)
    _close(new.hist, jnew.hist)
    assert new.age.dtype == torch.int32
    assert np.array_equal(new.age.numpy(), np.asarray(jnew.age))
    assert float(new.bytes_pushed) == float(jnew.bytes_pushed)
    if protocol == "variation":  # both decisions occur
        assert 0 < int((new.age == 0).sum()) < K


@pytest.mark.parametrize("step", [0, 1, 2, 3])
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_block_refresh_matches_jax(protocol, step):
    hist, h_new, assignment, bmask, age = _inputs(10 + step)
    for part_id in range(K):
        rows = assignment == part_id
        args = (hist[rows], h_new[rows], age[part_id], bmask[rows])
        ours = ah.block_refresh(protocol, _t(args[0]), _t(args[1]),
                                torch.tensor(args[2]), step, _t(args[3]),
                                part_id, **KW)
        theirs = jah.block_refresh(protocol, jnp.asarray(args[0]),
                                   jnp.asarray(args[1]), jnp.asarray(args[2]),
                                   jnp.asarray(step), jnp.asarray(args[3]),
                                   jnp.asarray(part_id), **KW)
        _close(ours[0], theirs[0])
        _close(ours[1], theirs[1])
        assert ours[2].dtype == torch.int32
        assert int(ours[2]) == int(theirs[2])
        assert int(ours[3]) == int(theirs[3])


def test_block_refresh_rejects_an_unknown_protocol():
    z = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="unknown protocol"):
        ah.block_refresh("sync", z, z, torch.tensor(0, dtype=torch.int32), 0,
                         torch.zeros(2, dtype=torch.bool), 0)


def test_pipegcn_mix_and_its_gradient_match_jax():
    rng = np.random.default_rng(3)
    h_new, hist_h, hist_g, ct = (rng.standard_normal((V, D)).astype(np.float32)
                                 for _ in range(4))
    bmask_f = (rng.random(V) < 0.4).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (h_new, hist_h, hist_g, bmask_f)]
    jout, vjp = jax.vjp(jah.pipegcn_mix, *jargs)
    jgrads = vjp(jnp.asarray(ct))
    args = [_t(a).requires_grad_() for a in (h_new, hist_h, hist_g, bmask_f)]
    out = ah.pipegcn_mix(*args)
    grads = torch.autograd.grad(out, args, _t(ct))
    _close(out.detach(), jout)
    for ours, theirs in zip(grads, jgrads):
        _close(ours, theirs)
    assert np.array_equal(grads[2].numpy(), ct * bmask_f[:, None])


ENGINE_CASES = [("epoch_fixed", "gcn", "broadcast"),
                ("epoch_adaptive", "sage", "p2p"),
                ("variation", "gat", "ring"),
                ("epoch_fixed", "gat", "ring")]


@pytest.mark.parametrize("protocol,model,execution", ENGINE_CASES)
def test_one_rank_engine_under_each_protocol_matches_jax(protocol, model,
                                                         execution):
    g, jg = er_graph(**GRAPH), jer_graph(**GRAPH)
    eng = DistGNNEngine(g, EngineConfig(
        execution=execution, protocol=protocol, partitioner="hash",
        model=model, hidden=16, num_layers=3), device=CPU)
    mesh = jax.make_mesh((1,), ("w",), axis_types=(AxisType.Auto,))
    jeng = JDistGNNEngine(jg, mesh=mesh, cfg=JEngineConfig(
        execution=execution, protocol=protocol, partitioner="hash",
        model=model, hidden=16, num_layers=3, interpret=True))
    assert not eng.playout.bmask.any()  # one rank: no boundary rows
    jstate = jeng.init_state()
    params = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]), CPU)
    state = eng.init_state(params=params)
    ref_state = eng.init_state(params=params, reference=True)
    assert [tuple(h.shape) for h in state["hist"]] == [
        tuple(h.shape) for h in jstate["hist"]]
    assert tuple(state["age"].shape) == (3,)
    assert tuple(ref_state["age"].shape) == tuple(jstate["age"].shape) == (3, 1)
    jref_state = jstate
    step, ref_step = eng.make_step(), eng.make_reference_step()
    jstep, jref_step = jeng.make_step(), jeng.make_reference_step()
    for i in range(STEPS):
        state, metrics, logits = step(state)
        ref_state, ref_metrics, ref_logits = ref_step(ref_state)
        jstate, jmetrics, jlogits = jstep(jstate)
        jref_state, jref_metrics, jref_logits = jref_step(jref_state)
        loss = float(metrics["loss"])
        for other in (ref_metrics["loss"], jmetrics["loss"],
                      jref_metrics["loss"]):
            assert abs(loss - float(other)) <= ORACLE_TOL, (i, loss, other)
        _close(logits, jlogits, ORACLE_TOL)
        _close(ref_logits, jref_logits, ORACLE_TOL)
        for ours, ref, theirs, jref in zip(state["hist"], ref_state["hist"],
                                           jstate["hist"], jref_state["hist"]):
            _close(ours, theirs, ORACLE_TOL)
            _close(ref, jref, ORACLE_TOL)
        assert np.array_equal(state["age"].numpy(),
                              np.asarray(jstate["age"])[:, 0])
        assert np.array_equal(ref_state["age"].numpy(),
                              np.asarray(jref_state["age"]))
        for m in (metrics, ref_metrics):
            assert float(m["rows_pushed"]) == float(jmetrics["rows_pushed"])
    for ours, theirs in zip(state["params"]["layers"],
                            jstate["params"]["layers"]):
        for key in PARAM_KEYS[model]:
            _close(ours[key], theirs[key], ORACLE_TOL)
    # epoch_fixed pushes the whole block on even steps; the others push
    # only boundary rows, of which one rank has none
    pushed = protocol == "epoch_fixed"
    assert bool(state["hist"][0].abs().sum() > 0) == pushed
