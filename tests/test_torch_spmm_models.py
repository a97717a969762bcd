"""The port's dense SpMM execution models (`repro_torch.core.execution.
spmm_models`) on four gloo ranks against `repro`'s on four forced host
devices.

`tests/test_distributed.py::test_spmm_models_match_oracle_8dev`'s inputs
(`er_graph(64, avg_degree=6, seed=3)`'s normalized adjacency, D 16): the
1-D models (replicated, broadcast, ring, selective p2p with `p2p_plan`) on
a (4,) grid and the 2-D ones (SUMMA, 1.5D) on a 2 x 2 grid of row and
column subgroups, four CPU processes (`file://` rendezvous under
`tmp_path`, each under its own time limit) beside one `run_with_devices(4)`
JAX subprocess on Auto-axis meshes, run together.  Each rank's block is
held to JAX's whole output at that block's ``out_specs`` position within
1e-4, the plan array for array, every rank's collective calls counted
exactly (broadcast one all_gather, the ring k - 1 rotations, p2p one
all_to_all, SUMMA an all_gather over the grid column and a reduce-scatter
over the grid row, 1.5D the reduce-scatter; the replicated model none).
In this process, a world-size-1 gloo group: every model on a (1,) or
1 x 1 grid equals the plain product bit for bit, and the grids' refusals.
"""
import json
import sys
import tempfile
import threading

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from test_torch_distributed import _run_ranks

CPU = torch.device("cpu")
ORACLE_TOL = 1e-4
WORLD = 4
RANK_TIMEOUT = 180  # seconds, for each rank process
GRAPH = dict(num_vertices=64, avg_degree=6, seed=3)
D = 16
# model -> grid shape at four ranks, and its collective calls on a rank
MODELS = {
    "spmm_replicated": ((4,), {}),
    "spmm_1d_broadcast": ((4,), {"all_gather": 1}),
    "spmm_1d_ring": ((4,), {"ppermute": WORLD - 1}),
    "spmm_1d_p2p": ((4,), {"all_to_all": 1}),
    "spmm_2d_summa": ((2, 2), {"all_gather": 1, "reduce_scatter": 1}),
    "spmm_15d": ((2, 2), {"reduce_scatter": 1}),
}

_JAX_CODE = """
import json, sys
import jax, numpy as np, jax.numpy as jnp
from jax.sharding import AxisType
from repro.core.graph import er_graph
from repro.core.execution import spmm_models as sm
graph, D, path = json.loads({args!r})
g = er_graph(**graph)
A_np = g.to_dense_adj()
H_np = np.random.default_rng(0).standard_normal((A_np.shape[0], D)).astype(np.float32)
A, H = jnp.asarray(A_np), jnp.asarray(H_np)
m1 = jax.make_mesh((4,), ("w",), axis_types=(AxisType.Auto,))
m2 = jax.make_mesh((2, 2), ("r", "c"), axis_types=(AxisType.Auto,) * 2)
out = {{}}
for name, mesh in [("spmm_replicated", m1), ("spmm_1d_broadcast", m1),
                   ("spmm_1d_ring", m1), ("spmm_2d_summa", m2),
                   ("spmm_15d", m2)]:
    out[name] = np.asarray(getattr(sm, name)(mesh, A, H))
plan = sm.p2p_plan(A_np, 4)
out["spmm_1d_p2p"] = np.asarray(sm.spmm_1d_p2p(m1, A, H, plan))
out["plan_need"], out["plan_cnt"] = plan[0], plan[1]
out["plan_cap"] = np.asarray(plan[2])
np.savez(path, **out)
print("JAX_OK")
"""

_RANK_CODE = """
import json, sys
import numpy as np
import torch
graph, D, rank, world, init_method, path = json.loads(sys.argv[1])
torch.set_num_threads(1)
from repro_torch.core.execution import collectives, spmm_models as sm
from repro_torch.core.graph import er_graph
collectives.init_group(init_method, world, rank, "cpu")
try:
    A_np = er_graph(**graph).to_dense_adj()
    H_np = np.random.default_rng(0).standard_normal(
        (A_np.shape[0], D)).astype(np.float32)
    A, H = torch.from_numpy(A_np), torch.from_numpy(H_np)
    grids = {{(4,): sm.process_grid((4,)), (2, 2): sm.process_grid((2, 2))}}
    plan = sm.p2p_plan(A_np, world)
    out = {{"plan_need": plan[0], "plan_cnt": plan[1],
           "plan_cap": np.asarray(plan[2])}}
    calls = {{}}
    for name, shape in {shapes}:
        fn, grid = getattr(sm, name), grids[tuple(shape)]
        A_blk, H_blk = sm.local_blocks(fn, grid, A, H)
        extra = (plan,) if name == "spmm_1d_p2p" else ()
        collectives.zero_calls()
        Y = fn(grid, A_blk.contiguous(), H_blk.contiguous(), *extra)
        calls[name] = collectives.read_calls()
        rows, cols = sm.output_block(fn, grid, *H.shape)
        out[name] = Y.numpy()
        out[name + "_at"] = np.asarray(
            [rows.start or 0, rows.stop or H.shape[0],
             cols.start or 0, cols.stop or H.shape[1]])
        out[name + "_coords"] = np.asarray(grid.coords)
    np.savez(path, **out)
    print(json.dumps(calls))
finally:
    collectives.destroy_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_spmm_models")
    jax_path = str(tmp / "jax.npz")
    jax_error = []

    def jax_side():
        try:
            run_with_devices(_JAX_CODE.format(
                args=json.dumps([GRAPH, D, jax_path])), n_devices=WORLD,
                timeout=RANK_TIMEOUT)
        except BaseException as e:  # re-raised below, in the test's thread
            jax_error.append(e)

    jax_thread = threading.Thread(target=jax_side)
    jax_thread.start()
    init_method = f"file://{tmp / 'rendezvous'}"
    code = _RANK_CODE.format(shapes=repr(
        [(name, list(shape)) for name, (shape, _) in MODELS.items()]))
    paths = [str(tmp / f"rank{r}.npz") for r in range(WORLD)]
    try:
        outs = _run_ranks([[sys.executable, "-c", code, json.dumps(
            [GRAPH, D, r, WORLD, init_method, paths[r]])]
            for r in range(WORLD)], timeout=RANK_TIMEOUT)
    finally:
        jax_thread.join()
    if jax_error:
        raise jax_error[0]
    calls = [json.loads(out.strip().splitlines()[-1]) for _, out, _ in outs]
    return dict(jax=dict(np.load(jax_path)),
                ranks=[dict(np.load(p)) for p in paths], calls=calls)


@pytest.mark.parametrize("name", list(MODELS))
def test_each_rank_block_matches_jax(runs, name):
    shape, want_calls = MODELS[name]
    theirs = runs["jax"][name]
    covered = np.zeros(theirs.shape, bool)
    for rank, res in enumerate(runs["ranks"]):
        r0, r1, c0, c1 = res[name + "_at"]
        coords = tuple(res[name + "_coords"])
        assert coords == ((rank,) if len(shape) == 1
                          else divmod(rank, shape[1]))
        np.testing.assert_allclose(res[name], theirs[r0:r1, c0:c1],
                                   atol=ORACLE_TOL, rtol=0,
                                   err_msg=f"{name} rank {rank}")
        covered[r0:r1, c0:c1] = True
        got = {k: v for k, v in runs["calls"][rank][name].items() if v}
        assert got == want_calls, (name, rank, got)
    assert covered.all()  # the blocks tile Y


def test_p2p_plan_matches_jax(runs):
    for res in runs["ranks"]:
        for key in ("plan_need", "plan_cnt", "plan_cap"):
            assert res[key].dtype == runs["jax"][key].dtype
            assert np.array_equal(res[key], runs["jax"][key]), key


def test_p2p_plan_matches_reference_at_k():
    """`p2p_plan` array for array, its three values, at k in {1, 2, 4, 8}."""
    from repro.core.execution.spmm_models import p2p_plan as ref_p2p_plan
    from repro_torch.core.execution.spmm_models import p2p_plan
    from repro_torch.core.graph import er_graph

    A = er_graph(**GRAPH).to_dense_adj()
    for k in (1, 2, 4, 8):
        ours, theirs = p2p_plan(A, k), ref_p2p_plan(A, k)
        assert len(ours) == len(theirs) == 3
        for a, b in zip(ours[:2], theirs[:2]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert ours[2] == theirs[2]
        assert ours[2] == 1 if k == 1 else ours[2] >= 1


def test_world_size_one_equals_the_plain_product():
    """One rank in a gloo group: every model on a (1,) or 1 x 1 grid of
    subgroups is ``A @ H`` bit for bit; the ring rotates nothing; the
    grids refuse a shape that is not the group's, and each model a grid
    of the other rank."""
    from repro_torch.core.execution import collectives
    from repro_torch.core.execution import spmm_models as sm
    from repro_torch.core.graph import er_graph

    A_np = er_graph(**GRAPH).to_dense_adj()
    H_np = np.random.default_rng(0).standard_normal(
        (A_np.shape[0], D)).astype(np.float32)
    A, H = torch.from_numpy(A_np), torch.from_numpy(H_np)
    plain = (A @ H).numpy()
    with tempfile.TemporaryDirectory() as tmp:
        collectives.init_group(f"file://{tmp}/rendezvous", 1, 0, CPU)
        try:
            grids = {1: sm.process_grid((1,)), 2: sm.process_grid((1, 1))}
            with pytest.raises(ValueError, match="grid of shape"):
                sm.process_grid((2, 1))
            with pytest.raises(ValueError, match="grid of shape"):
                sm.process_grid((1, 1, 1))
            with pytest.raises(ValueError, match="1-D model"):
                sm.spmm_1d_ring(grids[2], A, H)
            with pytest.raises(ValueError, match="2-D model"):
                sm.spmm_15d(grids[1], A, H)
            for name, (shape, want_calls) in MODELS.items():
                fn, grid = getattr(sm, name), grids[len(shape)]
                A_blk, H_blk = sm.local_blocks(fn, grid, A, H)
                assert A_blk.shape == A.shape and H_blk.shape == H.shape
                extra = ((sm.p2p_plan(A_np, 1),) if name == "spmm_1d_p2p"
                         else ())
                collectives.zero_calls()
                Y = fn(grid, A_blk, H_blk, *extra)
                got = {k: v for k, v in collectives.read_calls().items() if v}
                want = {k: v for k, v in want_calls.items() if k != "ppermute"}
                assert got == want, (name, got)
                assert sm.output_block(fn, grid, *H.shape) == (
                    (slice(None), slice(0, D)) if name == "spmm_replicated"
                    else (slice(0, A.shape[0]), slice(None)))
                np.testing.assert_array_equal(Y.numpy(), plain, err_msg=name)
        finally:
            collectives.destroy_group()


def test_spmm_models_table_matches_reference():
    from repro.core.execution.spmm_models import SPMM_MODELS as REF
    from repro_torch.core.execution.spmm_models import SPMM_MODELS

    assert list(SPMM_MODELS) == list(REF)
    assert {fn.__name__ for fn in SPMM_MODELS.values()} == {
        fn.__name__ for fn in REF.values()}
