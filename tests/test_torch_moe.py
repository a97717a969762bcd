"""PyTorch port, the MoE layer (`repro_torch.models.moe`) against
`repro.models.moe` on the CPU, at kimi-k2-1t-a32b's smoke config (D 128,
4 experts, top-2, one shared expert) in fp32, from the reference's own
`moe_params` draw carried over and numpy-seeded inputs.

In this process: `_router`'s weights, ids and aux (<= 1e-6, the ids equal);
`_slots` (a stable sort) against the reference's one-hot cumsum, exactly;
`_moe_reference` at capacity 1.25, where pairs are dropped (the dropped
count > 0 and the same on both sides), and at 8.0 (<= 1e-5); its
gradients with respect to x, the router, wi, wg, wo and the shared expert
against `jax.vjp` (<= 1e-4) at both capacities; the sliced draw of a
leaf past `ParamBuilder.WHOLE_DRAW` elements.

On 4 gloo ranks as a 2 x 2 (data, model) grid of process groups
(`spmm_models.process_grid((2, 2))`, the rank harness of
`test_torch_distributed.py`), beside one JAX subprocess on 4 forced host
devices running `moe_apply` under `jax.make_mesh((2, 2), ("data",
"model"))` and `make_rules`: `tests/test_distributed.py`'s configurations
(the expert-parallel dispatch at capacity 8.0, chunk 32; the dedup
dispatch with `moe_group_limit` 2 at chunk 16; the `_moe_2d` decode
layout), and the group-limited dedup at `moe_group_limit` 1.  Each rank's
rows within 1e-5 of JAX's same path and within 2e-2 of the largest
|y| of `_moe_reference`; every rank's collective calls counted exactly.

    PYTHONPATH=src python -m pytest -q tests/test_torch_moe.py
"""
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from test_torch_distributed import _run_ranks
from repro_torch.configs import base as tbase
from repro_torch.models import moe as tmoe

ARCH = "kimi-k2-1t-a32b"
ROUTER_TOL = 1e-6
TOL = 1e-5  # the layer's output, fp32 against fp32
GRAD_TOL = 1e-4
EP_SHARE = 2e-2  # tests/test_distributed.py's gap to the reference path
WORLD = 4
RANK_TIMEOUT = 180  # seconds, for each rank process
# name -> (config overrides, x shape, decode_2d, the calls of one rank)
GRID = {
    "ep": (dict(capacity_factor=8.0, moe_dispatch_chunk=32), (4, 16), False,
           {"all_to_all": 3, "all_reduce": 2}),
    "dedup": (dict(capacity_factor=8.0, moe_dispatch_chunk=16,
                   moe_group_limit=2), (4, 8), False,
              {"all_to_all": 2, "all_reduce": 2}),
    "decode_2d": (dict(capacity_factor=8.0, moe_dispatch_chunk=16), (4, 8),
                  True, {"all_gather": 1, "all_to_all": 3, "all_reduce": 2}),
    "dedup_g1": (dict(capacity_factor=8.0, moe_dispatch_chunk=16,
                      moe_group_limit=1), (4, 8), False,
                 {"all_to_all": 2, "all_reduce": 2}),
}
LEAVES = ("router", "wi", "wg", "wo", "shared/wi", "shared/wg", "shared/wo")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the smoke-size tensors (other test workers
    share the host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _cfgs(**kw):
    from repro.configs import get_smoke_config

    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32", **kw)
    cfg = dataclasses.replace(tbase.get_smoke_config(ARCH), dtype="float32", **kw)
    return jcfg, cfg


def _leaf(tree, key):
    for part in key.split("/"):
        tree = tree[part]
    return tree


def _torch_params(jp):
    p = {k: torch.from_numpy(np.array(v, np.float32))
         for k, v in jp.items() if k != "shared"}
    p["shared"] = {k: torch.from_numpy(np.array(v, np.float32))
                   for k, v in jp["shared"].items()}
    return p


@pytest.fixture(scope="module")
def layer():
    """The reference's seeded MoE layer and an input [4, 16, D]: unit
    noise about one shared direction (a residual stream's common part),
    which skews the routing so that capacity 1.25 drops pairs (28 of
    128)."""
    jax, jnp = _jax()
    from repro.models.layers import ParamBuilder
    from repro.models.moe import moe_params

    jcfg, _ = _cfgs()
    jp = moe_params(ParamBuilder("init", jax.random.PRNGKey(0)), jcfg)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((4, 16, jcfg.d_model))
         + rng.standard_normal(jcfg.d_model)).astype(np.float32)
    return jp, _torch_params(jp), x


def test_router_matches_jax(layer):
    jax, jnp = _jax()
    from repro.models.moe import _router

    jp, p, x = layer
    jcfg, cfg = _cfgs()
    xf = x.reshape(-1, cfg.d_model)
    jw, jids, jaux = _router(jp, jnp.asarray(xf), jcfg)
    w, ids, aux = tmoe._router(p, torch.from_numpy(xf), cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=ROUTER_TOL,
                               rtol=ROUTER_TOL)
    assert abs(float(aux) - float(jaux)) <= ROUTER_TOL


@pytest.mark.parametrize("N,n", [(1, 1), (7, 3), (513, 2), (4096, 384)])
def test_slots_match_the_reference_one_hot_cumsum(N, n):
    """`_slots` (a stable sort) against the reference's
    ``(cumsum(one_hot) - one_hot)[arange, ids]``, with and without a
    ``valid`` mask (the expert-parallel path's second packing, where only
    the valid entries' places are read), on skewed ids."""
    jax, jnp = _jax()
    rng = np.random.default_rng(N)
    ids = np.where(rng.random(N) < 0.6, 0, rng.integers(0, n, N)).astype(np.int32)
    valid = rng.random(N) < 0.7
    oh = jax.nn.one_hot(jnp.asarray(ids), n, dtype=jnp.int32)
    want = np.asarray((jnp.cumsum(oh, 0) - oh)[jnp.arange(N), ids])
    oh = oh * jnp.asarray(valid)[:, None]
    want_valid = np.asarray((jnp.cumsum(oh, 0) - oh)[jnp.arange(N), ids])
    t = torch.from_numpy(ids.astype(np.int64))
    np.testing.assert_array_equal(tmoe._slots(t, n).numpy(), want)
    got = tmoe._slots(t, n, torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got[valid], want_valid[valid])


def _jax_dropped(jax, jnp, jp, x, jcfg):
    """Pairs dropped by the reference's capacity packing, recounted in
    numpy from its router's ids."""
    from repro.models.moe import _router

    T = x.shape[0] * x.shape[1]
    _, ids, _ = _router(jp, jnp.asarray(x.reshape(T, -1)), jcfg)
    flat = np.asarray(ids).reshape(-1)
    cap = max(int(T * jcfg.moe_top_k / jcfg.num_experts * jcfg.capacity_factor), 1)
    seen = np.zeros(jcfg.num_experts, int)
    dropped = 0
    for e in flat:
        dropped += seen[e] >= cap
        seen[e] += 1
    return int(dropped)


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_reference_matches_jax(layer, cf):
    """At 1.25 the packing drops pairs (their tokens keep the other
    expert's weighted output, not renormalized); at 8.0 none."""
    jax, jnp = _jax()
    from repro.models.moe import _moe_reference

    jp, p, x = layer
    jcfg, cfg = _cfgs(capacity_factor=cf)
    jy, jaux = _moe_reference(jp, jnp.asarray(x), jcfg)
    y, aux = tmoe._moe_reference(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    assert abs(float(aux) - float(jaux)) <= ROUTER_TOL
    _, _, pos, cap, _ = tmoe.routing(p, torch.from_numpy(x), cfg)
    dropped = int((pos >= cap).sum())
    assert dropped == _jax_dropped(jax, jnp, jp, x, jcfg)
    assert (dropped > 0) == (cf == 1.25), dropped


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_reference_gradients_match_jax(layer, cf):
    """d/dx and d/d every parameter leaf of <y, ct> + 0.7 aux against
    `jax.vjp` of the reference path."""
    jax, jnp = _jax()
    from repro.models.moe import _moe_reference

    jp, p, x = layer
    jcfg, cfg = _cfgs(capacity_factor=cf)
    ct = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    (jy, jaux), vjp = jax.vjp(lambda pp, xx: _moe_reference(pp, xx, jcfg),
                              jp, jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(ct), jnp.float32(0.7)))
    tx = torch.from_numpy(x).requires_grad_(True)
    leaves = [_leaf(p, key).requires_grad_(True) for key in LEAVES]
    y, aux = tmoe._moe_reference(p, tx, cfg)
    grads = torch.autograd.grad((y * torch.from_numpy(ct)).sum() + 0.7 * aux,
                                [tx] + leaves)
    for key, got, want in zip(("x",) + LEAVES, grads,
                              [jgx] + [_leaf(jgp, k) for k in LEAVES]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=key)
    for leaf in leaves:
        leaf.requires_grad_(False)


# ---------------------------------------------------------------------------
# The expert-parallel paths on 4 gloo ranks against JAX on 4 host devices
# ---------------------------------------------------------------------------

_JAX_CODE = """
import dataclasses, json
import jax, numpy as np, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.models.moe import moe_apply, moe_params, _moe_reference
from repro.models.layers import ParamBuilder
from repro.launch.sharding import make_rules, use_rules
grid, path = json.loads({args!r})
base = dataclasses.replace(get_smoke_config({arch!r}), dtype="float32")
p = moe_params(ParamBuilder("init", jax.random.PRNGKey(0)), base)
out = {{"router": p["router"], "wi": p["wi"], "wg": p["wg"], "wo": p["wo"]}}
for k, v in p["shared"].items():
    out["shared/" + k] = v
mesh = jax.make_mesh((2, 2), ("data", "model"))
for name, (kw, shape, decode_2d, _) in grid.items():
    cfg = dataclasses.replace(base, **kw)
    x = jnp.asarray(np.random.default_rng(1).standard_normal(
        tuple(shape) + (cfg.d_model,)) * 0.1, jnp.float32)
    y_ref, aux_ref = _moe_reference(p, x, cfg)
    over = {{"_moe_2d": True, "expert_embed": None,
             "expert_mlp": "data"}} if decode_2d else None
    with use_rules(mesh, make_rules(cfg, mesh, over)):
        y, aux = jax.jit(lambda p, x: moe_apply(p, x, cfg))(p, x)
    out.update({{name + "/x": x, name + "/y": y, name + "/aux": aux,
                 name + "/y_ref": y_ref, name + "/aux_ref": aux_ref}})
np.savez(path, **{{k: np.asarray(v) for k, v in out.items()}})
print("JAX_OK")
"""

_RANK_CODE = """
import dataclasses, json, sys
import numpy as np
import torch
grid_cfgs, rank, world, init_method, jax_path, path = json.loads(sys.argv[1])
torch.set_num_threads(1)
from repro_torch.configs import get_smoke_config
from repro_torch.core.execution import collectives, spmm_models as sm
from repro_torch.models import moe
collectives.init_group(init_method, world, rank, "cpu")
try:
    z = np.load(jax_path)
    full = {{k: torch.from_numpy(z[k]) for k in ("router", "wi", "wg", "wo")}}
    full["shared"] = {{k: torch.from_numpy(z["shared/" + k])
                      for k in ("wi", "wg", "wo")}}
    grid = sm.process_grid((2, 2))
    base = dataclasses.replace(get_smoke_config({arch!r}), dtype="float32")
    out, calls = {{}}, {{}}
    for name, (kw, shape, decode_2d, _) in grid_cfgs.items():
        cfg = dataclasses.replace(base, **kw)
        x_local, split = moe.shard_batch(torch.from_numpy(z[name + "/x"]), grid)
        p_local = moe.shard_params(full, cfg, grid, decode_2d)
        collectives.zero_calls()
        with torch.inference_mode():
            y, aux = moe.moe_apply(p_local, x_local, cfg, grid,
                                   decode_2d=decode_2d, batch_sharded=split)
        calls[name] = {{k: v for k, v in collectives.read_calls().items() if v}}
        bl = x_local.shape[0]
        lo = grid.coords[0] * bl if split else 0
        out[name + "/y"] = y.numpy()
        out[name + "/aux"] = np.asarray(float(aux))
        out[name + "/rows"] = np.asarray([lo, lo + bl])
    np.savez(path, **out)
    print(json.dumps(calls))
finally:
    collectives.destroy_group()
"""


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_moe")
    jax_path = str(tmp / "jax.npz")
    grid = {name: [kw, list(shape), d2, calls]
            for name, (kw, shape, d2, calls) in GRID.items()}
    run_with_devices(_JAX_CODE.format(args=json.dumps([grid, jax_path]),
                                      arch=ARCH),
                     n_devices=WORLD, timeout=RANK_TIMEOUT)
    init_method = f"file://{tmp / 'rendezvous'}"
    paths = [str(tmp / f"rank{r}.npz") for r in range(WORLD)]
    code = _RANK_CODE.format(arch=ARCH)
    outs = _run_ranks([[sys.executable, "-c", code, json.dumps(
        [grid, r, WORLD, init_method, jax_path, paths[r]])]
        for r in range(WORLD)], timeout=RANK_TIMEOUT)
    calls = [json.loads(out.strip().splitlines()[-1]) for _, out, _ in outs]
    return dict(jax=dict(np.load(jax_path)),
                ranks=[dict(np.load(p)) for p in paths], calls=calls)


@pytest.mark.parametrize("name", list(GRID))
def test_grid_paths_match_jax(grid_runs, name):
    want_calls = GRID[name][3]
    jx = grid_runs["jax"]
    y_jax, y_ref = jx[name + "/y"], jx[name + "/y_ref"]
    scale = float(np.abs(y_ref).max())
    covered = np.zeros(y_jax.shape[0], bool)
    for rank, res in enumerate(grid_runs["ranks"]):
        lo, hi = res[name + "/rows"]
        np.testing.assert_allclose(res[name + "/y"], y_jax[lo:hi], atol=TOL,
                                   rtol=TOL, err_msg=f"{name} rank {rank}")
        assert abs(float(res[name + "/aux"]) - float(jx[name + "/aux"])) <= TOL
        if name != "dedup_g1":  # group-limited routing is another function
            gap = float(np.abs(res[name + "/y"] - y_ref[lo:hi]).max())
            assert gap <= EP_SHARE * scale, (name, rank, gap, scale)
        covered[lo:hi] = True
        assert grid_runs["calls"][rank][name] == want_calls, (
            name, rank, grid_runs["calls"][rank][name])
    assert covered.all()


def test_a_large_leaf_is_drawn_a_slice_at_a_time(monkeypatch):
    """Past `ParamBuilder.WHOLE_DRAW` elements a leaf is drawn one slice
    of its leading dims at a time from its path's generator (kimi-k2's
    expert stacks on the card): the same seed the same bits, every slice
    its own draw at the init's scale, in the parameter dtype."""
    from repro_torch.models.layers import ParamBuilder

    monkeypatch.setattr(ParamBuilder, "WHOLE_DRAW", 4096)
    draw = lambda seed: ParamBuilder(seed, "cpu", torch.bfloat16).param(
        "wi", (8, 64, 32), fan_in=64)
    a, again, other = draw(0), draw(0), draw(1)
    assert a.shape == (8, 64, 32) and a.dtype == torch.bfloat16
    assert torch.equal(a, again) and not torch.equal(a, other)
    assert not any(torch.equal(a[0], a[e]) for e in range(1, 8))
    for e in range(8):
        assert abs(float(a[e].float().std()) * 8 - 1) < 0.1, e


def test_grid_paths_refuse_autograd_and_a_1d_grid(layer):
    """The grid paths are forward only, and need a (data, model) grid."""
    from repro_torch.core.execution.spmm_models import ProcessGrid

    _, p, x = layer
    _, cfg = _cfgs()
    grid = ProcessGrid((1, 1), (0, 0), (None, None))
    with pytest.raises(NotImplementedError, match="forward only"):
        tmoe.moe_apply(p, torch.from_numpy(x).requires_grad_(True), cfg, grid)
    with pytest.raises(ValueError, match="data, model"):
        tmoe.moe_apply(p, torch.from_numpy(x), cfg,
                       ProcessGrid((1,), (0,), (None,)))
