"""The port's ELL-SpMM wrapper (`repro_torch.kernels.ell_spmm`) against the
Pallas kernel it replaces, run in interpret mode, and against both plain
versions; its gradient against `jax.vjp` of the reference's differentiable
`ell_spmm` (the custom_vjp scatter-add rule); the transpose plan against a
numpy construction.

On a CPU-only host the wrapper takes its plain version (the CUDA kernel has
no CPU mode) and the CUDA-only tests skip.  On a host with a card the
CUDA-only tests hold the kernel to the same cases (where JAX is missing, the
comparisons with the reference skip):

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ell_spmm import (
    ell_spmm,
    ell_spmm_transpose,
    ell_transpose_plan,
)

# fp32 on both sides, sums taken in another order: the repo's own Pallas
# kernel tolerance (tests/test_kernels.py)
TOL = 1e-5

CASES = [  # V, K, N, D, mask kind, normalize
    (128, 8, 128, 64, "binary", True),
    (128, 8, 128, 64, "binary", False),
    (1003, 7, 502, 37, "binary", True),
    (1003, 7, 502, 37, "binary", False),
    (1003, 9, 778, 36, "weighted", True),
    (1003, 9, 778, 36, "weighted", False),
    (256, 1, 300, 32, "binary", True),
    (200, 12, 150, 16, "all_masked_rows", True),
    (200, 12, 150, 16, "all_masked_rows", False),
    # K and D past one shared-memory stage (64 slots) and one column pass
    # (256 floats) of the CUDA kernel
    (300, 100, 400, 300, "weighted", True),
]


def _reference():
    """The JAX package's Pallas kernel and plain version."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    from repro.kernels.ell_spmm import ell_spmm_pallas

    return jnp, jref, ell_spmm_pallas


def _jax_vjp(ids, mask, H, ct, normalize):
    """dH of the reference's differentiable ell_spmm (Pallas forward in
    interpret mode, scatter-add backward)."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels.ell_spmm import ell_spmm as jell_spmm

    ids, mask = jnp.asarray(ids), jnp.asarray(mask)
    _, vjp = jax.vjp(lambda h: jell_spmm(ids, mask, h, normalize=normalize,
                                         interpret=True), jnp.asarray(H))
    return np.asarray(vjp(jnp.asarray(ct))[0])


def _inputs(V, K, N, D, kind, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N, (V, K)).astype(np.int32)
    mask = (rng.random((V, K)) < 0.6).astype(np.float32)
    if kind == "weighted":
        mask *= rng.random((V, K)).astype(np.float32)
    elif kind == "all_masked_rows":
        mask[: V // 4] = 0.0
    H = rng.standard_normal((N, D)).astype(np.float32)
    return ids, mask, H


@pytest.mark.parametrize("V,K,N,D,kind,normalize", CASES)
def test_ell_spmm_matches_pallas_and_plain(V, K, N, D, kind, normalize):
    jnp, jref, ell_spmm_pallas = _reference()
    ids, mask, H = _inputs(V, K, N, D, kind)
    got = ell_spmm(torch.from_numpy(ids), torch.from_numpy(mask),
                   torch.from_numpy(H), normalize=normalize).numpy()
    pallas = np.asarray(ell_spmm_pallas(jnp.asarray(ids), jnp.asarray(mask),
                                        jnp.asarray(H), normalize=normalize,
                                        interpret=True))
    plain_jax = np.asarray(jref.ell_spmm_ref(jnp.asarray(ids),
                                             jnp.asarray(mask), jnp.asarray(H),
                                             normalize=normalize))
    assert got.shape == (V, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, plain_jax, atol=TOL, rtol=TOL)
    if kind == "all_masked_rows":
        assert not got[: V // 4].any()


@pytest.mark.parametrize("V,K,N,D,kind,normalize", CASES)
def test_ell_spmm_gradient_matches_jax_vjp(V, K, N, D, kind, normalize):
    ids, mask, H = _inputs(V, K, N, D, kind)
    ct = np.random.default_rng(7).standard_normal((V, D)).astype(np.float32)
    Ht = torch.from_numpy(H).requires_grad_()
    out = ell_spmm(torch.from_numpy(ids), torch.from_numpy(mask), Ht,
                   normalize=normalize)
    (got,) = torch.autograd.grad(out, Ht, torch.from_numpy(ct))
    direct = ell_spmm_transpose(torch.from_numpy(ids), torch.from_numpy(mask),
                                torch.from_numpy(ct), N, normalize=normalize)
    want = _jax_vjp(ids, mask, H, ct, normalize)
    assert got.shape == (N, D) and got.dtype == torch.float32
    assert torch.equal(got, direct)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def _numpy_plan(ids, mask, N):
    """Row u's segment: v*K + k of every unmasked slot with ids[v,k] == u,
    in increasing order."""
    K = ids.shape[1]
    segments = [[] for _ in range(N)]
    for v, k in zip(*np.nonzero(mask)):
        segments[ids[v, k]].append(v * K + k)
    indptr = np.concatenate([[0], np.cumsum([len(s) for s in segments])])
    slots = np.array([s for seg in segments for s in seg], np.int64)
    return indptr.astype(np.int64), slots


@pytest.mark.parametrize("V,K,N,D,kind,normalize", CASES[::2])
def test_transpose_plan_matches_numpy_and_is_sorted(V, K, N, D, kind,
                                                    normalize):
    ids, mask, _ = _inputs(V, K, N, D, kind)
    indptr, slots = ell_transpose_plan(torch.from_numpy(ids),
                                       torch.from_numpy(mask), N)
    want_indptr, want_slots = _numpy_plan(ids, mask, N)
    assert indptr.dtype == slots.dtype == torch.int64
    assert np.array_equal(indptr.numpy(), want_indptr)
    assert np.array_equal(slots.numpy(), want_slots)
    for u in range(N):  # each segment reads row u, in increasing slot order
        seg = slots[indptr[u]:indptr[u + 1]].numpy()
        assert (ids.reshape(-1)[seg] == u).all() and (np.diff(seg) > 0).all()


def test_transpose_plan_rejects_an_unmasked_id_out_of_range():
    ids, mask, _ = _inputs(16, 4, 16, 8, "binary")
    ids[3, 0], mask[3, 0] = 16, 1.0
    with pytest.raises(ValueError, match="outside"):
        ell_transpose_plan(torch.from_numpy(ids), torch.from_numpy(mask), 16)
    mask[3, 0] = 0.0  # a masked slot may point anywhere
    ell_transpose_plan(torch.from_numpy(ids), torch.from_numpy(mask), 16)


def test_plain_version_walks_rows_in_chunks_with_the_same_math():
    """V*K*D above the gather budget: the plain version takes several row
    chunks and still equals the reference's one-shot gather."""
    jnp, jref, _ = _reference()
    V, K, N, D = 4096, 64, 2048, 80
    assert V * K * D > tref._GATHER_ELEMS
    ids, mask, H = _inputs(V, K, N, D, "weighted", seed=1)
    for normalize in (True, False):
        got = tref.ell_spmm_ref(torch.from_numpy(ids), torch.from_numpy(mask),
                                torch.from_numpy(H), normalize=normalize)
        want = jref.ell_spmm_ref(jnp.asarray(ids), jnp.asarray(mask),
                                 jnp.asarray(H), normalize=normalize)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL)


def test_cpu_call_takes_plain_version_and_counts_no_launch():
    ids, mask, H = (torch.from_numpy(a) for a in _inputs(64, 4, 64, 8, "binary"))
    before = ell_spmm.launches, ell_spmm_transpose.launches
    out = ell_spmm(ids, mask, H.requires_grad_())
    out.sum().backward()
    assert H.grad is not None
    assert (ell_spmm.launches, ell_spmm_transpose.launches) == before


def test_no_backward_when_H_needs_no_gradient(monkeypatch):
    """The layer-0 aggregation reads a constant: nothing runs backward
    through it, as under JAX's value_and_grad over the params only."""
    import repro_torch.kernels.ell_spmm as mod

    calls = []
    real = mod.ell_spmm_transpose
    monkeypatch.setattr(mod, "ell_spmm_transpose",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ids, mask, H = (torch.from_numpy(a) for a in _inputs(64, 4, 64, 8, "binary"))
    w = torch.ones(8, 3, requires_grad=True)
    agg = ell_spmm(ids, mask, H)
    assert agg.grad_fn is None
    (agg @ w).sum().backward()
    assert w.grad is not None and not calls
    H.requires_grad_()
    ell_spmm(ids, mask, H).sum().backward()
    assert calls == [1]


def _bad_inputs():
    ids, mask, H = (torch.from_numpy(a) for a in _inputs(16, 4, 16, 8, "binary"))
    return {
        "ids int64": ((ids.long(), mask, H), TypeError),
        "H float64": ((ids, mask, H.double()), TypeError),
        "mask shape": ((ids, mask[:, :3].contiguous(), H), ValueError),
        "H 1-D": ((ids, mask, H[:, 0].contiguous()), ValueError),
        "H not contiguous": ((ids, mask, H.t()), ValueError),
        "devices differ": ((ids, mask, H.to("meta")), ValueError),
        "neither cpu nor cuda": ((ids.to("meta"), mask.to("meta"),
                                  H.to("meta")), ValueError),
        "mask needs a gradient": ((ids, mask.requires_grad_(), H),
                                  NotImplementedError),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    args, exc = _bad_inputs()[case]
    with pytest.raises(exc):
        ell_spmm(*args)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing compiler is an error, never a silent fallback."""
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["ell_spmm"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("V,K,N,D,kind,normalize", CASES)
def test_cuda_kernel_matches_plain_on_card(cuda_device, V, K, N, D, kind,
                                           normalize):
    ids, mask, H = (torch.from_numpy(a).to(cuda_device)
                    for a in _inputs(V, K, N, D, kind))
    before = ell_spmm.launches
    got = ell_spmm(ids, mask, H, normalize=normalize)
    again = ell_spmm(ids, mask, H, normalize=normalize)
    want = tref.ell_spmm_ref(ids, mask, H, normalize=normalize)
    torch.cuda.synchronize()
    assert ell_spmm.launches == before + 2
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("V,K,N,D,kind,normalize", CASES)
def test_cuda_transpose_kernel_matches_plain_on_card(cuda_device, V, K, N, D,
                                                     kind, normalize):
    ids, mask, _ = (torch.from_numpy(a).to(cuda_device)
                    for a in _inputs(V, K, N, D, kind))
    ct = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (V, D)).astype(np.float32)).to(cuda_device)
    plan = ell_transpose_plan(ids, mask, N)
    before = ell_spmm_transpose.launches
    got = ell_spmm_transpose(ids, mask, ct, N, normalize=normalize, plan=plan)
    again = ell_spmm_transpose(ids, mask, ct, N, normalize=normalize)
    want = tref.ell_spmm_transpose_ref(ids, mask, ct, N, normalize=normalize)
    torch.cuda.synchronize()
    assert ell_spmm_transpose.launches == before + 2
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("V,K,N,D,kind,normalize", CASES[::3])
def test_cuda_gradient_through_ell_spmm_on_card(cuda_device, V, K, N, D, kind,
                                                normalize):
    ids, mask, H = (torch.from_numpy(a).to(cuda_device)
                    for a in _inputs(V, K, N, D, kind))
    ct = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (V, D)).astype(np.float32)).to(cuda_device)
    H.requires_grad_()
    before = ell_spmm_transpose.launches
    (got,) = torch.autograd.grad(ell_spmm(ids, mask, H, normalize=normalize),
                                 H, ct)
    want = tref.ell_spmm_transpose_ref(ids, mask, ct, N, normalize=normalize)
    assert ell_spmm_transpose.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=TOL, rtol=TOL)
