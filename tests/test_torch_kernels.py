"""The port's ELL-SpMM wrapper (`repro_torch.kernels.ell_spmm`) against the
Pallas kernel it replaces, run in interpret mode, and against both plain
versions; its gradient against `jax.vjp` of the reference's differentiable
`ell_spmm` (the custom_vjp scatter-add rule); the transpose plan against a
numpy construction.  The GAT kernels likewise: `sddmm_ell` against the
Pallas SDDMM and `jax.vjp` of the reference's `sddmm_ell`, `ell_attend` and
both its gradients against `jax.vjp` of the reference's `ell_attend`, and
the slot transpose against a numpy construction (a hub row and empty rows
among the cases).

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
    ell_attend,
    ell_attend_dw,
    ell_spmm,
    ell_spmm_transpose,
    ell_transpose_plan,
)
from repro_torch.kernels.sddmm import (
    ell_slot_gather,
    ell_slot_transpose,
    sddmm,
    sddmm_ell,
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
    # the widths of the GAT exchange and a single column, 40 slots a row (the
    # CUDA forward loads ids in two passes of 32; its lane groups are 1, 4, 8,
    # 16 and 32 lanes a slot at these widths)
    (200, 40, 300, 1, "binary", True),
    (200, 40, 300, 33, "weighted", False),
    (200, 40, 300, 65, "all_masked_rows", True),
    (200, 40, 300, 129, "weighted", True),
    (200, 40, 300, 257, "binary", False),
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
    elif kind == "hub_row":  # row 1 is named by 1000 unmasked slots
        hub = rng.choice(V * K, 1000, replace=False)
        ids.reshape(-1)[hub] = 1
        mask.reshape(-1)[hub] = 1.0
    elif kind == "empty_rows":  # no slot names an odd row
        ids -= ids % 2
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


# the gradient tier adds a hub row (one row of dH named by more than 1000
# slots: on the card, a segment of many 32-entry loads) and the widths 64
# and 128 at 40 slots a row (the transpose's lane groups of 16 lanes and a
# whole warp a plan entry on the 16-byte path)
GRAD_CASES = CASES + [
    (300, 12, 400, 64, "hub_row", False),
    (200, 40, 300, 64, "weighted", False),
    (200, 40, 300, 128, "binary", True),
]


@pytest.mark.parametrize("V,K,N,D,kind,normalize", GRAD_CASES)
def test_ell_spmm_gradient_matches_jax_vjp(V, K, N, D, kind, normalize):
    ids, mask, H = _inputs(V, K, N, D, kind)
    ct = np.random.default_rng(7).standard_normal((V, D)).astype(np.float32)
    if kind == "hub_row":
        assert int(((ids == 1) & (mask != 0)).sum()) > 1000
        # the hub's 1000-term sum at unit scale, the scale the fp32
        # tolerance is set for: at unit ct it reaches ~100, where JAX's
        # scatter-add on a GPU and a serial sum part by ~1e-4
        ct /= 100
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


def test_library_path_follows_headers_and_flags(monkeypatch, tmp_path):
    """The built library is keyed by the source, every csrc header it
    includes (through another header too) and the nvcc flags: editing any
    of them names a new library, so no stale build survives the edit."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text("int b;\n")
    (tmp_path / "c.cuh").write_text("int c;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "c.cuh").write_text("int c2;\n")  # not included
    assert build.library_path("k") == first
    seen = {first}
    for header in ("b.cuh", "a.cuh"):
        (tmp_path / header).write_text((tmp_path / header).read_text() + "// edit\n")
        assert build.library_path("k") not in seen
        seen.add(build.library_path("k"))
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-lineinfo"])
    assert build.library_path("k") not in seen


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


# widths that reach every lane group of the forward and the transpose (G
# lanes a slot, U units a lane: `with_lane_group` in csrc/ell_spmm.cu) on the 4-byte path
# (odd widths, and every width with H 4 bytes off alignment) and on the
# 16-byte path (D % 4 == 0, H aligned), the general form past 288 units
LANE_GROUP_WIDTHS = [1, 2, 3, 6, 11, 21, 41, 81, 300, 4, 8, 12, 16, 24, 32, 44,
                     64, 84, 128, 164, 256, 324, 1200]


@pytest.mark.parametrize("D", LANE_GROUP_WIDTHS)
def test_cuda_forward_lane_groups_on_card(cuda_device, D):
    V, K, N = 257, 40, 400
    ids, mask, _ = (torch.from_numpy(a).to(cuda_device)
                    for a in _inputs(V, K, N, 1, "weighted"))
    flat = torch.randn(N * D + 1, device=cuda_device)
    for H in (flat[:-1].view(N, D), flat[1:].view(N, D)):
        for normalize in (False, True):
            before = ell_spmm.launches
            got, again = (ell_spmm(ids, mask, H, normalize=normalize)
                          for _ in range(2))
            want = tref.ell_spmm_ref(ids, mask, H, normalize=normalize)
            torch.cuda.synchronize()
            assert ell_spmm.launches == before + 2
            assert torch.equal(got, again)
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       atol=TOL, rtol=TOL)


def test_cuda_slot_transpose_hub_row_on_card(cuda_device):
    """A hub row named by 10,000 slots spans many of the kernel's staged
    chunks, and the odd rows are named by none: the hub's sum carried across
    chunks in the plan's order, bitwise equal across launches, every empty
    row 0.  dz is drawn at scale 1/100 so that the hub's sum is unit-scale,
    the scale the fp32 tolerance is set for."""
    V, K, N = 4096, 8, 3000
    rng = np.random.default_rng(11)
    ids = rng.integers(0, N, (V, K)).astype(np.int32)
    ids -= ids % 2
    mask = (rng.random((V, K)) < 0.6).astype(np.float32)
    hub = rng.choice(V * K, 10000, replace=False)
    ids.reshape(-1)[hub], mask.reshape(-1)[hub] = 6, 1.0
    dz = (rng.standard_normal((V, K)) / 100).astype(np.float32)
    ids_c, mask_c, dz_c = (t.to(cuda_device) for t in _t(ids, mask, dz))
    plan = ell_transpose_plan(ids_c, mask_c, N)
    before = ell_slot_transpose.launches
    got, again = (ell_slot_transpose(ids_c, mask_c, dz_c, N, plan=plan)
                  for _ in range(2))
    torch.cuda.synchronize()
    assert ell_slot_transpose.launches == before + 2
    assert torch.equal(got, again)
    assert not got[1::2].any()
    np.testing.assert_allclose(got.cpu().numpy(), _numpy_slot_transpose(
        ids, mask, dz, N), atol=TOL, rtol=TOL)


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


@pytest.mark.parametrize("D", LANE_GROUP_WIDTHS)
def test_cuda_transpose_lane_groups_on_card(cuda_device, D):
    """The transpose runs the forward's row gather over the plan: every lane
    group, ct aligned and 4 bytes off alignment, 40 slots a row."""
    V, K, N = 257, 40, 400
    ids, mask, _ = (torch.from_numpy(a).to(cuda_device)
                    for a in _inputs(V, K, N, 1, "weighted"))
    plan = ell_transpose_plan(ids, mask, N)
    flat = torch.randn(V * D + 1, device=cuda_device)
    for ct in (flat[:-1].view(V, D), flat[1:].view(V, D)):
        for normalize in (False, True):
            before = ell_spmm_transpose.launches
            got, again = (ell_spmm_transpose(ids, mask, ct, N,
                                             normalize=normalize, plan=plan)
                          for _ in range(2))
            want = tref.ell_spmm_transpose_ref(ids, mask, ct, N,
                                               normalize=normalize)
            torch.cuda.synchronize()
            assert ell_spmm_transpose.launches == before + 2
            assert torch.equal(got, again)
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       atol=TOL, rtol=TOL)


@pytest.mark.parametrize("D", [64, 257])
def test_cuda_transpose_hub_segment_on_card(cuda_device, D):
    """A row of dH named by 10,000 slots (a segment of 313 loads of 32
    entries) and odd rows named by none: bitwise equal across launches,
    every empty row 0.  ct is drawn at scale 1/100 so that the hub's sum is
    unit-scale, the scale the fp32 tolerance is set for."""
    V, K, N = 4096, 8, 3000
    rng = np.random.default_rng(12)
    ids = rng.integers(0, N, (V, K)).astype(np.int32)
    ids -= ids % 2
    mask = (rng.random((V, K)) < 0.6).astype(np.float32)
    hub = rng.choice(V * K, 10000, replace=False)
    ids.reshape(-1)[hub], mask.reshape(-1)[hub] = 6, 1.0
    ct = (rng.standard_normal((V, D)) / 100).astype(np.float32)
    ids_c, mask_c, ct_c = (t.to(cuda_device) for t in _t(ids, mask, ct))
    plan = ell_transpose_plan(ids_c, mask_c, N)
    got, again = (ell_spmm_transpose(ids_c, mask_c, ct_c, N, normalize=False,
                                     plan=plan) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert not got[1::2].any()
    want = np.zeros((N, D))
    np.add.at(want, ids[mask != 0], (mask[..., None] * ct[:, None, :])[mask != 0])
    np.testing.assert_allclose(got.cpu().numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("D", [33, 129, 257])
def test_cuda_transpose_misaligned_odd_width_on_card(cuda_device, D):
    """ct 4 bytes off 16-byte alignment at the odd widths of the GAT
    exchange: the 4-byte path with every row start misaligned."""
    V, K, N = 1003, 40, 700
    ids, mask, _ = (torch.from_numpy(a).to(cuda_device)
                    for a in _inputs(V, K, N, 1, "weighted", seed=3))
    ct = torch.randn(V * D + 1, device=cuda_device)[1:].view(V, D)
    plan = ell_transpose_plan(ids, mask, N)
    for normalize in (False, True):
        got, again = (ell_spmm_transpose(ids, mask, ct, N, normalize=normalize,
                                         plan=plan) for _ in range(2))
        want = tref.ell_spmm_transpose_ref(ids, mask, ct, N,
                                           normalize=normalize)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("D", [33, 64])
def test_cuda_transpose_slots_past_2_31_on_card(cuda_device, D):
    """V * K past 2**31 (65,537 rows of 32,768 slots, 16 GB of ids and mask):
    the slots are divided in 64 bits into 32-bit rows.  The plan is built
    from the unmasked positions, 2,000 of them past 2**31."""
    V, K, N = 65537, 32768, 5000
    gen = torch.Generator().manual_seed(13)
    ids = torch.zeros((V, K), dtype=torch.int32, device=cuda_device)
    mask = torch.zeros((V, K), device=cuda_device)
    pos = torch.unique(torch.cat([
        torch.randint(0, V * K, (200000,), generator=gen),
        (V - 1) * K + torch.randperm(K, generator=gen)[:2000]]).to(cuda_device))
    ids.view(-1)[pos] = torch.randint(0, N, (pos.numel(),), generator=gen,
                                      dtype=torch.int32).to(cuda_device)
    mask.view(-1)[pos] = torch.rand(pos.numel(), generator=gen).to(cuda_device)
    mask.view(-1)[pos] += 0.1
    named, order = torch.sort(ids.view(-1)[pos].long(), stable=True)
    plan = (torch.searchsorted(named, torch.arange(N + 1, device=cuda_device)),
            pos[order])
    ct = torch.randn((V, D), generator=gen).to(cuda_device)
    got, again = (ell_spmm_transpose(ids, mask, ct, N, normalize=False,
                                     plan=plan) for _ in range(2))
    want = tref.ell_spmm_transpose_ref(ids, mask, ct, N, normalize=False)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=TOL, rtol=TOL)


def test_cuda_transpose_rejects_2_31_rows_on_card(cuda_device):
    """ct with 2**31 rows (ids, mask and ct of 8 GB each, every slot masked):
    the kernel keeps rows in 32 bits, so the wrapper raises, launching
    nothing."""
    V, N = 2 ** 31, 4
    ids = torch.zeros((V, 1), dtype=torch.int32, device=cuda_device)
    mask, ct = (torch.zeros((V, 1), device=cuda_device) for _ in range(2))
    plan = (torch.zeros(N + 1, dtype=torch.int64, device=cuda_device),
            torch.zeros(0, dtype=torch.int64, device=cuda_device))
    before = ell_spmm_transpose.launches
    with pytest.raises(ValueError, match="below 2"):
        ell_spmm_transpose(ids, mask, ct, N, normalize=False, plan=plan)
    assert ell_spmm_transpose.launches == before


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


# ---------------------------------------------------------------------------
# The GAT kernels: SDDMM, its slot transpose, ell_attend and its dw
# ---------------------------------------------------------------------------

SDDMM_CASES = [  # V, K, N (>= V: the dst rows are the table's prefix), D, mask
    (128, 8, 129, 64, "binary"),
    (1003, 7, 1004, 37, "binary"),
    (1003, 9, 1500, 36, "all_masked_rows"),
    (256, 1, 300, 32, "binary"),
    (200, 12, 201, 257, "binary"),  # the fused widths of the GAT exchange
    (300, 40, 301, 65, "all_masked_rows"),
]
# ell_attend over the ELL cases, each with attention-like weights: positive
# on the structure, zero off it
ATTEND_CASES = sorted({(V, K, N, D, kind) for V, K, N, D, kind, _ in CASES}) + [
    (200, 12, 201, 257, "binary"), (300, 40, 301, 33, "all_masked_rows")]


def _sddmm_inputs(V, K, N, D, kind, seed=0):
    ids, mask, Hw = _inputs(V, K, N, D, kind, seed)
    rng = np.random.default_rng(seed + 1)
    a_src, a_dst = ((rng.standard_normal(D) / np.sqrt(D)).astype(np.float32)
                    for _ in range(2))
    return ids, mask, Hw, a_src, a_dst


def _attend_inputs(V, K, N, D, kind, seed=0):
    ids, mask, H = _inputs(V, K, N, D, kind, seed)
    w = (mask != 0) * np.random.default_rng(seed + 2).random((V, K))
    return ids, mask, w.astype(np.float32), H


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("V,K,N,D,kind", SDDMM_CASES)
def test_sddmm_matches_pallas_and_plain(V, K, N, D, kind):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    from repro.kernels.sddmm import sddmm_ell as jsddmm_ell

    args = _sddmm_inputs(V, K, N, D, kind)
    got = sddmm_ell(*_t(*args)).numpy()
    pallas = np.asarray(jsddmm_ell(*map(jnp.asarray, args), interpret=True))
    plain = np.asarray(jref.sddmm_ref(*map(jnp.asarray, args)))
    assert got.shape == (V, K) and got.dtype == np.float32
    masked = args[1] == 0
    assert (got[masked] == -1e30).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, pallas, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, plain, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("V,K,N,D,kind", SDDMM_CASES[1:5])
def test_sddmm_gradient_matches_jax_vjp(V, K, N, D, kind):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels.sddmm import sddmm_ell as jsddmm_ell

    ids, mask, Hw, a_src, a_dst = _sddmm_inputs(V, K, N, D, kind)
    ct = np.random.default_rng(7).standard_normal((V, K)).astype(np.float32)
    leaves = [t.requires_grad_() for t in _t(Hw, a_src, a_dst)]
    got = torch.autograd.grad(sddmm_ell(*_t(ids, mask), *leaves), leaves,
                              torch.from_numpy(ct))
    jids, jmask = jnp.asarray(ids), jnp.asarray(mask)
    _, vjp = jax.vjp(lambda h, s, d: jsddmm_ell(jids, jmask, h, s, d,
                                                interpret=True),
                     *map(jnp.asarray, (Hw, a_src, a_dst)))
    for ours, theirs in zip(got, vjp(jnp.asarray(ct))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("V,K,N,D,kind", ATTEND_CASES)
def test_ell_attend_and_its_gradients_match_jax_vjp(V, K, N, D, kind):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels.ell_spmm import ell_attend as jell_attend

    ids, _, w, H = _attend_inputs(V, K, N, D, kind)
    ct = np.random.default_rng(7).standard_normal((V, D)).astype(np.float32)
    wt, Ht = (t.requires_grad_() for t in _t(w, H))
    out = ell_attend(torch.from_numpy(ids), wt, Ht)
    dw, dH = torch.autograd.grad(out, (wt, Ht), torch.from_numpy(ct))
    jids = jnp.asarray(ids)
    jout, vjp = jax.vjp(lambda w_, h_: jell_attend(jids, w_, h_, interpret=True),
                        jnp.asarray(w), jnp.asarray(H))
    jdw, jdH = vjp(jnp.asarray(ct))
    for ours, theirs in ((out.detach(), jout), (dw, jdw), (dH, jdH)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   atol=TOL, rtol=TOL)
    # dw covers every slot: a masked slot reads the row its id names
    want = (ct[:, None, :] * H[ids]).sum(-1)
    np.testing.assert_allclose(dw.numpy(), want, atol=TOL, rtol=TOL)
    assert torch.equal(dw, ell_attend_dw(*_t(ids, ct, H)))


def _numpy_slot_transpose(ids, mask, dz, N):
    g = np.zeros(N, np.float64)
    np.add.at(g, ids[mask != 0], dz[mask != 0])
    return g


# the ELL cases, a hub row (one segment of 1000 slots) and rows that no slot
# names (empty segments)
SLOT_CASES = CASES[::2] + [(300, 12, 400, 8, "hub_row", True),
                           (300, 12, 400, 8, "empty_rows", True)]


@pytest.mark.parametrize("V,K,N,D,kind,normalize", SLOT_CASES)
def test_slot_transpose_and_gather_match_numpy(V, K, N, D, kind, normalize):
    ids, mask, _ = _inputs(V, K, N, D, kind)
    dz = np.random.default_rng(3).standard_normal((V, K)).astype(np.float32)
    got = ell_slot_transpose(*_t(ids, mask, dz), N)
    assert got.shape == (N,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _numpy_slot_transpose(
        ids, mask, dz, N), atol=TOL, rtol=TOL)
    if kind == "hub_row":
        assert int(((ids == 1) & (mask != 0)).sum()) >= 1000
    if kind == "empty_rows":
        assert not got[1::2].any()
    # the gather col[ids] on the unmasked slots has it as its gradient
    col = torch.from_numpy(np.random.default_rng(4).standard_normal(
        N).astype(np.float32)).requires_grad_()
    s = ell_slot_gather(col, *_t(ids, mask))
    want = np.where(mask != 0, col.detach().numpy()[ids], 0.0)
    assert np.array_equal(s.detach().numpy(), want)
    (grad,) = torch.autograd.grad(s, col, torch.from_numpy(dz))
    assert torch.equal(grad, got)


def test_plain_dw_walks_rows_in_chunks_with_the_same_math():
    V, K, N, D = 4096, 64, 2048, 80
    assert V * K * D > tref._GATHER_ELEMS
    ids, _, H = _inputs(V, K, N, D, "binary", seed=1)
    ct = np.random.default_rng(5).standard_normal((V, D)).astype(np.float32)
    got = tref.ell_attend_dw_ref(*_t(ids, ct, H)).numpy()
    want = np.einsum("vd,vkd->vk", ct.astype(np.float64),
                     H.astype(np.float64)[ids])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_cpu_gat_kernel_calls_take_plain_versions_and_count_no_launch():
    ids, mask, Hw, a_src, a_dst = _t(*_sddmm_inputs(64, 4, 65, 8, "binary"))
    counters = (ell_spmm, ell_spmm_transpose, ell_attend_dw, sddmm,
                ell_slot_transpose)
    before = [f.launches for f in counters]
    leaves = [t.requires_grad_() for t in (Hw, a_src, a_dst)]
    e = sddmm_ell(ids, mask, *leaves)
    pw = torch.exp(e - e.amax(1, keepdim=True).detach()) * (e > -1e29)
    ell_attend(ids, pw, leaves[0]).sum().backward()
    assert all(t.grad is not None for t in leaves)
    assert [f.launches for f in counters] == before


def _bad_gat_inputs():
    ids, mask, Hw, a_src, a_dst = _t(*_sddmm_inputs(16, 4, 17, 8, "binary"))
    ct = torch.zeros(16, 8)
    return {
        "sddmm table shorter than V": (lambda: sddmm(ids, mask, Hw[:15], a_src,
                                                     a_dst), ValueError),
        "sddmm a_src width": (lambda: sddmm(ids, mask, Hw, a_src[:7], a_dst),
                              ValueError),
        "sddmm ids int64": (lambda: sddmm(ids.long(), mask, Hw, a_src, a_dst),
                            TypeError),
        "dw ct shape": (lambda: ell_attend_dw(ids, ct[:, :7].contiguous(), Hw),
                        ValueError),
        "dw ct not contiguous": (lambda: ell_attend_dw(ids, torch.zeros(
            8, 16).t(), Hw), ValueError),
        "slot transpose dz shape": (lambda: ell_slot_transpose(
            ids, mask, torch.zeros(16, 3), 17), ValueError),
        "attend weights shape": (lambda: ell_attend(ids, mask[:, :3].contiguous(),
                                                    Hw), ValueError),
        "slot gather 2-D column": (lambda: ell_slot_gather(Hw, ids, mask),
                                   ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_gat_inputs()))
def test_gat_wrappers_reject_what_the_kernels_do_not_take(case):
    call, exc = _bad_gat_inputs()[case]
    with pytest.raises(exc):
        call()


def test_sddmm_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["sddmm"])


@pytest.mark.parametrize("V,K,N,D,kind", SDDMM_CASES)
def test_cuda_sddmm_and_slot_transpose_match_plain_on_card(cuda_device, V, K,
                                                           N, D, kind):
    ids, mask, Hw, a_src, a_dst = (t.to(cuda_device) for t in _t(
        *_sddmm_inputs(V, K, N, D, kind)))
    before = sddmm.launches, ell_slot_transpose.launches
    got, again = (sddmm(ids, mask, Hw, a_src, a_dst) for _ in range(2))
    want = tref.sddmm_ref(ids, mask, Hw, a_src, a_dst)
    dz = torch.randn((V, K), device=cuda_device) * (mask != 0)
    plan = ell_transpose_plan(ids, mask, N)
    g, g_again = (ell_slot_transpose(ids, mask, dz, N, plan=plan)
                  for _ in range(2))
    g_want = tref.ell_slot_transpose_ref(ids, mask, dz, N)
    torch.cuda.synchronize()
    assert (sddmm.launches, ell_slot_transpose.launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(got, again) and torch.equal(g, g_again)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(g.cpu().numpy(), g_want.cpu().numpy(),
                               atol=TOL, rtol=TOL)


# the dw kernel's lane groups (1-32 lanes a slot, 1, 2 or 9 units a lane,
# 96 the 3 units of a group of 8 with the rest predicated off, and the
# general form past 288 units), rows of 33 and 100 slots (ids staged in
# more than one pass of 32)
DW_CUDA_CASES = ATTEND_CASES + [
    (257, 33, 400, D, "binary") for D in (1, 4, 8, 16, 31, 32, 33, 96, 128, 300)
] + [(257, 100, 400, D, "weighted") for D in (4, 33, 128)]


@pytest.mark.parametrize("V,K,N,D,kind", DW_CUDA_CASES)
def test_cuda_dw_kernel_matches_plain_on_card(cuda_device, V, K, N, D, kind):
    ids, _, _, H = (t.to(cuda_device) for t in _t(*_attend_inputs(
        V, K, N, D, kind)))
    ct = torch.randn((V, D), device=cuda_device)
    # a contiguous ct 4 bytes off 16-byte alignment takes the 4-byte path
    flat = torch.randn(V * D + 1, device=cuda_device)
    for c in (ct, flat[1:].view(V, D)):
        before = ell_attend_dw.launches
        got, again = (ell_attend_dw(ids, c, H) for _ in range(2))
        want = tref.ell_attend_dw_ref(ids, c, H)
        torch.cuda.synchronize()
        assert ell_attend_dw.launches == before + 2
        assert torch.equal(got, again)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=TOL, rtol=TOL)


def test_cuda_dw_kernel_general_form_on_card(cuda_device):
    """Rows past 288 units a lane group can keep in registers (D = 1200 on
    the 16-byte path, 1200 and 300 on the 4-byte path) take the kernel's
    general form.  ct is drawn with variance 1/D, so each dw is a unit-scale
    dot product, the scale the fp32 tolerance is set for: with unit ct the
    1200-term sums reach |dw| ~ 100, where two fp32 summation orders part by
    more than 1e-5."""
    V, K, N = 257, 100, 400
    for D in (300, 1200):
        ids, _, _, H = (t.to(cuda_device) for t in _t(*_attend_inputs(
            V, K, N, D, "weighted")))
        ct = torch.randn((V, D), device=cuda_device) * D ** -0.5
        flat = torch.randn(V * D + 1, device=cuda_device) * D ** -0.5
        for c in (ct, flat[1:].view(V, D)):
            got, again = (ell_attend_dw(ids, c, H) for _ in range(2))
            want = tref.ell_attend_dw_ref(ids, c, H)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       atol=TOL, rtol=TOL)


@pytest.mark.parametrize("V,K,N,D,kind", SDDMM_CASES[::2])
def test_cuda_gat_gradients_on_card(cuda_device, V, K, N, D, kind):
    """sddmm_ell and ell_attend under autograd on the card equal the same
    composition on the CPU (plain versions).  Two kernels and a softmax
    composed, their sums taken in another order on each side: the repo's
    oracle bound, 1e-4."""
    cpu = _t(*_sddmm_inputs(V, K, N, D, kind))
    ct = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (V, D)).astype(np.float32))
    grads = []
    for dev in (torch.device("cpu"), cuda_device):
        ids, mask, *leaves = (t.to(dev) for t in cpu)
        leaves = [t.requires_grad_() for t in leaves]
        plan = ell_transpose_plan(ids, mask, N)
        e = sddmm_ell(ids, mask, *leaves, plan=plan)
        pw = torch.exp(e - e.amax(1, keepdim=True).detach()) * (e > -1e29)
        out = ell_attend(ids, pw, leaves[0], plan=plan)
        grads.append([g.cpu() for g in torch.autograd.grad(
            out, leaves, ct.to(dev))])
    for ours, theirs in zip(*grads):
        np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=1e-4,
                                   rtol=1e-4)
