"""The port's kernel API for the language-model kernels
(`repro_torch.kernels.ops.flash_attention` and `wkv`) against the JAX
package: flash attention against `repro.kernels.ref.flash_attention_ref`
over the cases of `tests/test_kernels.py::test_flash_attention`, and the
chunked WKV against `wkv_chunk_pallas` (interpret mode) and `wkv_chunk_ref`
over the cases of `test_wkv_chunk`, with the same tolerances.  The Pallas
flash kernel itself cannot run here: this jax's `pallas` has no `load`,
which `_flash_kernel` calls, so the flash cases hold the port to the
reference's plain version; `wkv_with_state` (y and the final state)
against the reference model's scan `_chunked_linear_attention(...,
return_state=True)`.  Also: the copied model configs (fields, q_dim and
kv_dim) and the input shapes equal the reference's, CPU calls launch
nothing, the input guards, and a missing nvcc.

On a CPU-only host the wrappers take their plain versions (the CUDA kernels
have no CPU mode) and the CUDA-only tests skip.  On a host with a card they
hold each kernel to its plain version:

    PYTHONPATH=src python -m pytest -q tests/test_torch_lm_kernels.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.configs import llama3_2_1b as tllama
from repro_torch.configs import rwkv6_3b as trwkv
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wkv_chunk as twkv

# the JAX tier's tolerances (tests/test_kernels.py): atol = rtol
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# bf16 kernel against its plain version: each rounds every p to bf16 (2**-8
# relative) and the output once more, so |kernel - plain| <= atol + 2**-7
# (|plain| + P.|V|)
FLASH_BF16_CARD_ATOL, FLASH_BF16_CARD_RTOL = 1e-3, 2.0 ** -7
WKV_ATOL, WKV_RTOL = 1e-4, 1e-3
# bf16 outputs: both sides compute in fp32 and round once to bf16, which
# may land one bf16 step apart (2**-7 relative)
WKV_BF16_RTOL = 2.0 ** -7

FLASH_CASES = [(1, 2, 128, 64), (2, 4, 256, 64), (1, 1, 512, 128)]
WKV_CASES = [(1, 2, 64, 16, 16), (2, 3, 128, 32, 32), (1, 1, 128, 64, 64)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small tensors: more only
    contend with the other test workers' processes on a shared host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref

    return jnp, jref


def _full_precision():
    """Where JAX runs on a card, its fp32 einsum defaults to TF32: hold the
    reference to full fp32 (a no-op on the CPU)."""
    import jax

    return jax.default_matmul_precision("highest")


def _qkv(B, H, S, T, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _wkv_inputs(B, H, S, K, seed=0, g_scale=1.0):
    """Drawn as `tests/test_kernels.py::test_wkv_chunk` draws them."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, K)).astype(np.float32) * 0.5
               for _ in range(3))
    g = (-np.exp(rng.standard_normal((B, H, S, K)) * 0.5 - 1.0)
         * g_scale).astype(np.float32)
    u = (rng.standard_normal((H, K)) * 0.1).astype(np.float32)
    return r, k, v, g, u


def _torch_dtype(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


@pytest.mark.parametrize("B,H,S,D", FLASH_CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax_reference(B, H, S, D, causal, dtype):
    jnp, jref = _jax()
    q, k, v = _qkv(B, H, S, S, D)
    with _full_precision():
        want = jref.flash_attention_ref(*(jnp.asarray(a, getattr(jnp, dtype))
                                          for a in (q, k, v)), causal=causal)
    got = ops.flash_attention(*(torch.from_numpy(a).to(_torch_dtype(dtype))
                                for a in (q, k, v)), causal=causal)
    assert got.dtype == _torch_dtype(dtype) and got.shape == (B, H, S, D)
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def test_flash_attention_with_more_keys_than_queries():
    """S != T: non-causal against the JAX reference; causal (k <= q on
    absolute indices, which the reference's tril(S, S) cannot express)
    against a float64 numpy softmax."""
    jnp, jref = _jax()
    q, k, v = _qkv(1, 2, 96, 160, 32, seed=3)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=False)
    with _full_precision():
        want = jref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                        causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) / np.sqrt(32)
    s = np.where(np.arange(160)[None, :] <= np.arange(96)[:, None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def _bwd_bf16_kernel_arithmetic(q, k, v, do, causal):
    """The bf16 backward kernels' arithmetic in plain torch: every product
    summed in fp32 from bf16 operands; P = exp(s / sqrt(D) - lse) rounded to
    bf16 before dV = P^T.dO; dS = P (dP - delta) rounded to bf16 before
    dQ and dK; delta = rowsum(dO o O) of the forward's bf16 output; lse and
    o the forward's plain version's."""
    S, T, D = q.shape[2], k.shape[2], q.shape[3]
    scale = D ** -0.5
    o, lse = tref.flash_attention_lse_ref(q, k, v, causal=causal)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p = torch.exp(qf @ kf.transpose(-1, -2) * scale - lse[..., None])
    if causal:
        seen = torch.arange(T)[None, :] <= torch.arange(S)[:, None]
        p = torch.where(seen, p, torch.zeros_like(p))
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = (p * (dof @ vf.transpose(-1, -2) - delta)).bfloat16().float()
    dq = ds @ kf * scale
    dk = ds.transpose(-1, -2) @ qf * scale
    dv = p.bfloat16().float().transpose(-1, -2) @ dof
    return tuple(t.bfloat16() for t in (dq, dk, dv))


def _bwd_term_scales(q, k, v, do, causal):
    """Each gradient's sum of the magnitudes of its terms, as `chip_smoke.py`
    holds the card's backward (`flash_bwd_plain`): |dS| = P (|dP| +
    |delta|) times |K| or |Q| (and the scale), P^T |dO|; all fp32."""
    S, T, D = q.shape[2], k.shape[2], q.shape[3]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = qf @ kf.transpose(-1, -2) / D ** 0.5
    if causal:
        seen = torch.arange(T)[None, :] <= torch.arange(S)[:, None]
        s = torch.where(seen, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, -1)
    dp = dof @ vf.transpose(-1, -2)
    ads = p * (dp.abs() + (p * dp).sum(-1, keepdim=True).abs())
    return (ads @ kf.abs() / D ** 0.5, ads.transpose(-1, -2) @ qf.abs() / D ** 0.5,
            p.transpose(-1, -2) @ dof.abs())


# B, H, S, T, D, causal: S = T unless non-causal (the JAX reference's
# causal mask is tril(S, S)); a ragged S % 4 != 0 row count
BWD_ROUNDING_CASES = [(1, 2, 64, 64, 32, True), (1, 2, 129, 129, 64, True),
                      (2, 1, 96, 160, 64, False)]


@pytest.mark.parametrize("B,H,S,T,D,causal", BWD_ROUNDING_CASES)
def test_bf16_backward_rounding_fits_the_card_tolerance(B, H, S, T, D, causal):
    """The bf16 backward kernels round P and dS to bf16 before their
    products and sum in fp32 (`_bwd_bf16_kernel_arithmetic`, the card's
    arithmetic in plain torch): each gradient stays within the card tier's
    bf16 bound (2**-6 of the largest gradient) of the plain backward
    (`ref.flash_attention_bwd_ref`) and of `jax.vjp` through the JAX
    reference, and within `chip_smoke.py`'s FLASH_BWD_TOL (1e-3 + 2**-6 of
    |plain| + the magnitudes of the gradient's terms) of the plain one."""
    jnp, jref = _jax()
    import jax

    q, k, v = _qkv(B, H, S, T, D, seed=9)
    do = np.random.default_rng(10).standard_normal(q.shape).astype(np.float32)
    args = [torch.from_numpy(a).bfloat16() for a in (q, k, v, do)]
    got = _bwd_bf16_kernel_arithmetic(*args, causal)
    plain = tref.flash_attention_bwd_ref(*args, causal=causal)
    with _full_precision():
        _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(a, b, c, causal=causal),
                         *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
        from_jax = vjp(jnp.asarray(do, jnp.bfloat16))
    scales = _bwd_term_scales(*args, causal)
    for g, w, j, sc in zip(got, plain, from_jax, scales):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        for want in (w.float(), torch.from_numpy(np.asarray(j, np.float32))):
            gap = float((g.float() - want).abs().max())
            assert gap <= 2.0 ** -6 * float(want.abs().max()), gap
        over = (g.float() - w.float()).abs() - (1e-3 + 2.0 ** -6 * (sc + w.float().abs()))
        assert float(over.max()) <= 0, float(over.max())


def _jax_wkv(r, k, v, g, u, chunk):
    jnp, jref = _jax()
    from repro.kernels.wkv_chunk import wkv_chunk_pallas

    args = [jnp.asarray(a) for a in (r, k, v, g, u)]
    with _full_precision():
        pallas = wkv_chunk_pallas(*args, chunk=chunk, interpret=True)
        oracle = jref.wkv_chunk_ref(*args[:3], jnp.clip(args[3], -1.2, 0.0),
                                    args[4])
    return np.asarray(pallas), np.asarray(oracle)


@pytest.mark.parametrize("B,H,S,K,chunk", WKV_CASES)
def test_wkv_matches_pallas_and_reference(B, H, S, K, chunk):
    inputs = _wkv_inputs(B, H, S, K)
    got = ops.wkv(*(torch.from_numpy(a) for a in inputs), chunk=chunk).numpy()
    for want in _jax_wkv(*inputs, chunk):
        np.testing.assert_allclose(got, want, atol=WKV_ATOL, rtol=WKV_RTOL)


def test_wkv_clips_the_decay_below_its_floor():
    """g reaching far below -1.2: both packages hold it at -1.2, so the
    result equals the reference's on the clipped g."""
    inputs = _wkv_inputs(1, 2, 64, 16, seed=4, g_scale=8.0)
    assert inputs[3].min() < -3.0
    got = ops.wkv(*(torch.from_numpy(a) for a in inputs), chunk=16).numpy()
    for want in _jax_wkv(*inputs, 16):
        np.testing.assert_allclose(got, want, atol=WKV_ATOL, rtol=WKV_RTOL)
    clipped = list(inputs)
    clipped[3] = np.clip(inputs[3], -1.2, 0.0)
    again = ops.wkv(*(torch.from_numpy(a) for a in clipped), chunk=16).numpy()
    np.testing.assert_array_equal(got, again)


@pytest.mark.parametrize("B,H,S,K,chunk", WKV_CASES)
def test_wkv_with_state_matches_the_reference_scan(B, H, S, K, chunk):
    """`wkv_with_state` (CPU: the plain recurrence with its final state)
    against the reference model's scan, `_chunked_linear_attention(...,
    mode="rwkv", return_state=True)`, on [B,S,H,K] views of the same
    inputs; y also equal to `ops.wkv`'s."""
    jnp, _ = _jax()
    from repro.models.ssm import _chunked_linear_attention

    r, k, v, g, u = _wkv_inputs(B, H, S, K)
    y, state = ops.wkv_with_state(*(torch.from_numpy(a) for a in (r, k, v, g, u)),
                                  chunk=chunk)
    assert state.shape == (B, H, K, K) and state.dtype == torch.float32
    np.testing.assert_array_equal(
        y.numpy(), ops.wkv(*(torch.from_numpy(a) for a in (r, k, v, g, u)),
                           chunk=chunk).numpy())
    seq = [jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (r, k, v, g)]
    with _full_precision():
        want_y, want_state = _chunked_linear_attention(
            *seq, chunk=chunk, mode="rwkv", bonus=jnp.asarray(u),
            return_state=True)
    np.testing.assert_allclose(y.numpy(),
                               np.asarray(want_y).transpose(0, 2, 1, 3),
                               atol=WKV_ATOL, rtol=WKV_RTOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state),
                               atol=WKV_ATOL, rtol=WKV_RTOL)


@pytest.mark.parametrize("name", ["llama3.2-1b", "rwkv6-3b"])
@pytest.mark.parametrize("which", ["CONFIG", "smoke_config"])
def test_config_properties_equal_the_reference(name, which):
    """The derived widths the serving path reads, beside the fields."""
    pytest.importorskip("jax")
    import importlib

    module = name.replace("-", "_").replace(".", "_")
    ref_mod = importlib.import_module(f"repro.configs.{module}")
    port_mod = {"llama3.2-1b": tllama, "rwkv6-3b": trwkv}[name]
    want, got = (getattr(m, which) for m in (ref_mod, port_mod))
    want, got = (c() if callable(c) else c for c in (want, got))
    for prop in ("q_dim", "kv_dim"):
        assert getattr(got, prop) == getattr(want, prop), prop


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_serving_shapes_equal_the_reference(shape):
    pytest.importorskip("jax")
    from repro.configs.base import INPUT_SHAPES

    assert tbase.INPUT_SHAPES[shape] == tbase.ShapeConfig(
        *dataclasses.astuple(INPUT_SHAPES[shape]))


@pytest.mark.parametrize("name", ["llama3.2-1b", "rwkv6-3b"])
@pytest.mark.parametrize("which", ["CONFIG", "smoke_config"])
def test_config_copies_equal_the_reference(name, which):
    pytest.importorskip("jax")
    import importlib

    module = name.replace("-", "_").replace(".", "_")
    ref_mod = importlib.import_module(f"repro.configs.{module}")
    port_mod = {"llama3.2-1b": tllama, "rwkv6-3b": trwkv}[name]
    want, got = (getattr(m, which) for m in (ref_mod, port_mod))
    want, got = (c() if callable(c) else c for c in (want, got))
    fields = [f.name for f in dataclasses.fields(got)]
    assert len(fields) >= 15
    for field in fields:
        assert getattr(got, field) == getattr(want, field), field


def test_train_4k_shape_equals_the_reference():
    pytest.importorskip("jax")
    from repro.configs.base import INPUT_SHAPES

    assert tbase.INPUT_SHAPES["train_4k"] == tbase.ShapeConfig(
        *dataclasses.astuple(INPUT_SHAPES["train_4k"]))


def test_cpu_calls_take_plain_versions_and_launch_nothing():
    before = ops.flash_attention.launches, ops.wkv.launches
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 64, 64, 32))
    torch.testing.assert_close(ops.flash_attention(q, k, v),
                               tref.flash_attention_ref(q, k, v, causal=True),
                               rtol=0, atol=0)
    inputs = [torch.from_numpy(a) for a in _wkv_inputs(1, 2, 32, 16)]
    ops.wkv(*inputs, chunk=16)
    assert (ops.flash_attention.launches, ops.wkv.launches) == before


def _bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 64, 64, 32))
    r, kk, vv, g, u = (torch.from_numpy(a) for a in _wkv_inputs(1, 2, 64, 16))
    flash, wkv = ops.flash_attention, ops.wkv
    return {
        "flash rank 3": (lambda: flash(q[0], k[0], v[0]), ValueError),
        "flash k, v shapes differ": (lambda: flash(q, k, v[:, :, :32]), ValueError),
        "flash head dim differs": (lambda: flash(q, k[..., :16], v[..., :16]),
                                   ValueError),
        "flash heads differ": (lambda: flash(q, k[:, :1], v[:, :1]), ValueError),
        "flash dtypes mixed": (lambda: flash(q, k.bfloat16(), v), TypeError),
        "flash float64": (lambda: flash(q.double(), k.double(), v.double()),
                          TypeError),
        "flash neither cpu nor cuda": (lambda: flash(q.to("meta"), k.to("meta"),
                                                     v.to("meta")), ValueError),
        "flash kernel D=48": (lambda: tflash._check_kernel(
            *(torch.zeros(1, 2, 64, 48) for _ in range(3))), ValueError),
        "flash backward lse shape": (lambda: tflash.flash_attention_bwd(
            q, k, v, q, torch.zeros(1, 2, 32), q), ValueError),
        "flash kernel not contiguous": (lambda: tflash._check_kernel(
            q.transpose(2, 3).contiguous().transpose(2, 3), k, v), ValueError),
        "wkv rank 3": (lambda: wkv(r[0], kk[0], vv[0], g[0], u), ValueError),
        "wkv shapes differ": (lambda: wkv(r, kk[:, :, :32], vv, g, u), ValueError),
        "wkv u shape": (lambda: wkv(r, kk, vv, g, u[:1]), ValueError),
        "wkv dtypes mixed": (lambda: wkv(r, kk, vv, g.bfloat16(), u), TypeError),
        "wkv S % chunk": (lambda: wkv(r, kk, vv, g, u, chunk=24), ValueError),
        "wkv kernel K=24": (lambda: twkv._check_kernel(
            *(torch.zeros(1, 2, 64, 24) for _ in range(4)), torch.zeros(2, 24)),
            ValueError),
        "wkv backward dy shape": (lambda: twkv.wkv_bwd(
            r, kk, vv, g, u, vv[:, :, :32]), ValueError),
        "wkv kernel off a 16-byte boundary": (lambda: twkv._check_kernel(
            *(torch.zeros(4 * 64 * 16 + 1)[1:].view(1, 4, 64, 16)
              for _ in range(4)), torch.zeros(4, 16)), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    call, exc = _bad_inputs()[case]
    with pytest.raises(exc):
        call()


@pytest.mark.parametrize("chunk", [256, 4096])
def test_wkv_kernel_takes_any_chunk(chunk):
    """The kernel walks S in tiles of its own, so every chunk the reference
    takes (S a multiple of min(chunk, S)) passes both paths' checks."""
    r, k, v, g = (torch.zeros(1, 2, 4096, 64) for _ in range(4))
    u = torch.zeros(2, 64)
    twkv._check(r, k, v, g, u, chunk)
    twkv._check_kernel(r, k, v, g, u)


@pytest.mark.parametrize("source", ["flash_attention", "wkv_chunk"])
def test_build_without_nvcc_raises(monkeypatch, tmp_path, source):
    """A missing compiler is an error, never a silent fallback."""
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build([source])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in fp32
    return torch.device("cuda")


CUDA_FLASH_CASES = [  # B, H, S, T, D, causal, dtype
    (1, 4, 256, 256, 64, True, "bfloat16"),
    (1, 4, 256, 256, 64, False, "bfloat16"),
    (1, 4, 256, 256, 64, True, "float32"),
    (1, 2, 256, 256, 128, True, "bfloat16"),
    (1, 2, 256, 256, 128, False, "float32"),
    (2, 3, 1000, 1000, 64, True, "bfloat16"),
    (2, 3, 1000, 1000, 64, True, "float32"),
    (1, 2, 130, 515, 64, False, "bfloat16"),
    (1, 2, 512, 1536, 64, False, "float32"),
    (1, 2, 200, 77, 64, True, "float32"),
    (1, 4, 192, 192, 32, True, "bfloat16"),
    (1, 4, 192, 192, 32, False, "float32"),
    (1, 2, 64, 0, 64, True, "bfloat16"),  # no key: the output is 0
] + [
    # around the kernel's query tiles (128 rows bf16, 64 fp32) and key tiles
    # (64 keys, 32 at fp32 D = 128): S and T of 127-129, T within one key
    # tile (shorter than the ring), causal with S != T, no key at all
    (1, 3, S, T, D, causal, dtype)
    for dtype in ("bfloat16", "float32") for D in (32, 64, 128)
    for S, T, causal in ((127, 127, True), (128, 129, False), (129, 128, True),
                         (129, 257, True), (257, 33, False), (129, 0, True))
]


@pytest.mark.parametrize("B,H,S,T,D,causal,dtype", CUDA_FLASH_CASES)
def test_cuda_flash_kernel_matches_plain_on_card(cuda_device, B, H, S, T, D,
                                                 causal, dtype):
    q, k, v = (torch.from_numpy(a).to(cuda_device, _torch_dtype(dtype))
               for a in _qkv(B, H, S, T, D))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    again = ops.flash_attention(q, k, v, causal=causal)
    want = tref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 2
    assert got.dtype == q.dtype and torch.isfinite(got.float()).all()
    assert torch.equal(got, again)
    if dtype == "float32":
        tol = FLASH_TOL[dtype]
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=tol, rtol=tol)
        return
    scale = (want.float().abs()
             + tref.flash_attention_ref(q, k, v.abs(), causal=causal).float())
    over = ((got.float() - want.float()).abs()
            - (FLASH_BF16_CARD_ATOL + FLASH_BF16_CARD_RTOL * scale))
    assert over.numel() == 0 or float(over.max()) <= 0, float(over.max())


CUDA_WKV_CASES = [  # B, H, S, K, chunk, dtype, g_scale
    (1, 2, 64, 16, 16, "float32", 1.0),
    (2, 3, 128, 32, 32, "float32", 1.0),
    (1, 2, 256, 64, 64, "float32", 1.0),
    (1, 2, 256, 64, 128, "float32", 1.0),
    (1, 2, 100, 64, 50, "float32", 1.0),
    (2, 2, 128, 64, 64, "bfloat16", 1.0),
    (1, 2, 128, 64, 64, "float32", 8.0),
    # the kernel's own 32-step tile, whatever the chunk: chunk 1, chunk
    # 256, a ragged last tile (1000 = 31 x 32 + 8), and K = 16, 32 over 128
    # tiles, where the last tile decides
    (1, 2, 256, 64, 1, "float32", 1.0),
    (1, 2, 512, 64, 256, "float32", 1.0),
    (1, 2, 1000, 64, 1000, "float32", 1.0),
    (1, 2, 1000, 32, 1000, "bfloat16", 1.0),
    (1, 2, 4096, 16, 64, "float32", 1.0),
    (1, 2, 4096, 32, 64, "float32", 1.0),
]


@pytest.mark.parametrize("B,H,S,K,chunk,dtype,g_scale", CUDA_WKV_CASES)
def test_cuda_wkv_kernel_matches_plain_on_card(cuda_device, B, H, S, K, chunk,
                                               dtype, g_scale):
    r, k, v, g, u = (torch.from_numpy(a).to(cuda_device, _torch_dtype(dtype))
                     for a in _wkv_inputs(B, H, S, K, g_scale=g_scale))
    before = ops.wkv.launches
    got = ops.wkv(r, k, v, g, u, chunk=chunk)
    again = ops.wkv(r, k, v, g, u, chunk=chunk)
    want = tref.wkv_chunk_ref(r, k, v, torch.clamp(g, -1.2, 0.0), u)
    torch.cuda.synchronize()
    assert ops.wkv.launches == before + 2
    assert got.dtype == r.dtype and torch.isfinite(got.float()).all()
    assert torch.equal(got, again)
    atol = WKV_ATOL
    rtol = WKV_RTOL if dtype == "float32" else WKV_BF16_RTOL
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("chunk", [64, 128, 4096])
def test_cuda_wkv_is_finite_at_the_clip_floor(cuda_device, chunk):
    """g = -1.2 everywhere over 4096 steps: the reference's factorised form
    overflows fp32 from chunk 74 on; the kernel factorises within its own
    32-step tile (at most 55.4 bits of decay), so it stays finite at every
    chunk, and two launches are bitwise equal."""
    r, k, v, _, u = (torch.from_numpy(a).to(cuda_device)
                     for a in _wkv_inputs(1, 2, 4096, 64))
    g = torch.full_like(r, -1.2)
    got = ops.wkv(r, k, v, g, u, chunk=chunk)
    again = ops.wkv(r, k, v, g, u, chunk=chunk)
    want = tref.wkv_chunk_ref(r, k, v, g, u)
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=WKV_ATOL, rtol=WKV_RTOL)


def test_cuda_wkv_chunk_invariance(cuda_device):
    """The same result for chunks 16, 32 and 64, bit for bit: the kernel's
    tile does not depend on the chunk."""
    r, k, v, g, u = (torch.from_numpy(a).to(cuda_device)
                     for a in _wkv_inputs(1, 2, 192, 64, seed=7))
    outs = [ops.wkv(r, k, v, g, u, chunk=c).cpu().numpy() for c in (16, 32, 64)]
    for other in outs[1:]:
        np.testing.assert_array_equal(other, outs[0])


CUDA_BWD_CASES = [  # B, H, S, T, D, causal, dtype
    (1, 4, 256, 256, 64, True, "bfloat16"),
    (1, 2, 300, 200, 128, False, "float32"),
    (2, 2, 129, 129, 32, True, "float32"),
    # the bf16 (wgmma) kernels' tiling: 128 rows a CTA, key tiles of 64 (dQ
    # pass), query tiles of 64 (32 at D = 128; dK/dV pass): ragged ends at
    # D 32 and 128, S != T under the causal mask, S % 4 != 0 (lse and delta
    # read row by row), T within one key tile, and llama3.2-1b's training
    # shape without the mask
    (1, 2, 1000, 1000, 32, True, "bfloat16"),
    (1, 2, 1000, 1000, 128, True, "bfloat16"),
    (1, 2, 700, 300, 64, True, "bfloat16"),
    (1, 2, 129, 129, 64, True, "bfloat16"),
    (1, 2, 300, 48, 64, False, "bfloat16"),
    (1, 2, 300, 48, 64, True, "bfloat16"),
    (2, 32, 4096, 4096, 64, False, "bfloat16"),
]


@pytest.mark.parametrize("B,H,S,T,D,causal,dtype", CUDA_BWD_CASES)
def test_cuda_flash_backward_matches_plain_on_card(cuda_device, B, H, S, T, D,
                                                   causal, dtype):
    """Autograd through the flash kernel (its two backward kernels) against
    autograd through the plain version: fp32 within 1e-4; bf16 within 2**-6
    of the largest gradient (the plain version rounds dP, P and the
    gradients to bf16, the kernels P and dS); two launches bitwise."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    dt = getattr(torch, dtype)
    q, do = (torch.randn((B, H, S, D), generator=gen, device=cuda_device).to(dt)
             for _ in range(2))
    k, v = (torch.randn((B, H, T, D), generator=gen, device=cuda_device).to(dt)
            for _ in range(2))
    before = (tflash.flash_attention_bwd_dq.launches,
              tflash.flash_attention_bwd_dkdv.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(tflash.flash_attention(*leaves, causal=causal), leaves, do)
    again = torch.autograd.grad(tflash.flash_attention(*leaves, causal=causal), leaves, do)
    assert (tflash.flash_attention_bwd_dq.launches,
            tflash.flash_attention_bwd_dkdv.launches) == (before[0] + 2, before[1] + 2)
    want = tref.flash_attention_bwd_ref(q, k, v, do, causal=causal)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        if dtype == "float32":
            torch.testing.assert_close(a, w, atol=1e-4, rtol=1e-4)
        else:
            gap = float((a.float() - w.float()).abs().max())
            assert gap <= 2.0 ** -6 * float(w.float().abs().max()), gap


@pytest.mark.parametrize("S,K,with_state", [(1000, 64, True), (300, 32, False),
                                          (96, 64, False), (33, 16, True),
                                          (1, 32, True)])
def test_cuda_wkv_backward_matches_plain_on_card(cuda_device, S, K, with_state):
    """Autograd through the WKV kernel (its backward kernels) against
    autograd through the plain recurrence within (1e-4, 1e-3); dg 0 where g
    was clipped; two launches bitwise.  S 96 is three whole 32-step tiles
    of the backward, S 33 a tile and one step, S 1 one step."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)

    def draw(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda_device) * scale

    r, k, v = (draw(2, 3, S, K, scale=0.5) for _ in range(3))
    g = -torch.exp(draw(2, 3, S, K, scale=0.8) - 0.5)
    u, dy, ds = draw(3, K, scale=0.3), draw(2, 3, S, K), draw(2, 3, K, K)
    got = twkv.wkv_bwd(r, k, v, g, u, dy, ds if with_state else None)
    again = twkv.wkv_bwd(r, k, v, g, u, dy, ds if with_state else None)
    want = tref.wkv_bwd_ref(r, k, v, g, u, dy, ds if with_state else None)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, w, atol=WKV_ATOL, rtol=WKV_RTOL)
    assert not got[3][(g < -1.2) | (g > 0)].any()
    leaves = [t.clone().requires_grad_() for t in (r, k, v, g, u)]
    # one chunk of S: the kernel ignores the chunk, and `_check` refuses a
    # chunk that does not divide S (1000 and 300 are not multiples of 64)
    ag = torch.autograd.grad(twkv.wkv(*leaves, chunk=S), leaves, dy)
    ref_grads = twkv.wkv_bwd(r, k, v, g, u, dy)
    assert all(torch.equal(a, b) for a, b in zip(ag, ref_grads))


def test_cuda_wkv_backward_at_the_clip_floor(cuda_device):
    """g = -1.2 on every step (55.4 bits of decay a 32-step tile, the
    backward's exponent margin), with the state's cotangent: the backward
    kernels finite and within (1e-4, 1e-3) of the plain recurrence's."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    r, k, v, dy = (torch.randn((1, 2, 256, 64), generator=gen, device=cuda_device)
                   for _ in range(4))
    g = torch.full_like(r, -1.2)
    u = torch.randn((2, 64), generator=gen, device=cuda_device) * 0.3
    ds = torch.randn((1, 2, 64, 64), generator=gen, device=cuda_device)
    got = twkv.wkv_bwd(r, k, v, g, u, dy, ds)
    for a, w in zip(got, tref.wkv_bwd_ref(r, k, v, g, u, dy, ds)):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, w, atol=WKV_ATOL, rtol=WKV_RTOL)
