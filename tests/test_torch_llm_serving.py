"""The port's LLM serving path (`repro_torch.models`, `launch/serve.py`,
`launch/batching.py`, `launch/serve_llm.py`) against the JAX package on the
CPU, at the smoke configs of llama3.2-1b, rwkv6-3b, llama3.2-3b,
qwen1.5-32b (qkv bias, as many KV heads as query heads), chatglm3-6b (half
RoPE), qwen2-vl-72b (M-RoPE over (3, B, S) triplets; the embeddings input
mode beside the token path) and kimi-k2-1t-a32b (a dense head layer, then
an MoE layer; at capacity factor 8.0, as the reference's decode test runs
it, so that the prefill routes no pair past an expert's capacity).

The same seeded numpy inputs go through each JAX function and its port:
`chunked_attention` over `tests/test_attention_ssm.py`'s cases (window and
softcap included), `decode_attention`, `_chunked_linear_attention` in both
modes with an initial and a final state at chunks 1, 4 and 16, and
`linear_attention_step`, `apply_rope` in its three styles.  The whole
model runs from the reference's weights
carried over by `params_from_numpy`: `forward`, `prefill` (logits and every
cache entry), 12 `serve_step`s (each from JAX's cache of the step before),
`serve_step_vec`, `greedy_decode` and the continuous-batching engine.  At ``dtype="float32"`` each is held within
1e-4 (a cache entry stored in bf16 within one bf16 step of JAX's, since
fp32 values a last bit apart may round to neighbouring bf16 values); at the
configs' bf16 within the reference tests' 0.1 and 0.12; greedy tokens equal.
Also: the configs and the registry, the port's own seeded draw, the entry
points' device default, no kernel launch on the CPU, and the CUDA
refusals (window, softcap, q_offset, init_state, seq_sharded_cache), which
raise before any kernel is reached (shown on meta tensors here).

Card-only cases skip here inside a fixture: `wkv_with_state` against its
plain version, and y bitwise the same with and without the state pointer.

    PYTHONPATH=src python -m pytest -q tests/test_torch_llm_serving.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.launch import serve_llm as tserve_llm
from repro_torch.launch.batching import ContinuousBatchingEngine, Request
from repro_torch.models import kvcache as tkv
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as TT

CPU = torch.device("cpu")
TOL = 1e-4  # fp32 port against fp32 JAX
BF16_STEP = 2.0 ** -7  # one bf16 step (7 stored mantissa bits), relative
ARCHS = ["llama3.2-1b", "rwkv6-3b", "llama3.2-3b", "qwen1.5-32b", "chatglm3-6b",
         "qwen2-vl-72b", "kimi-k2-1t-a32b"]
# an MoE config's capacity factor here (tests/test_decode_consistency.py's)
MOE_CAPACITY = 8.0
B, S = 2, 12  # test_decode_consistency.py's batch and prompt


def _jax():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S_,qc,kc", [(128, 32, 64), (256, 256, 256), (64, 16, 16)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (48, 0.0), (0, 5.0),
                                            (48, 5.0)])
def test_chunked_attention_matches_jax(S_, qc, kc, window, softcap):
    jax, jnp = _jax()
    from repro.models.layers import chunked_attention

    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, S_, 3, 32)).astype(np.float32)
               for _ in range(3))
    want = chunked_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                             window=window, softcap=softcap, q_chunk=qc,
                             kv_chunk=kc)
    got = tlayers.chunked_attention(_t(q), _t(k), _t(v), causal=True,
                                    window=window, softcap=softcap,
                                    q_chunk=qc, kv_chunk=kc)
    assert got.shape == (2, S_, 3, 32)
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_rope_and_repeat_kv_match_jax(dtype):
    jax, jnp = _jax()
    from repro.models.layers import apply_rope, repeat_kv, rmsnorm

    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 12, 4, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    pos = np.stack([np.arange(12), np.arange(100, 112)]).astype(np.int32)
    jd, td = getattr(jnp, dtype), {"float32": torch.float32,
                                   "bfloat16": torch.bfloat16}[dtype]
    jx, tx = jnp.asarray(x, jd), _t(x).to(td)
    tol = TOL if dtype == "float32" else BF16_STEP
    pairs = [(tlayers.rmsnorm({"scale": _t(scale)}, tx, 1e-5),
              rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-5)),
             (tlayers.apply_rope(tx, torch.from_numpy(pos), 5e5),
              apply_rope(jx, jnp.asarray(pos), 5e5)),
             (tlayers.repeat_kv(tx, 3), repeat_kv(jx, 3))]
    for got, want in pairs:
        assert got.dtype == td and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("style,dh", [("half", 32), ("half", 128), ("mrope", 32),
                                      ("mrope", 128)])
def test_rope_half_and_mrope_match_jax(style, dh, dtype):
    """chatglm's half RoPE (the first half of the head dims rotated, the
    rest kept) and qwen2-vl's M-RoPE ((t, h, w) sections, (16, 24, 24) at
    dh 128, over [3,B,S] triplets whose rows differ) against the
    reference's `apply_rope`; M-RoPE refuses [B,S] positions."""
    jax, jnp = _jax()
    from repro.models.layers import apply_rope

    rng = np.random.default_rng(dh)
    x = rng.standard_normal((2, 12, 3, dh)).astype(np.float32)
    pos = np.stack([np.arange(12), np.arange(100, 112)]).astype(np.int32)
    if style == "mrope":
        pos = np.stack([pos, pos // 4, rng.integers(0, 50, pos.shape)]).astype(np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = TOL if dtype == "float32" else BF16_STEP
    want = apply_rope(jnp.asarray(x, jd), jnp.asarray(pos), 1e6, style)
    got = tlayers.apply_rope(_t(x).to(td), torch.from_numpy(pos), 1e6, style)
    assert got.dtype == td and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    if style == "half":  # the second half passes through untouched
        assert torch.equal(got[..., dh // 2:], _t(x).to(td)[..., dh // 2:])
    else:
        assert tlayers.mrope_sections(128) == (16, 24, 24)
        with pytest.raises(ValueError, match="triplets"):
            tlayers.apply_rope(_t(x), torch.from_numpy(pos[0]), 1e6, style)


@pytest.mark.parametrize("lens,window,softcap", [(48, 0, 0.0), ([48, 30], 0, 0.0),
                                                 ([40, 17], 8, 0.0), (40, 8, 0.0),
                                                 (48, 0, 5.0)])
def test_decode_attention_matches_jax(lens, window, softcap):
    jax, jnp = _jax()
    from repro.models.layers import decode_attention

    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 48, 4, 16)).astype(np.float32)
            for _ in range(2))
    cl = np.asarray(lens, np.int32)
    want = decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(cl), window=window, softcap=softcap)
    got = tlayers.decode_attention(_t(q), _t(k), _t(v),
                                   torch.from_numpy(cl.astype(np.int64)),
                                   window=window, softcap=softcap)
    _close(got, want)
    if cl.ndim == 0:  # serve_step passes a Python int
        _close(tlayers.decode_attention(_t(q), _t(k), _t(v), int(cl),
                                        window=window, softcap=softcap), want)


def _linear_inputs(mode, S_=50, seed=9):
    rng = np.random.default_rng(seed)
    Bb, H, K = 2, 2, 8
    q, k, v = (rng.standard_normal((Bb, S_, H, K)).astype(np.float32) * 0.5
               for _ in range(3))
    g = (-np.abs(rng.standard_normal((Bb, S_, H, K))) * 0.5).astype(np.float32)
    if mode == "mamba":
        g = g[..., :1]
    bonus = ((rng.standard_normal((H, K)) * 0.1).astype(np.float32)
             if mode == "rwkv" else None)
    state0 = rng.standard_normal((Bb, H, K, K)).astype(np.float32) * 0.3
    return q, k, v, g, bonus, state0


@pytest.mark.parametrize("mode", ["rwkv", "mamba"])
@pytest.mark.parametrize("chunk", [1, 4, 16])
def test_chunked_linear_attention_matches_jax(mode, chunk):
    """S = 50 is a multiple of none of the chunks but 1: the padded tail."""
    jax, jnp = _jax()
    from repro.models.ssm import _chunked_linear_attention

    q, k, v, g, bonus, state0 = _linear_inputs(mode)
    jb = None if bonus is None else jnp.asarray(bonus)
    want_y, want_s = _chunked_linear_attention(
        *(jnp.asarray(a) for a in (q, k, v, g)), chunk=chunk, mode=mode,
        bonus=jb, init_state=jnp.asarray(state0), return_state=True)
    got_y, got_s = tssm._chunked_linear_attention(
        _t(q), _t(k), _t(v), _t(g), chunk=chunk, mode=mode,
        bonus=None if bonus is None else _t(bonus), init_state=_t(state0),
        return_state=True)
    _close(got_y, want_y)
    _close(got_s, want_s)
    alone = tssm._chunked_linear_attention(
        _t(q), _t(k), _t(v), _t(g), chunk=chunk, mode=mode,
        bonus=None if bonus is None else _t(bonus))
    want_alone = _chunked_linear_attention(
        *(jnp.asarray(a) for a in (q, k, v, g)), chunk=chunk, mode=mode, bonus=jb)
    _close(alone, want_alone)


@pytest.mark.parametrize("mode", ["rwkv", "mamba"])
def test_linear_attention_step_matches_jax(mode):
    jax, jnp = _jax()
    from repro.models.ssm import linear_attention_step

    q, k, v, g, bonus, state0 = _linear_inputs(mode, S_=3)
    jb = None if bonus is None else jnp.asarray(bonus)
    want_y, want_s = linear_attention_step(
        *(jnp.asarray(a[:, 1]) for a in (q, k, v, g)), jnp.asarray(state0),
        mode=mode, bonus=jb)
    got_y, got_s = tssm.linear_attention_step(
        *(_t(a[:, 1]) for a in (q, k, v, g)), _t(state0), mode=mode,
        bonus=None if bonus is None else _t(bonus))
    _close(got_y, want_y)
    _close(got_s, want_s)


# ---------------------------------------------------------------------------
# The model, from the reference's weights
# ---------------------------------------------------------------------------


def _configs(arch, dtype):
    from repro.configs import get_smoke_config

    jcfg = get_smoke_config(arch)
    cfg = tbase.get_smoke_config(arch)
    if cfg.num_experts:
        jcfg = dataclasses.replace(jcfg, capacity_factor=MOE_CAPACITY)
        cfg = dataclasses.replace(cfg, capacity_factor=MOE_CAPACITY)
    if dtype != "bfloat16":
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return jcfg, cfg


@pytest.fixture(scope="module")
def models():
    """Per (arch, dtype): the JAX config and params, and the port's config
    and `params_from_numpy` model over the same weights."""
    jax, _ = _jax()
    from repro.models import transformer as JT

    cache = {}

    def get(arch, dtype="float32"):
        if (arch, dtype) not in cache:
            jcfg, cfg = _configs(arch, dtype)
            jparams = JT.init_params(jcfg, jax.random.PRNGKey(1))
            tree = jax.tree.map(np.asarray, jparams)
            cache[arch, dtype] = (jcfg, jparams, cfg,
                                  TT.params_from_numpy(cfg, tree, CPU))
        return cache[arch, dtype]

    return get


def _prompt(cfg, seed=2, batch=B, length=S):
    """Tokens and their positions ((3, B, S) text triplets under mrope, as
    test_decode_consistency.py builds them)."""
    tokens = np.random.default_rng(seed).integers(1, cfg.vocab_size,
                                                  (batch, length)).astype(np.int32)
    positions = np.broadcast_to(np.arange(length)[None], (batch, length)).copy()
    if cfg.rope_style == "mrope":
        positions = np.broadcast_to(positions[None], (3, batch, length)).copy()
    return tokens, positions


def _batches(jnp, tokens, positions):
    return ({"tokens": jnp.asarray(tokens), "positions": jnp.asarray(positions)},
            {"tokens": torch.from_numpy(tokens),
             "positions": torch.from_numpy(positions.astype(np.int64))})


def _cache_close(got, want):
    assert set(got) == set(want)
    for name, t in got.items():
        w = np.asarray(want[name], np.float32)
        assert tuple(t.shape) == w.shape, name
        assert t.dtype == {"float32": torch.float32,
                           "bfloat16": torch.bfloat16}[str(want[name].dtype)], name
        rtol = TOL if t.dtype == torch.float32 else BF16_STEP
        np.testing.assert_allclose(t.float().numpy(), w, atol=TOL, rtol=rtol,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_jax(models, arch):
    jax, jnp = _jax()
    from repro.models import transformer as JT

    jcfg, jparams, cfg, params = models(arch)
    jb, tb = _batches(jnp, *_prompt(cfg))
    h_want, _, _ = JT.forward(jcfg, jparams, jb)
    h_got, aux, (stacks, enc) = TT.forward(cfg, params, tb)
    assert h_got.dtype == torch.float32 and stacks is None and enc is None
    _close(h_got, h_want)
    before = (ops.flash_attention.launches, ops.wkv.launches)
    want_logits, want_cache = JT.prefill(jcfg, jparams, jb)
    got_logits, got_cache = TT.prefill(cfg, params, tb)
    assert (ops.flash_attention.launches, ops.wkv.launches) == before
    assert got_logits.shape == (B, cfg.vocab_size)
    _close(got_logits, want_logits)
    _cache_close(got_cache, want_cache)


def test_embeddings_input_matches_jax(models):
    """qwen2-vl's input mode: stub patch embeddings [B,S,D] (bf16, as the
    pipeline draws them) in place of tokens, M-RoPE triplets whose three
    rows differ: `forward` and `prefill` (logits and cache) against the
    reference's, and the tokens ignored when embeddings are given."""
    jax, jnp = _jax()
    from repro.models import transformer as JT

    jcfg, jparams, cfg, params = models("qwen2-vl-72b")
    assert cfg.input_mode == "embeddings" and cfg.rope_style == "mrope"
    rng = np.random.default_rng(8)
    emb = (rng.standard_normal((B, S, cfg.d_model), np.float32) * 0.02)
    pos = np.arange(S)[None].repeat(B, 0)
    pos = np.stack([pos, pos // 3, pos % 5]).astype(np.int32)
    jb = {"embeds": jnp.asarray(emb, jnp.bfloat16), "positions": jnp.asarray(pos)}
    tb = {"embeds": _t(emb).bfloat16(), "positions": torch.from_numpy(pos)}
    h_want, _, _ = JT.forward(jcfg, jparams, jb)
    h_got, _, _ = TT.forward(cfg, params, tb)
    _close(h_got, h_want)
    want_logits, want_cache = JT.prefill(jcfg, jparams, jb)
    got_logits, got_cache = TT.prefill(cfg, params, tb)
    _close(got_logits, want_logits)
    _cache_close(got_cache, want_cache)
    again, _ = TT.prefill(cfg, params, dict(tb, tokens=torch.zeros((B, S), dtype=torch.int32)))
    assert torch.equal(again, got_logits)


def _from_jax(cache):
    """A JAX cache as torch tensors of the same dtypes (bf16 through fp32,
    exactly), copied: the port updates its cache in place, and JAX may
    still be reading its buffers (asynchronous dispatch)."""
    return {name: _t(a).to({"bfloat16": torch.bfloat16,
                            "float32": torch.float32}[str(a.dtype)])
            for name, a in cache.items()}


# At a step where an entry the step wrote to a bf16 cache is a bf16 step
# from the reference's (the step's fresh k or v a last fp32 bit apart,
# rounded the other way), the logits may move by a share of that entry's
# gap: qwen1.5-32b's smoke config moved 2.3e-4 for a v entry 3.9e-3 apart
# (0.06 of it), llama3.2-1b 4.8e-6 for a k entry 4.9e-4 apart (0.01).
# Such a step is held to TOL plus FLIP_GAIN times the largest entry gap,
# four times the larger share; every other step to TOL.
FLIP_GAIN = 0.25


def _flip_gap(cache, jcache):
    """The largest gap between the port's bf16 cache entries and the
    reference's (0 where they are equal)."""
    return max((float((t.float() - _t(jcache[n])).abs().max())
                for n, t in cache.items() if t.dtype == torch.bfloat16),
               default=0.0)


@pytest.mark.parametrize("arch,cache_dtype,flip_gain",
                         [pytest.param(a, "bfloat16", 0.0, id=a) for a in ARCHS[:2]]
                         + [pytest.param(a, "bfloat16", FLIP_GAIN, id=a)
                            for a in ARCHS[2:]]
                         + [pytest.param(a, "float32", 0.0, id=f"{a}-float32")
                            for a in ARCHS])
def test_serve_steps_match_jax(models, arch, cache_dtype, flip_gain):
    """12 decode steps from an empty cache, each port step from JAX's cache
    of the step before (the caches store bf16, where fp32 values a last bit
    apart may round one bf16 step apart and move the next step's logits
    past 1e-4): each step's logits and the cache it writes.  A step's own
    fresh k and v are rounded into the cache too, so at bf16 one of them a
    last fp32 bit apart can flip a bf16 step within the step (qwen1.5-32b's
    smoke config, 8 KV heads: 2.3e-4 on its logits): the four dense archs
    added with the half and M-RoPE styles hold such a step to TOL plus
    FLIP_GAIN of the flip.  Every arch also runs with both caches held in
    fp32, which leaves only the order of the sums (3.5e-6 there) and holds
    each step to 1e-4."""
    jax, jnp = _jax()
    from repro.models import transformer as JT
    from repro.models.kvcache import init_cache

    jcfg, jparams, cfg, params = models(arch)
    tokens, _ = _prompt(cfg)
    jcache = init_cache(jcfg, B, S + 4)
    if cache_dtype == "float32":
        jcache = {n: a.astype(jnp.float32) for n, a in jcache.items()}
    cache = tkv.init_cache(cfg, B, S + 4, device=CPU)
    assert set(cache) == set(jcache)
    assert tkv.cache_bytes(cfg, B, S + 4) == sum(
        t.numel() * t.element_size() for t in cache.values())
    assert all(str(a.dtype) == cache_dtype or n == "s"
               for n, a in jcache.items())
    step = jax.jit(lambda p, c, t, i: JT.serve_step(jcfg, p, c, t, i))
    before = (ops.flash_attention.launches, ops.wkv.launches)
    for i in range(S):
        cache = _from_jax(jcache)
        want, jcache = step(jparams, jcache, jnp.asarray(tokens[:, i:i + 1]),
                            jnp.int32(i))
        got, cache = TT.serve_step(cfg, params, cache,
                                   torch.from_numpy(tokens[:, i:i + 1]), i)
        _close(got, want, TOL + flip_gain * _flip_gap(cache, jcache))
        _cache_close(cache, jcache)
    assert (ops.flash_attention.launches, ops.wkv.launches) == before


def test_serve_step_vec_matches_jax(models):
    """Lanes at different depths: lane 0 at position 5 over a prefix the
    per-lane cache holds, lane 1 at position 2."""
    _serve_step_vec_case(models, "llama3.2-1b")


def test_moe_serve_step_vec_matches_jax(models):
    """The same lanes through kimi-k2's dense head layer and MoE layer."""
    _serve_step_vec_case(models, "kimi-k2-1t-a32b")


def _serve_step_vec_case(models, arch):
    jax, jnp = _jax()
    from repro.models import transformer as JT

    jcfg, jparams, cfg, params = models(arch)
    rng = np.random.default_rng(5)
    shape = (cfg.num_layers, B, 16, cfg.num_kv_heads, cfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    jcache = {"k": jnp.asarray(k, jnp.bfloat16), "v": jnp.asarray(v, jnp.bfloat16)}
    cache = {"k": _t(k).bfloat16(), "v": _t(v).bfloat16()}
    tokens = rng.integers(1, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.asarray([5, 2], np.int32)
    want, jcache = JT.serve_step_vec(jcfg, jparams, jcache, jnp.asarray(tokens),
                                     jnp.asarray(pos))
    got, cache = TT.serve_step_vec(cfg, params, cache, torch.from_numpy(tokens),
                                   torch.from_numpy(pos))
    _close(got, want)
    _cache_close(cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_match_jax(models, arch):
    """The configs' own bf16 activations: the reference tests' tolerances
    (bf16 sums run in other orders in the two frameworks)."""
    jax, jnp = _jax()
    from repro.models import transformer as JT
    from repro.models.kvcache import init_cache

    jcfg, jparams, cfg, params = models(arch, "bfloat16")
    tokens, positions = _prompt(cfg, seed=3, length=8)
    jb, tb = _batches(jnp, tokens, positions)
    want, _ = JT.prefill(jcfg, jparams, jb)
    got, _ = TT.prefill(cfg, params, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.1, rtol=0.1)
    jcache, cache = init_cache(jcfg, B, 8), tkv.init_cache(cfg, B, 8, device=CPU)
    for i in range(8):
        want, jcache = JT.serve_step(jcfg, jparams, jcache,
                                     jnp.asarray(tokens[:, i:i + 1]), jnp.int32(i))
        got, cache = TT.serve_step(cfg, params, cache,
                                   torch.from_numpy(tokens[:, i:i + 1]), i)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.12, rtol=0.12)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cache_dtype", [None, torch.float32])
def test_prefill_matches_decode_and_continues(models, arch, cache_dtype):
    """test_prefill.py's contract on the port alone: the prefill's logits
    equal token-by-token decode's last, and decoding on from the prefill's
    cache (padded) equals decoding on from the step-built cache.  With the
    cache as the reference stores it (bf16 k, v and token-shift rows, which
    decode reads and the prefill does not) within that test's 0.1; with
    the step-built cache's entries held in fp32, which leaves only the order
    of the sums, the logits within 1e-4 (the prefill's own cache is stored
    in bf16, so decoding on from it stays within 0.1)."""
    cfg, params = models(arch)[2:]
    tokens, positions = _prompt(cfg, seed=4, length=8)
    tb = {"tokens": torch.from_numpy(tokens),
          "positions": torch.from_numpy(positions.astype(np.int64))}
    logits_pf, cache_pf = TT.prefill(cfg, params, tb)
    cache = tkv.init_cache(cfg, B, 12, device=CPU)
    if cache_dtype is not None:
        cache = {n: t.to(cache_dtype) for n, t in cache.items()}
        cache_pf = {n: t.to(cache_dtype) for n, t in cache_pf.items()}
    for i in range(8):
        logits, cache = TT.serve_step(cfg, params, cache,
                                      torch.from_numpy(tokens[:, i:i + 1]), i)
    _close(logits_pf, logits.numpy(), 0.1 if cache_dtype is None else TOL)
    if not cfg.ssm_kind:  # pad the prefill's T = 8 out to 12
        cache_pf = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 4))
                    for k, v in cache_pf.items()}
    nxt = torch.from_numpy(tokens[:, -1:])
    a, _ = TT.serve_step(cfg, params, cache_pf, nxt, 8)
    b, _ = TT.serve_step(cfg, params, cache, nxt, 8)
    _close(a, b.numpy(), 0.1)


# ---------------------------------------------------------------------------
# Greedy decode and continuous batching
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_tokens_equal_jax(models, arch):
    jax, jnp = _jax()
    from repro.launch.serve import greedy_decode

    jcfg, jparams, cfg, params = models(arch)
    tokens, _ = _prompt(cfg, seed=6, length=6)
    want = np.asarray(greedy_decode(jcfg, jparams, jnp.asarray(tokens), 6))
    got = tserve.greedy_decode(cfg, params, torch.from_numpy(tokens), 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _solo(cfg, params, prompt, n):
    return tserve.greedy_decode(cfg, params, torch.from_numpy(prompt)[None], n,
                                max_len=32)[0].tolist()


def test_interleaved_requests_match_solo(models):
    """test_batching.py's first property on the port."""
    cfg, params = models("llama3.2-1b")[2:]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 9, 4)]
    refs = [_solo(cfg, params, p, 5) for p in prompts]
    eng = ContinuousBatchingEngine(cfg, params, slots=2, max_len=32)
    eng.submit(Request(uid=0, prompt=prompts[0], max_new=5))
    outs = {i: [] for i in range(3)}
    for t in range(80):
        if t == 2:
            eng.submit(Request(uid=1, prompt=prompts[1], max_new=5))
        if t == 5:
            eng.submit(Request(uid=2, prompt=prompts[2], max_new=5))
        for uid, tok in eng.tick():
            outs[uid].append(tok)
        if t > 5 and not eng.queue and all(a is None for a in eng.active):
            break
    for i in range(3):
        assert outs[i] == refs[i], (i, outs[i], refs[i])
    assert eng.stats.requests_completed == 3
    assert eng.stats.mean_occupancy > 0.5


def test_slot_reuse_does_not_leak_state(models):
    """test_batching.py's second property on the port."""
    cfg, params = models("llama3.2-1b")[2:]
    rng = np.random.default_rng(1)
    pa = rng.integers(1, cfg.vocab_size, 5).astype(np.int32)
    pb = rng.integers(1, cfg.vocab_size, 5).astype(np.int32)
    eng = ContinuousBatchingEngine(cfg, params, slots=1, max_len=32)
    eng.submit(Request(uid=0, prompt=pa, max_new=4))
    eng.submit(Request(uid=1, prompt=pb, max_new=4))
    outs = {0: [], 1: []}
    for _ in range(40):
        for uid, tok in eng.tick():
            outs[uid].append(tok)
        if not eng.queue and all(a is None for a in eng.active):
            break
    assert outs[0] == _solo(cfg, params, pa, 4)
    assert outs[1] == _solo(cfg, params, pb, 4)


def test_batching_engine_tokens_equal_jax(models):
    """The same staggered requests through both engines."""
    _batching_case(models, "llama3.2-1b")


def test_moe_batching_engine_tokens_equal_jax(models):
    """The same staggered requests through both engines, kimi-k2."""
    _batching_case(models, "kimi-k2-1t-a32b")


def _batching_case(models, arch):
    _jax()
    from repro.launch.batching import ContinuousBatchingEngine as JEngine
    from repro.launch.batching import Request as JRequest

    jcfg, jparams, cfg, params = models(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 3, 7, 4)]
    outs = []
    for engine, request, c, p in ((JEngine, JRequest, jcfg, jparams),
                                  (ContinuousBatchingEngine, Request, cfg, params)):
        eng = engine(c, p, slots=2, max_len=24)
        for uid, prompt in enumerate(prompts):
            eng.submit(request(uid=uid, prompt=prompt, max_new=4))
        got = {i: [] for i in range(len(prompts))}
        for _ in range(60):
            for uid, tok in eng.tick():
                got[uid].append(tok)
            if not eng.queue and all(a is None for a in eng.active):
                break
        outs.append((got, dataclasses.astuple(eng.stats)))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# Configs, the seeded draw, the entry points, the refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_equals_the_reference(arch):
    _jax()
    from repro.configs import get_config, get_shape, get_smoke_config

    for got, want in ((tbase.get_config(arch), get_config(arch)),
                      (tbase.get_smoke_config(arch), get_smoke_config(arch))):
        fields = [f.name for f in dataclasses.fields(got)]
        for field in fields + ["q_dim", "kv_dim"]:
            assert getattr(got, field) == getattr(want, field), field
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        assert dataclasses.astuple(tbase.get_shape(name)) == dataclasses.astuple(
            get_shape(name))


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "zamba2-1.2b",
                                  "seamless-m4t-large-v2", "gcn-paper",
                                  "no-such-arch"])
def test_registry_refuses_what_the_port_lacks(arch):
    with pytest.raises(KeyError, match="ROADMAP.md queue 1"):
        tbase.get_config(arch)
    with pytest.raises(KeyError, match="ROADMAP.md queue 1"):
        tbase.get_smoke_config(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_seeded_draw(arch):
    """The port's own weights: the reference's keys and shapes, each init's
    distribution, the same seed the same bits, another seed other bits."""
    jax, _ = _jax()
    from repro.configs import get_smoke_config
    from repro.models import transformer as JT

    cfg = tbase.get_smoke_config(arch)
    abstract = JT.abstract_params(get_smoke_config(arch))
    want = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    a = TT.init_params(cfg, 3, CPU)
    again, other = TT.init_params(cfg, 3, CPU), TT.init_params(cfg, 4, CPU)
    # blocks.<dict>.<key> is the stacked [L, ...] leaf, trainable
    got = {"/".join(name.split(".")): t for name, t in a.named_parameters()}
    assert set(got) == set(want)
    for key, stacked in got.items():
        assert tuple(stacked.shape) == tuple(want[key]), key
        assert stacked.dtype == torch.float32 and stacked.requires_grad
    for (name, t), (_, t2), (_, t3) in zip(a.named_parameters(),
                                           again.named_parameters(),
                                           other.named_parameters()):
        assert torch.equal(t, t2), name
        leaf = name.split(".")[-1]
        if leaf in ("scale", "ln_x"):
            assert torch.equal(t, torch.ones_like(t)), name
        elif leaf in ("wd2", "w0", "u", "mu", "bq", "bk", "bv"):
            assert not t.any(), name
        else:
            assert not torch.equal(t, t3), name
            # a layer's shape: the stacked leaves lead with L
            shape = (t.shape[1:] if name.startswith(("blocks.", "head_blocks."))
                     else t.shape)
            fan_in = {"wo": shape[0] * shape[1] if len(shape) == 3 else shape[0]
                      }.get(leaf, shape[0])
            if ".moe.w" in name:  # an expert stack [E, D, F] / [E, F, D]
                fan_in = shape[1]
            std = 0.02 if name == "embed" else fan_in ** -0.5
            assert abs(float(t.std()) / std - 1.0) < 0.1, (name, float(t.std()), std)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without CUDA the model and the CLIs refuse to start unless the caller
    asks for the CPU: no silent CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tbase.get_smoke_config("llama3.2-1b")
    for call in (lambda: TT.init_params(cfg),
                 lambda: TT.params_from_numpy(cfg, {}),
                 lambda: tserve.main([]),
                 lambda: tserve_llm.main(["--arch", "rwkv6-3b"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert tserve.parse_args([]).device == tserve_llm.parse_args([]).device == "cuda"


def test_cuda_refusals_raise():
    """What the kernels do not compute raises on a non-CPU tensor before
    any kernel is reached (meta tensors stand in for the card's here), and
    seq_sharded_cache raises on any device."""
    meta = torch.device("meta")
    q = torch.empty((1, 8, 2, 32), device=meta)
    for kw in (dict(window=4), dict(softcap=5.0), dict(q_offset=2)):
        with pytest.raises(NotImplementedError, match="flash kernel"):
            tlayers.chunked_attention(q, q, q, **kw)
    with pytest.raises(NotImplementedError, match="value width"):
        tlayers.chunked_attention(q, q, torch.empty((1, 8, 2, 64), device=meta))
    with pytest.raises(NotImplementedError, match="head dim"):
        e = torch.empty((1, 8, 2, 48), device=meta)
        tlayers.chunked_attention(e, e, e)
    x = torch.empty((1, 8, 2, 16), device=meta)
    with pytest.raises(NotImplementedError, match="initial state"):
        tssm._chunked_linear_attention(x, x, x, x, chunk=4, mode="rwkv",
                                       init_state=torch.empty((1, 2, 16, 16),
                                                              device=meta))
    with pytest.raises(NotImplementedError, match="mamba"):
        tssm._chunked_linear_attention(x, x, x, x[..., :1], chunk=4, mode="mamba")
    cfg = tbase.get_smoke_config("llama3.2-1b")
    params = TT.init_params(cfg, 0, CPU)
    cache = tkv.init_cache(cfg, 1, 4, device=CPU)
    with pytest.raises(NotImplementedError, match="seq_sharded_cache"):
        TT.serve_step(cfg, params, cache, torch.ones((1, 1), dtype=torch.int32), 0,
                      TT.ServeOptions(seq_sharded_cache=True))
    rwkv = tbase.get_smoke_config("rwkv6-3b")
    with pytest.raises(NotImplementedError, match="dense GQA"):
        TT.serve_step_vec(rwkv, TT.init_params(rwkv, 0, CPU), {},
                          torch.ones((1, 1), dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int64))
    with pytest.raises(NotImplementedError, match="not ported"):
        tkv.cache_spec(dataclasses.replace(cfg, use_mla=True), 1, 4)


def test_serve_mains_on_cpu():
    before = (ops.flash_attention.launches, ops.wkv.launches)
    toks = tserve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "4",
                        "--max-new", "3", "--arch", "rwkv6-3b"])
    assert toks.shape == (2, 3) and toks.dtype == torch.int32
    out = tserve_llm.main(["--device", "cpu", "--batch", "2", "--prompt-len", "6",
                           "--max-new", "4"])
    assert out["tokens"].shape == (2, 4) and out["tokens_per_s"] > 0
    stats = out["batching"]
    assert stats.requests_completed == 4 and stats.tokens_generated == 32
    assert (ops.flash_attention.launches, ops.wkv.launches) == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("B_,H,S_,K,chunk", [(1, 2, 64, 16, 16), (2, 3, 128, 32, 32),
                                            (1, 2, 1000, 64, 1000),
                                            (4, 40, 256, 64, 64)])
def test_cuda_wkv_with_state_matches_plain(cuda_device, B_, H, S_, K, chunk):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    r, k, v = (torch.randn((B_, H, S_, K), generator=gen, device=cuda_device) * 0.5
               for _ in range(3))
    g = -torch.exp(torch.randn((B_, H, S_, K), generator=gen,
                               device=cuda_device) * 0.5 - 1.0)
    u = torch.randn((H, K), generator=gen, device=cuda_device) * 0.1
    before = ops.wkv.launches
    y, state = ops.wkv_with_state(r, k, v, g, u, chunk=chunk)
    y_alone = ops.wkv(r, k, v, g, u, chunk=chunk)
    want_y, want_s = tref.wkv_chunk_ref(r, k, v, torch.clamp(g, -1.2, 0.0), u,
                                        return_state=True)
    torch.cuda.synchronize()
    assert ops.wkv.launches == before + 2
    assert torch.equal(y, y_alone)  # the state pointer leaves y bitwise
    assert state.shape == (B_, H, K, K) and state.dtype == torch.float32
    for got, want in ((y, want_y), (state, want_s)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-4, rtol=1e-3)
