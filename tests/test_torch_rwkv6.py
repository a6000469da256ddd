"""Port vs JAX: the RWKV6 family (``repro_torch/models/rwkv6.py`` against
``repro/models/rwkv6.py``), reduced rwkv6-3b on the CPU.

The chunked WKV scan on fp32 inputs agrees with JAX's to 1e-5 plus 1e-4
relative (fp32 summation order; an S that is not a multiple of the chunk
included) and with the port's own one-token
recurrence to 1e-4; the mixes, forward, prefill, decode and greedy steps on
the same weights as in tests/test_torch_family_cases.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv6 as jax_rwkv6
from repro_torch import bridge
from repro_torch.launch.steps import decode_cache
from repro_torch.models import rwkv6
from repro_torch.models.common import layer_stack
from test_torch_engine_cases import jax_exact
from test_torch_family_cases import (LOGIT_TOL, assert_cache_close, assert_greedy_matches, f32,  # noqa: F401
                                     jax_flash_prefill, jax_into_cache, jax_prefill, jax_forward,
                                     make_pair, t2np, tokens)

ARCH = "rwkv6-3b"


@pytest.fixture(scope="module")
def pair():
    return make_pair(ARCH)


def _wkv_inputs(B, S, H, K, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, K)).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.normal(size=(B, S, H, K)) - 1.0).astype(np.float32)  # decays ~0.5-1
    u = rng.normal(size=(H, K)).astype(np.float32)
    state0 = rng.normal(size=(B, H, K, K)).astype(np.float32)
    return r, k, v, logw, u, state0


@pytest.mark.parametrize("S,chunk", [(1, 16), (16, 16), (45, 16), (100, 32), (7, 64)])
def test_wkv_chunked_matches_jax(S, chunk):
    """fp32 inputs of unit scale, a random initial state: y and the state
    within 1e-5 + 1e-4 relative. The relative part is fp32 summation order:
    a chunk's outputs are sums of up to chunk x K products plus the carried
    state's share (outputs up to ~20), which the two frameworks add in
    other orders (2.7e-5 apart at S=100, chunk 32, on values near 1.3)."""
    args = _wkv_inputs(2, S, 3, 8, S)
    want_y, want_s = jax_rwkv6.wkv_chunked(*map(jnp.asarray, args), chunk=chunk)
    got_y, got_s = rwkv6.wkv_chunked(*map(torch.from_numpy, args), chunk=chunk)
    assert got_y.shape == (2, S, 3, 8) and got_s.shape == (2, 3, 8, 8)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("S,chunk", [(16, 16), (45, 16), (64, 64)])
def test_wkv_chunked_equals_recurrence(S, chunk):
    """The chunked scan against chunks of one token (the recurrence decode
    runs), within 1e-4."""
    r, k, v, logw, u, state0 = map(torch.from_numpy, _wkv_inputs(2, S, 3, 8, 100 + S))
    y, st = rwkv6.wkv_chunked(r, k, v, logw, u, state0, chunk=chunk)
    y1, st1 = rwkv6.wkv_chunked(r, k, v, logw, u, state0, chunk=1)
    torch.testing.assert_close(y, y1, atol=1e-4, rtol=0)
    torch.testing.assert_close(st, st1, atol=1e-4, rtol=0)
    # one token at a time, carrying the state by hand
    state, ys = state0, []
    for t in range(S):
        yt, state = rwkv6.wkv_chunked(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1], logw[:, t:t + 1], u, state)
        ys.append(yt)
    torch.testing.assert_close(torch.cat(ys, 1), y, atol=1e-4, rtol=0)
    torch.testing.assert_close(state, st, atol=1e-4, rtol=0)


def _layer0(pair):
    jp = jax.tree_util.tree_map(lambda t: t[0], pair.jparams["blocks"])
    return jp, layer_stack(pair.params)[0]


def _bf16(rng, shape):
    x = jnp.asarray(rng.normal(size=shape).astype(np.float32), jnp.bfloat16)
    return x, bridge._to_torch(np.asarray(x))


@pytest.mark.parametrize("S", [1, 45])
def test_time_mix_matches_jax(pair, S):
    """Layer 0's time mix on bf16 inputs with a previous token and a random
    state: the output within one bf16 step of its size (2e-2), the last
    token exact, the fp32 state within 1e-4."""
    jp, p = _layer0(pair)
    s = pair.cfg.ssm
    rng = np.random.default_rng(S)
    jx, x = _bf16(rng, (2, S, pair.cfg.d_model))
    jprev, prev = _bf16(rng, (2, 1, pair.cfg.d_model))
    st0 = rng.normal(size=(2, s.heads, s.head_dim, s.head_dim)).astype(np.float32)
    fn = lambda p_, x_, pr, s0: jax_rwkv6.time_mix(pair.jspec.cfg, p_, x_, pr, s0, s.chunk)  # noqa: E731
    jst = jnp.asarray(st0)
    want = jax_exact(fn, jp, jx, jprev, jst)(jp, jx, jprev, jst)
    got = rwkv6.time_mix(pair.cfg, p, x, prev, torch.from_numpy(st0), s.chunk)
    np.testing.assert_allclose(t2np(got[0]), f32(want[0]), atol=2e-2, rtol=0)
    np.testing.assert_array_equal(t2np(got[1]), f32(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-4, rtol=0)


def test_channel_mix_matches_jax(pair):
    jp, p = _layer0(pair)
    rng = np.random.default_rng(7)
    jx, x = _bf16(rng, (2, 13, pair.cfg.d_model))
    jprev, prev = _bf16(rng, (2, 1, pair.cfg.d_model))
    fn = lambda p_, x_, pr: jax_rwkv6.channel_mix(pair.jspec.cfg, p_, x_, pr)  # noqa: E731
    want = jax_exact(fn, jp, jx, jprev)(jp, jx, jprev)
    got = rwkv6.channel_mix(pair.cfg, p, x, prev)
    np.testing.assert_allclose(t2np(got[0]), f32(want[0]), atol=2e-2, rtol=0)
    np.testing.assert_array_equal(t2np(got[1]), f32(want[1]))


def test_forward_logits_match_jax(pair):
    toks = tokens(pair.cfg, 2, 45, 1)
    want = jax_forward(pair, toks)
    logits, aux, collected = pair.spec.forward(pair.params, torch.from_numpy(toks))
    assert logits.shape == (2, 45, pair.cfg.vocab) and aux == 0.0 and collected is None
    np.testing.assert_allclose(t2np(logits), f32(want), atol=LOGIT_TOL, rtol=0)


@pytest.fixture(scope="module")
def prefilled(pair):
    toks = tokens(pair.cfg, 2, 45, 2)
    return toks, jax_prefill(pair, toks), pair.spec.prefill(pair.params, torch.from_numpy(toks))


def test_prefill_matches_jax(pair, prefilled):
    """Last logits within 2e-2; the assembled cache: the fp32 WKV state
    within 1e-4, the last tokens of each mix within one bf16 ulp."""
    _, (jl, jc), (pl, pc) = prefilled
    np.testing.assert_allclose(t2np(pl), f32(jl), atol=LOGIT_TOL, rtol=0)
    assert sorted(pc) == ["cm_prev", "length", "tm_prev", "wkv"]
    assert_cache_close(pc, jc, bf16_atol=3e-2, bf16_ulps_max=1)


def test_decode_steps_match_jax(pair, prefilled):
    """Three decode steps after the prefill: logits within 2e-2, the cache
    as after prefill, ``length`` exact."""
    toks, (_, jc), (_, pc) = prefilled
    B, S = toks.shape
    jdc = jax_into_cache(pair.jspec.init_cache(B, S + 5), jc)
    dc = decode_cache(pair.spec, pc, B, S + 5, device="cpu")
    feed = np.random.default_rng(3).integers(0, pair.cfg.vocab, size=(3, B, 1)).astype(np.int32)
    jstep = jax_exact(pair.jspec.decode_step, pair.jparams, jdc, jnp.asarray(feed[0]), jnp.int32(S))
    for i, tok in enumerate(feed):
        jl, jdc = jstep(pair.jparams, jdc, jnp.asarray(tok), jnp.int32(S + i))
        pl, dc = pair.spec.decode_step(pair.params, dc, torch.from_numpy(tok), S + i)
        np.testing.assert_allclose(t2np(pl), f32(jl), atol=LOGIT_TOL, rtol=0)
    assert dc["length"] == S + 3
    assert_cache_close(dc, jdc, bf16_atol=3e-2, bf16_ulps_max=1)


def test_greedy_steps_match_jax(pair):
    """``build_prefill_step`` and 4 ``build_serve_step``s: the tokens equal
    JAX's or are near ties of its teacher-forced logits."""
    assert_greedy_matches(pair, tokens(pair.cfg, 2, 37, 4), n_steps=4)
