"""Port vs JAX: the encoder-decoder family (``repro_torch/models/encdec.py``
against ``repro/models/encdec.py``), reduced whisper-base on the CPU.

The cross cache: JAX sizes it ``max(max_len // 4, 1)`` encoder rows and its
decode attends every row, so when the prefill's frames are fewer, the zero
rows a caller pads with take softmax weight. The port does the same; the
decode test runs with and without that padding (ROADMAP.md §3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.models import encdec as jax_encdec
from repro.models import layers as jax_layers
from repro_torch import bridge
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.launch.steps import decode_cache
from repro_torch.models import encdec, layers
from repro_torch.models.common import layer_stack
from test_torch_engine_cases import jax_exact
from test_torch_family_cases import (LOGIT_TOL, assert_cache_close, assert_greedy_matches, bf16_ulps, f32,  # noqa: F401
                                     frames, jax_flash_prefill, jax_forward, jax_into_cache, jax_prefill,
                                     make_pair, t2np, tokens)

ARCH = "whisper-base"


@pytest.fixture(scope="module")
def pair():
    return make_pair(ARCH)


@pytest.mark.parametrize("S,d,offset", [(45, 64, 0), (413, 512, 0), (1, 512, 412)])
def test_sinusoid_matches_jax(S, d, offset):
    """fp32 within 2e-6 per radian of angle (sin and cos of angles up to
    ~400 in two libraries), and the bf16 the models add within one ulp."""
    want = jax_exact(lambda: jax_encdec.sinusoid(S, d, offset))()
    got = encdec.sinusoid(S, d, offset)
    assert got.shape == (S, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6 * (offset + S), rtol=0)
    assert bf16_ulps(bridge._to_numpy(got.to(torch.bfloat16)), np.asarray(want.astype(jnp.bfloat16))) <= 1


def test_sinusoid_at_is_the_sinusoid_row():
    """Decode's one-position sinusoid equals JAX's and the prefill's row."""
    want = jax_exact(lambda p: jax_encdec.sinusoid_at(p, 64), jnp.int32(0))(jnp.int32(37))
    got = encdec.sinusoid_at(37, 64)
    assert got.shape == (1, 1, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert torch.equal(got[0, 0], encdec.sinusoid(40, 64)[37])


def test_gelu_mlp_is_the_tanh_approximation():
    """``jax.nn.gelu`` is the tanh form by default: the port's GELU MLP
    equals JAX's within one bf16 ulp, where the erf form would differ by
    ~1e-3 before rounding."""
    rng = np.random.default_rng(0)
    x, w_in, w_out = (jnp.asarray(rng.normal(size=s).astype(np.float32) * sc, jnp.bfloat16)
                      for s, sc in (((2, 9, 32), 1.0), ((32, 64), 0.2), ((64, 32), 0.1)))
    want = jax_exact(lambda a, b, c: jax_layers.gelu_mlp(a, b, None, c, None), x, w_in, w_out)(x, w_in, w_out)
    got = layers.gelu_mlp(*(bridge._to_torch(np.asarray(a)) for a in (x, w_in, w_out)))
    assert bf16_ulps(bridge._to_numpy(got), np.asarray(want)) <= 1
    h = torch.linspace(-3, 3, 101)
    erf_gap = (torch.nn.functional.gelu(h) - torch.nn.functional.gelu(h, approximate="tanh")).abs().max()
    assert 1e-4 < float(erf_gap) < 1e-2


@pytest.mark.parametrize("S,S_kv", [(35, 9), (21, 21)])
def test_flash_reference_non_causal_cross_shapes(S, S_kv):
    """The plain version of the flash kernel, non-causal with S != S_kv (the
    cross-attention's shapes) and S == S_kv (the encoder's), against JAX's
    flash oracle: fp32 inputs within 1e-5."""
    rng = np.random.default_rng(S)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in ((2, S, 4, 16), (2, S_kv, 4, 16), (2, S_kv, 4, 16)))
    want = jax_flash_ref(*map(jnp.asarray, (q, k, v)), causal=False)
    got = flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_encode_matches_jax(pair):
    """The encoder on 11 frames: within 2e-2 (bf16 outputs of size ~1-4)."""
    jfe, fe = frames(pair.cfg, 2, 11, 0)
    want = jax_exact(lambda p, f: jax_encdec.encode(pair.jspec.cfg, p, f, remat=False), pair.jparams, jfe)(
        pair.jparams, jfe)
    got = encdec.encode(pair.cfg, pair.params, fe)
    assert got.shape == (2, 11, pair.cfg.d_model)
    np.testing.assert_allclose(t2np(got), f32(want), atol=2e-2, rtol=0)


def test_cross_kv_is_a_plain_matmul(pair):
    """Cross K/V: the encoder output times cross_wk / cross_wv, reshaped to
    heads, no bias and no RoPE."""
    p = layer_stack(pair.params, "dec")[1]
    enc_out = torch.randn(2, 7, pair.cfg.d_model, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    ck, cv = encdec._cross_kv(pair.cfg, p, enc_out)
    assert ck.shape == (2, 7, pair.cfg.n_kv_heads, pair.cfg.resolved_head_dim)
    assert torch.equal(ck.reshape(2, 7, -1), enc_out @ p["cross_wk"])
    assert torch.equal(cv.reshape(2, 7, -1), enc_out @ p["cross_wv"])


def test_forward_logits_match_jax(pair):
    toks = tokens(pair.cfg, 2, 45, 1)
    jfe, fe = frames(pair.cfg, 2, 11, 1)
    want = jax_forward(pair, toks, jfe)
    logits, aux, collected = pair.spec.forward(pair.params, torch.from_numpy(toks), fe)
    assert logits.shape == (2, 45, pair.cfg.vocab) and aux == 0.0 and collected is None
    np.testing.assert_allclose(t2np(logits), f32(want), atol=LOGIT_TOL, rtol=0)


@pytest.fixture(scope="module")
def prefilled(pair):
    toks = tokens(pair.cfg, 2, 44, 2)  # 3 decode steps fill max_len 47 = 4 x 11 + 3
    jfe, fe = frames(pair.cfg, 2, 11, 2)
    return toks, jfe, fe, jax_prefill(pair, toks, jfe), pair.spec.prefill(pair.params, torch.from_numpy(toks), fe)


def test_prefill_matches_jax(pair, prefilled):
    """Last logits within 2e-2; the self and cross K/V within 3e-2 and two
    bf16 ulps (the V of a later layer can round the other way after an
    earlier layer's GEMM did: measured 2 ulps), ``length`` the token count."""
    _, _, _, (jl, jc), (pl, pc) = prefilled
    np.testing.assert_allclose(t2np(pl), f32(jl), atol=LOGIT_TOL, rtol=0)
    assert sorted(pc) == ["ck", "cv", "k", "length", "v"]
    assert pc["ck"].shape[2] == 11
    assert_cache_close(pc, jc, bf16_atol=3e-2, bf16_ulps_max=2)


@pytest.mark.parametrize("padded", [False, True])
def test_decode_steps_match_jax(pair, prefilled, padded):
    """Three decode steps after the prefill, on a decode cache whose cross
    rows are exactly the 11 frames (max_len 47) or padded with zero rows
    (max_len 60: 15 rows, 4 of them zeros that take softmax weight, in JAX
    and in the port): logits within 2e-2, the cache as after prefill."""
    toks, _, _, (_, jc), (_, pc) = prefilled
    B, S = toks.shape
    max_len = 60 if padded else 47
    jdc = jax_into_cache(pair.jspec.init_cache(B, max_len), jc)
    dc = decode_cache(pair.spec, pc, B, max_len, device="cpu")
    assert dc["ck"].shape[2] == (15 if padded else 11) == jdc["ck"].shape[2]
    feed = np.random.default_rng(3).integers(0, pair.cfg.vocab, size=(3, B, 1)).astype(np.int32)
    jstep = jax_exact(pair.jspec.decode_step, pair.jparams, jdc, jnp.asarray(feed[0]), jnp.int32(S))
    for i, tok in enumerate(feed):
        jl, jdc = jstep(pair.jparams, jdc, jnp.asarray(tok), jnp.int32(S + i))
        pl, dc = pair.spec.decode_step(pair.params, dc, torch.from_numpy(tok), S + i)
        np.testing.assert_allclose(t2np(pl), f32(jl), atol=LOGIT_TOL, rtol=0)
    assert dc["length"] == S + 3
    assert_cache_close(dc, jdc, bf16_atol=3e-2, bf16_ulps_max=2)


def test_padded_cross_rows_change_decode(pair, prefilled):
    """The padding is not neutral: the same step against padded cross rows
    gives other logits than against the frames alone (both sides)."""
    toks, _, _, (_, jc), (_, pc) = prefilled
    B, S = toks.shape
    tok = np.full((B, 1), 5, np.int32)
    outs = {}
    for max_len in (47, 60):
        dc = decode_cache(pair.spec, pc, B, max_len, device="cpu")
        outs[max_len] = pair.spec.decode_step(pair.params, dc, torch.from_numpy(tok), S)[0]
    assert float((outs[47] - outs[60]).abs().max()) > 1e-2


def test_greedy_steps_match_jax(pair):
    """``build_prefill_step`` and 4 ``build_serve_step``s (the cross cache
    sized to the frames, so the teacher-forced forward is the reference):
    the tokens equal JAX's or are near ties."""
    toks = tokens(pair.cfg, 2, 37, 4)
    max_len = 37 + 4 + 3
    jfe, fe = frames(pair.cfg, 2, max_len // 4, 4)
    assert_greedy_matches(pair, toks, n_steps=4, jfe=jfe, fe=fe, max_len=max_len)
