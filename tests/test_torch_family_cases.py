"""Shared harness of the port-vs-JAX tests of the encoder-decoder, RWKV6
and Mamba2/Zamba2 families (tests/test_torch_{encdec,rwkv6,mamba2}.py; this
module holds no tests itself).

Weights are JAX's ``spec.init(PRNGKey(1))``, moved through the bridge; the
leaves the schema initialises to a constant (lerp coefficients, decay
offsets, bonuses, dt biases, A_log, D, gains) are replaced on both sides by
the same seeded random values, so the token shift, the bonus and the decay
are exercised. JAX runs through ``jax_exact`` (no excess precision), with
its prefill attention (``chunked_attention``, which rounds the softmax
weights to bf16) replaced by its flash-attention oracle, the function the
port's kernel ports.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.launch.steps import build_prefill_step as jax_build_prefill_step
from repro.launch.steps import build_serve_step as jax_build_serve_step
from repro.models import encdec as jax_encdec
from repro.models import mamba2 as jax_mamba2
from repro.models.api import ModelSpec as JaxSpec
from repro_torch import bridge, configs
from repro_torch.launch.steps import build_prefill_step, build_serve_step, decode_cache
from repro_torch.models.api import ModelSpec
from repro_torch.models.common import flat_leaves
from test_torch_engine_cases import jax_exact

torch.set_num_threads(2)

# Logits of the reduced models are ~0.1-1 in size; both sides round
# activations to bf16 at every layer, in orders that differ (torch's CPU
# GEMMs against XLA's dots), so they agree to bf16 noise.
LOGIT_TOL = 2e-2
# fp32 recurrent state (WKV, SSM): what bf16 noise in the inputs leaves
STATE_TOL = 1e-4
# A greedy token that differs from JAX's must lie within this much of the
# maximum of JAX's teacher-forced logits (a near tie under bf16 noise).
NEAR_TIE = 2e-2


def f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def t2np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def bf16_ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance between two bf16 arrays (numpy views) in units in
    the last place."""
    def line(x):
        i = np.asarray(x).view(np.int16).astype(np.int32)
        return np.where(i < 0, -(i & 0x7FFF), i)

    return int(np.abs(line(a) - line(b)).max()) if np.asarray(a).size else 0


@pytest.fixture(autouse=True, scope="module")
def jax_flash_prefill():
    """JAX's prefill attention in the families under test is its flash
    oracle (fp32 softmax weights), as the port's. Module scope, so that it
    is in place before the module-scoped fixtures run JAX (a test module
    imports this fixture by name)."""
    flash = lambda q, k, v, causal: jax_flash_ref(q, k, v, causal=causal)  # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_encdec, "chunked_attention", flash)
        mp.setattr(jax_mamba2, "chunked_attention", flash)
        yield


@dataclasses.dataclass
class Pair:
    spec: ModelSpec
    params: dict
    jspec: JaxSpec
    jparams: dict

    @property
    def cfg(self):
        return self.spec.cfg


def make_pair(arch: str, seed: int = 1, **replace) -> Pair:
    """The reduced config of ``arch`` (``dataclasses.replace``d by
    ``replace`` on both sides) with the same weights on both sides."""
    jcfg = dataclasses.replace(jax_get_reduced(arch), **replace)
    cfg = dataclasses.replace(configs.get_reduced(arch), **replace)
    return pair_of(jcfg, cfg, seed)


def pair_of(jcfg, cfg, seed: int = 1) -> Pair:
    """``make_pair``'s weights for a JAX config and the port's same config."""
    jspec, spec = JaxSpec(jcfg), ModelSpec(cfg)
    tree = jax.tree_util.tree_map(np.asarray, jspec.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for name, leaf in flat_leaves(spec.schema()):
        if leaf.init in ("zeros", "ones"):
            *path, key = name.split(".")
            node = tree
            for part in path:
                node = node[part]
            vals = rng.uniform(0.0, 1.0, size=leaf.shape) + (0.5 if leaf.init == "ones" else 0.0)
            node[key] = np.asarray(jnp.asarray(vals.astype(np.float32), node[key].dtype))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return Pair(spec, bridge.params_from_jax(tree), jspec, jparams)


def tokens(cfg, B: int, S: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S)).astype(np.int32)


def frames(cfg, B: int, S_enc: int, seed: int):
    """Stub frame embeddings (B, S_enc, d) bf16: (jax array, torch tensor)."""
    fe = jnp.asarray(np.random.default_rng(seed).normal(size=(B, S_enc, cfg.d_model)).astype(np.float32),
                     jnp.bfloat16)
    return fe, bridge._to_torch(np.asarray(fe))


def jax_forward(pair: Pair, toks: np.ndarray, jfe=None):
    """JAX's logits (B, S, V) of the whole sequence."""
    fn = lambda p, t, f: pair.jspec.forward(p, t, f, remat=False)[0]  # noqa: E731
    t = jnp.asarray(toks)
    return jax_exact(fn, pair.jparams, t, jfe)(pair.jparams, t, jfe)


def jax_prefill(pair: Pair, toks: np.ndarray, jfe=None):
    t = jnp.asarray(toks)
    return jax_exact(pair.jspec.prefill, pair.jparams, t, jfe)(pair.jparams, t, jfe)


def jax_into_cache(jdc: dict, cache: dict) -> dict:
    """The prefill cache in the leading slice of a decode cache (zeros
    after it), as tests/test_system.py::test_prefill_decode does: JAX's
    counterpart of the port's ``launch.steps.decode_cache``."""
    out = dict(jdc)
    for key, v in cache.items():
        if key != "length":
            out[key] = jnp.pad(v, [(0, a - b) for a, b in zip(jdc[key].shape, v.shape)])
    return out


def assert_cache_close(cache: dict, jcache: dict, bf16_atol: float, bf16_ulps_max: int = None):
    """Same keys and shapes; fp32 states within STATE_TOL; bf16 tensors
    within ``bf16_atol`` (and, if given, ``bf16_ulps_max`` ulps); lengths
    equal."""
    assert set(cache) == set(jcache)
    assert cache["length"] == int(jcache["length"])
    for key, v in cache.items():
        if key == "length":
            continue
        want = jcache[key]
        assert tuple(v.shape) == want.shape, key
        if v.dtype == torch.float32:
            np.testing.assert_allclose(t2np(v), f32(want), atol=STATE_TOL, rtol=0, err_msg=key)
        else:
            np.testing.assert_allclose(t2np(v), f32(want), atol=bf16_atol, rtol=0, err_msg=key)
            if bf16_ulps_max is not None:
                got = bridge._to_numpy(v)
                assert bf16_ulps(got, np.asarray(want)) <= bf16_ulps_max, key


def greedy_both(pair: Pair, prompt: np.ndarray, n_steps: int, max_len: int, jfe=None, fe=None):
    """``build_prefill_step`` then ``n_steps`` of ``build_serve_step`` on
    each side. Returns (port tokens (B, 1 + n), JAX tokens (B, 1 + n))."""
    B, S = prompt.shape
    out = {}
    for side in ("jax", "port"):
        if side == "jax":
            t = jnp.asarray(prompt)
            step0 = jax_exact(jax_build_prefill_step(pair.jspec), pair.jparams, t, jfe)
            tok, cache = step0(pair.jparams, t, jfe)
            dc = jax_into_cache(pair.jspec.init_cache(B, max_len), cache)
            step = jax_exact(jax_build_serve_step(pair.jspec), pair.jparams, dc, tok, jnp.int32(S))
            run = lambda dc, tok, pos: step(pair.jparams, dc, tok, jnp.int32(pos))  # noqa: E731
        else:
            tok, cache = build_prefill_step(pair.spec)(pair.params, torch.from_numpy(prompt), fe)
            dc = decode_cache(pair.spec, cache, B, max_len, device="cpu")
            serve = build_serve_step(pair.spec)
            run = lambda dc, tok, pos: serve(pair.params, dc, tok, pos)  # noqa: E731
        toks = [np.asarray(tok)]
        for i in range(n_steps):
            tok, dc = run(dc, tok, S + i)
            toks.append(np.asarray(tok))
        assert int(dc["length"]) == S + n_steps
        out[side] = np.concatenate(toks, axis=1)
    return out["port"], out["jax"]


def assert_greedy_matches(pair: Pair, prompt: np.ndarray, n_steps: int = 4, jfe=None, fe=None,
                          max_len: int = None):
    """The port's greedy tokens equal JAX's, or each lies within NEAR_TIE of
    the maximum of JAX's teacher-forced logits at its position."""
    B, S = prompt.shape
    got, want = greedy_both(pair, prompt, n_steps, max_len or S + n_steps + 3, jfe, fe)
    assert got.dtype == want.dtype == np.int32
    if np.array_equal(got, want):
        return
    # teacher forcing along the port's own tokens
    seq = np.concatenate([prompt, got[:, :-1]], axis=1)
    logits = f32(jax_forward(pair, seq, jfe))[:, S - 1:]
    for b in range(B):
        for i, t in enumerate(got[b]):
            gap = logits[b, i].max() - logits[b, i, t]
            assert gap <= NEAR_TIE, (b, i, gap)
