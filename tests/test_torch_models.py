"""Port vs JAX reference: configs (every arch), the weight bridge, and the
decoder families' (dense, moe, vlm) prefill, forward and decode logits on
the same weights (CPU, reduced configs; llava's prefill and forward take a
frontend); every family through the step builders. The encoder-decoder,
RWKV6 and Mamba2 families are held against JAX in
tests/test_torch_{encdec,rwkv6,mamba2}.py.

The port's prefill attention is the flash-attention kernel, whose plain
version keeps the softmax weights in fp32; JAX's dense prefill calls
``chunked_attention``, which rounds them to bf16 before w.v. For the dense
archs the logits still agree within the tolerances below. For moe and vlm
the JAX side's prefill attention is JAX's own flash-attention oracle
(``repro.kernels.flash_attention.ref``, the function the port's kernel
ports): with chunked_attention, reduced olmoe's prefill logits differ by up
to 0.23 (a bf16-sized change in a router's input picks other experts) and
llava's layer-1 V cache by 0.036 in 1 of 4,480 elements (35 positions with
its 16 frontend rows)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.models import dense as jax_dense
from repro.models.api import ModelSpec as JaxSpec
from repro_torch import bridge, configs
from repro_torch.models.api import ModelSpec
from test_torch_engine_cases import jax_exact

torch.set_num_threads(2)

ARCHS = ["qwen3-1.7b", "smollm-135m", "qwen2.5-32b", "mistral-large-123b", "olmoe-1b-7b",
         "llama4-scout-17b-a16e", "llava-next-34b"]


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t2np(t):
    return t.float().numpy()


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_equal(arch, reduced):
    ref = (jax_get_reduced if reduced else jax_get_config)(arch)
    port = (configs.get_reduced if reduced else configs.get_config)(arch)
    ref_fields = dataclasses.asdict(ref)
    port_fields = dataclasses.asdict(port)
    assert list(ref_fields) == list(port_fields)
    for name, value in ref_fields.items():
        assert port_fields[name] == value, name
    assert port.param_count() == ref.param_count()
    assert port.resolved_head_dim == ref.resolved_head_dim


def test_registry_is_the_jax_registry():
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS

    assert sorted(configs.ARCH_IDS) == sorted(JAX_ARCH_IDS)


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch-0b")
    with pytest.raises(KeyError):
        configs.get_reduced("no-such-arch-0b")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg = configs.get_reduced(request.param)
    jspec = JaxSpec(jax_get_reduced(request.param))
    jparams = jspec.init(jax.random.PRNGKey(3))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = bridge.params_from_jax(tree)
    with pytest.MonkeyPatch.context() as mp:
        if cfg.family != "dense":
            mp.setattr(jax_dense, "chunked_attention", lambda q, k, v, causal: jax_flash_ref(q, k, v, causal=causal))
        yield ModelSpec(cfg), params, jspec, jparams


def test_bridge_roundtrip_bit_exact(pair):
    spec, params, jspec, jparams = pair
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    back = bridge.params_to_jax(params)
    flat_ref = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat_ref) == len(params)
    for path, ref in flat_ref:
        node = back
        for key in path:
            node = node[key.key]
        assert node.dtype == ref.dtype
        np.testing.assert_array_equal(node.view(np.uint16), ref.view(np.uint16))
    # the port's schema names every bridged tensor, with the same shapes
    from repro_torch.models.common import flat_leaves

    shapes = {name: leaf.shape for name, leaf in flat_leaves(spec.schema())}
    assert shapes == {name: tuple(t.shape) for name, t in params.items()}
    assert spec.param_count() == jspec.param_count()


def _frontend(cfg, batch, seed):
    """Stub patch embeddings (B, n_frontend_tokens, d) for a vlm, else None."""
    if cfg.frontend is None:
        return None, None
    rng = np.random.default_rng(seed)
    fe = jnp.asarray(rng.normal(size=(batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32), jnp.bfloat16)
    return fe, bridge._to_torch(np.asarray(fe))


def test_init_is_seeded_and_shaped():
    spec = ModelSpec(configs.get_reduced("qwen3-1.7b"))
    a = spec.init(torch.Generator().manual_seed(5), device="cpu")
    b = spec.init(torch.Generator().manual_seed(5), device="cpu")
    for name in a:
        assert torch.equal(a[name], b[name]), name
        assert a[name].dtype == torch.bfloat16
    assert torch.all(a["blocks.attn_norm"] == 1)


def test_prefill_logits_match_jax(pair):
    """Prefill: the port's attention is the flash-attention plain version
    (fp32 softmax weights), JAX's is chunked_attention (weights rounded to
    bf16 before w.v). Both round activations to bf16 at every layer, so the
    logits agree to bf16 noise: atol 2e-2 on logits of size ~0.1-1."""
    spec, params, jspec, jparams = pair
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, spec.cfg.vocab, size=(2, 19)).astype(np.int32)
    jfe, fe = _frontend(spec.cfg, 2, 10)
    jl, jcache = jspec.prefill(jparams, jnp.asarray(tokens), jfe)
    pl, cache = spec.prefill(params, torch.from_numpy(tokens).long(), fe)
    assert cache["length"] == int(jcache["length"]) == 19
    assert tuple(cache["k"].shape) == jcache["k"].shape
    np.testing.assert_allclose(_t2np(pl), _f32(jl), atol=2e-2, rtol=0)
    # layer 0's K comes from the embeddings alone through the same recipe
    # (rmsnorm, projection, qk-norm, rope): bit-equal
    np.testing.assert_array_equal(_t2np(cache["k"][0]), _f32(jcache["k"][0]))
    np.testing.assert_allclose(_t2np(cache["v"]), _f32(jcache["v"]), atol=3e-2, rtol=3e-2)


def test_full_forward_logits_match_jax(pair):
    """Logits atol 2e-2 as prefill; the aux loss (the MoE's load-balance and
    router-z terms summed over layers, 0 for the others) within 1e-6."""
    spec, params, jspec, jparams = pair
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, spec.cfg.vocab, size=(1, 24)).astype(np.int32)
    jfe, fe = _frontend(spec.cfg, 1, 11)
    jl, jaux, _ = jspec.forward(jparams, jnp.asarray(tokens), jfe, remat=False)
    pl, aux, _ = spec.forward(params, torch.from_numpy(tokens).long(), fe)
    n_front = 0 if fe is None else spec.cfg.n_frontend_tokens
    assert pl.shape == (1, n_front + 24, spec.cfg.vocab)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    assert (float(aux) > 0) == (spec.cfg.family == "moe")
    np.testing.assert_allclose(_t2np(pl), _f32(jl), atol=2e-2, rtol=0)


def test_decode_logits_match_jax(pair):
    """Decode over a dense cache: same recipe on both sides (bf16 scores,
    fp32 softmax, weights rounded to bf16 before w.v), atol 2e-2. JAX runs
    with every bf16 rounding kept (``jax_exact``): in its scan XLA's fusions
    skip some, which picks other experts for reduced olmoe (logits off by
    up to 0.31)."""
    spec, params, jspec, jparams = pair
    rng = np.random.default_rng(2)
    S, n = 13, 4
    prompt = jnp.asarray(rng.integers(0, spec.cfg.vocab, size=(1, S)).astype(np.int32))
    jl, jc = jax_exact(jspec.prefill, jparams, prompt)(jparams, prompt)
    prompt = np.asarray(prompt)
    pl, pc = spec.prefill(params, torch.from_numpy(prompt).long())
    maxlen = S + n + 2
    jdc = jspec.init_cache(1, maxlen)
    for kk in ("k", "v"):
        jdc[kk] = jnp.pad(jc[kk], [(0, 0), (0, 0), (0, maxlen - S), (0, 0), (0, 0)])
    pdc = spec.init_cache(1, maxlen, device="cpu")
    pdc["k"][:, :, :S] = pc["k"]
    pdc["v"][:, :, :S] = pc["v"]
    feed = rng.integers(0, spec.cfg.vocab, size=n)
    jstep = jax_exact(jspec.decode_step, jparams, jdc, jnp.zeros((1, 1), jnp.int32), jnp.int32(S))
    for i, tok in enumerate(feed):
        jl, jdc = jstep(jparams, jdc, jnp.asarray([[tok]], jnp.int32), jnp.int32(S + i))
        pl, pdc = spec.decode_step(params, pdc, torch.tensor([[int(tok)]]), S + i)
        np.testing.assert_allclose(_t2np(pl), _f32(jl), atol=2e-2, rtol=0)
    assert pdc["length"] == S + n


@pytest.mark.parametrize("g", [1, 2])
def test_decode_attention_per_row_lengths_match_jax(g):
    """decode_attention with a (B,) length (each row its own valid prefix,
    as the MoE replay's batches need) against JAX's, bit for bit; a scalar
    length equals a (B,) of that value."""
    from repro.models.layers import decode_attention as jax_decode_attention
    from repro_torch.models.layers import decode_attention

    rng = np.random.default_rng(g)
    B, S, KV, hd = 4, 23, 2, 16
    q, k, v = (jnp.asarray(rng.normal(size=s).astype(np.float32), jnp.bfloat16)
               for s in ((B, 1, KV * g, hd), (B, S, KV, hd), (B, S, KV, hd)))
    lengths = np.asarray([23, 1, 9, 0], np.int32)
    want = jax_exact(jax_decode_attention, q, k, v, jnp.asarray(lengths))(q, k, v, jnp.asarray(lengths))
    tq, tk, tv = (bridge._to_torch(np.asarray(a)) for a in (q, k, v))
    got = decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))
    same = decode_attention(tq, tk, tv, torch.full((B,), 9, dtype=torch.int32))
    assert torch.equal(same, decode_attention(tq, tk, tv, 9))


def test_unknown_family_raises():
    cfg = dataclasses.replace(configs.get_reduced("qwen3-1.7b"), family="no-such-family")
    with pytest.raises(ValueError, match="unknown family"):
        ModelSpec(cfg).schema()
    with pytest.raises(ValueError, match="unknown family"):
        ModelSpec(cfg).forward({}, torch.zeros((1, 2), dtype=torch.long))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_smoke_batch_shapes(arch):
    """Tokens (B, S) int32 in the vocab; a vlm's patch embeddings and an
    encdec's frames (B, S // 4, d) bf16, as JAX's ``smoke_batch``; seeded."""
    cfg = configs.get_reduced(arch)
    spec = ModelSpec(cfg)
    batch = spec.smoke_batch(torch.Generator().manual_seed(0), batch=2, seq=32, device="cpu")
    again = spec.smoke_batch(torch.Generator().manual_seed(0), batch=2, seq=32, device="cpu")
    jbatch = JaxSpec(jax_get_reduced(arch)).smoke_batch(jax.random.PRNGKey(0), batch=2, seq=32)
    assert sorted(batch) == sorted(jbatch)
    for key, t in batch.items():
        assert tuple(t.shape) == jbatch[key].shape, key
        assert str(t.dtype).removeprefix("torch.") == str(jbatch[key].dtype), key
        assert torch.equal(t, again[key])
    assert int(batch["tokens"].min()) >= 0 and int(batch["tokens"].max()) < cfg.vocab


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_prefill_decode_every_family(arch):
    """tests/test_system.py::test_prefill_decode for the port: every arch's
    reduced config through ``build_prefill_step``, the prefill cache copied
    into ``init_cache(2, 48)`` (padded where the decode cache is larger),
    and one ``build_serve_step``: finite logits of the right shapes, the
    cache's keys and shapes JAX's, ``length`` 33."""
    from repro_torch.launch.steps import build_prefill_step, build_serve_step, decode_cache

    cfg = configs.get_reduced(arch)
    spec = ModelSpec(cfg)
    gen = torch.Generator().manual_seed(1)
    params = spec.init(gen, device="cpu")
    batch = spec.smoke_batch(gen, batch=2, seq=32, device="cpu")
    logits, cache = spec.prefill(params, batch["tokens"], batch.get("frontend"))
    assert logits.shape == (2, cfg.vocab) and torch.isfinite(logits.float()).all()
    tok, cache2 = build_prefill_step(spec)(params, batch["tokens"], batch.get("frontend"))
    assert tok.dtype == torch.int32 and torch.equal(tok[:, 0], torch.argmax(logits, -1).to(torch.int32))
    dc = spec.init_cache(2, 48, device="cpu")
    jdc = JaxSpec(jax_get_reduced(arch)).init_cache(2, 48)
    assert sorted(dc) == sorted(jdc)
    assert {k: tuple(v.shape) for k, v in dc.items() if k != "length"} == \
        {k: v.shape for k, v in jdc.items() if k != "length"}
    dc = decode_cache(spec, cache2, 2, 48, device="cpu")
    logits2 = spec.decode_step(params, {**dc}, tok, 32)[0]
    assert logits2.shape == (2, cfg.vocab) and torch.isfinite(logits2.float()).all()
    tok2, dc = build_serve_step(spec)(params, dc, tok, 32)
    assert tok2.shape == (2, 1) and dc["length"] == 33
