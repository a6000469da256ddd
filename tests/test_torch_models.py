"""Port vs JAX reference: configs, the weight bridge, and the dense model's
prefill and decode logits on the same weights (CPU, reduced configs)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.models.api import ModelSpec as JaxSpec
from repro_torch import bridge, configs
from repro_torch.models.api import ModelSpec

torch.set_num_threads(2)

ARCHS = ["qwen3-1.7b", "smollm-135m"]


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t2np(t):
    return t.float().numpy()


@pytest.mark.parametrize("arch", ARCHS)
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


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        configs.get_config("olmoe-1b-7b")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg = configs.get_reduced(request.param)
    jspec = JaxSpec(jax_get_reduced(request.param))
    jparams = jspec.init(jax.random.PRNGKey(3))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = bridge.params_from_jax(tree)
    return ModelSpec(cfg), params, jspec, jparams


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
    jl, jcache = jspec.prefill(jparams, jnp.asarray(tokens))
    pl, cache = spec.prefill(params, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(_t2np(pl), _f32(jl), atol=2e-2, rtol=0)
    # layer 0's K comes from the embeddings alone through the same recipe
    # (rmsnorm, projection, qk-norm, rope): bit-equal
    np.testing.assert_array_equal(_t2np(cache["k"][0]), _f32(jcache["k"][0]))
    np.testing.assert_allclose(_t2np(cache["v"]), _f32(jcache["v"]), atol=3e-2, rtol=3e-2)


def test_full_forward_logits_match_jax(pair):
    spec, params, jspec, jparams = pair
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, spec.cfg.vocab, size=(1, 24)).astype(np.int32)
    jl, _, _ = jspec.forward(jparams, jnp.asarray(tokens), remat=False)
    pl, aux, _ = spec.forward(params, torch.from_numpy(tokens).long())
    assert pl.shape == (1, 24, spec.cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(_t2np(pl), _f32(jl), atol=2e-2, rtol=0)


def test_decode_logits_match_jax(pair):
    """Decode over a dense cache: same recipe on both sides (bf16 scores,
    fp32 softmax, weights rounded to bf16 before w.v), atol 2e-2."""
    spec, params, jspec, jparams = pair
    rng = np.random.default_rng(2)
    S, n = 13, 4
    prompt = rng.integers(0, spec.cfg.vocab, size=(1, S)).astype(np.int32)
    jl, jc = jspec.prefill(jparams, jnp.asarray(prompt))
    pl, pc = spec.prefill(params, torch.from_numpy(prompt).long())
    maxlen = S + n + 2
    jdc = jspec.init_cache(1, maxlen)
    for kk in ("k", "v"):
        jdc[kk] = jnp.pad(jc[kk], [(0, 0), (0, 0), (0, maxlen - S), (0, 0), (0, 0)])
    pdc = spec.init_cache(1, maxlen, device="cpu")
    pdc["k"][:, :, :S] = pc["k"]
    pdc["v"][:, :, :S] = pc["v"]
    feed = rng.integers(0, spec.cfg.vocab, size=n)
    for i, tok in enumerate(feed):
        jl, jdc = jspec.decode_step(jparams, jdc, jnp.asarray([[tok]], jnp.int32), jnp.int32(S + i))
        pl, pdc = spec.decode_step(params, pdc, torch.tensor([[int(tok)]]), S + i)
        np.testing.assert_allclose(_t2np(pl), _f32(jl), atol=2e-2, rtol=0)
    assert pdc["length"] == S + n


def test_other_families_raise():
    moe = dataclasses.replace(configs.get_reduced("qwen3-1.7b"), family="moe")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ModelSpec(moe).schema()
    with pytest.raises(NotImplementedError):
        ModelSpec(dataclasses.replace(moe, family="ssm")).schema()
