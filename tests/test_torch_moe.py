"""The port's MoE layer (models/layers.py::moe_ffn) against the JAX
reference on the same weights and inputs (CPU, reduced olmoe-1b-7b: top-2 of
8 experts; reduced llama4-scout: top-1 of 4 with a shared expert).

JAX runs compiled without excess precision (``jax_exact``: the bits of
running it op by op). Tolerances:

- routing: expert ids and the kept/dropped mask exactly equal; each case
  drops at least one (token, choice), so capacity is exercised;
- output: bit-exact at the decode shape; elsewhere within one bf16 ulp of
  the row's largest |value|. The cause: an expert's output sums its d_ff
  products in fp32 in the order of torch's blocked CPU GEMM, XLA's dot in
  sequence; where the sum cancels, its bf16 rounding can differ by an ulp
  or two of a value far smaller than the row's largest;
- aux loss (load balance + router z, fp32): 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import layers as jax_layers
from repro.models.api import ModelSpec as JaxSpec
from repro_torch import bridge, configs
from repro_torch.models import layers
from test_torch_engine_cases import jax_exact

torch.set_num_threads(2)

ARCHS = ["olmoe-1b-7b", "llama4-scout-17b-a16e"]
# (B, S): a decode step of 4 rows whose last two are padding (token 0's
# embedding, as the engine pads), and prefill shapes
SHAPES = [(4, 1), (1, 20), (1, 35), (2, 13)]


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


@pytest.fixture(scope="module", params=ARCHS)
def expert_layer(request):
    jcfg = jax_get_reduced(request.param)
    jparams = JaxSpec(jcfg).init(jax.random.PRNGKey(4))
    jl = {k: v[1] for k, v in jparams["blocks"].items()}  # layer 1
    tl = {k: bridge._to_torch(np.asarray(v)) for k, v in jl.items()}
    return jcfg, configs.get_reduced(request.param), jl, tl, jparams["embed"]


def _inputs(shape, d, embed):
    """Rows that share a component, so the router favours some experts and
    their buffers overflow."""
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    x = rng.normal(size=(*shape, d)) + rng.normal(size=d)
    x = jnp.asarray(x.astype(np.float32), jnp.bfloat16)
    if shape == (4, 1):
        x = x.at[2:].set(embed[0])  # padded rows
    return x


def _jax_routing(m, xt, w_router, cap):
    """Expert ids and the kept mask, by the lines of the JAX moe_ffn."""
    T = xt.shape[0]
    logits = jnp.einsum("td,de->te", xt, w_router).astype(jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
    flat = jax.nn.one_hot(idx, m.num_experts, dtype=jnp.int32).reshape(T * m.top_k, -1)
    pos = (jnp.cumsum(flat, axis=0) * flat - 1).max(axis=-1).reshape(T, m.top_k)
    return idx, (pos < cap) & (pos >= 0)


@pytest.mark.parametrize("shape", SHAPES)
def test_moe_ffn_matches_jax(expert_layer, shape):
    jcfg, cfg, jl, tl, embed = expert_layer
    m = cfg.moe
    x = _inputs(shape, cfg.d_model, embed)
    xt = bridge._to_torch(np.asarray(x))
    T = shape[0] * shape[1]
    cap = max(1, int(T * m.top_k * m.capacity_factor / m.num_experts))
    jshared = (jl["ws_gate"], jl["ws_up"], jl["ws_down"]) if m.shared_expert else None
    shared = (tl["ws_gate"], tl["ws_up"], tl["ws_down"]) if m.shared_expert else None

    def ref(x):
        idx, keep = _jax_routing(m, x.reshape(T, -1), jl["router"], cap)
        out, aux = jax_layers.moe_ffn(jcfg, x, jl["router"], jl["we_gate"], jl["we_up"], jl["we_down"], jshared)
        return out, aux, idx, keep

    jout, jaux, jidx, jkeep = jax_exact(ref, x)(x)
    out, aux = layers.moe_ffn(cfg, xt, tl["router"], tl["we_gate"], tl["we_up"], tl["we_down"], shared)
    _, _, _, idx = layers.moe_route(m, xt.reshape(T, -1), tl["router"])
    _, keep = layers.moe_slots(idx, m.num_experts, cap)

    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert not keep.all(), "no (token, choice) was dropped: capacity not exercised"
    assert out.shape == shape + (cfg.d_model,) and out.dtype == torch.bfloat16
    if shape == (4, 1):
        np.testing.assert_array_equal(_bits(out), _bits(jout))
    else:
        want = np.asarray(jout, np.float32).reshape(T, -1)
        row_max = np.abs(want).max(axis=-1, keepdims=True)
        ulp = 2.0 ** (np.floor(np.log2(row_max)) - 7)  # bf16: 8 significant bits
        err = np.abs(out.float().numpy().reshape(T, -1) - want)
        assert (err <= ulp).all(), float((err / ulp).max())
    assert abs(float(aux) - float(jaux)) <= 1e-6


def test_moe_route_breaks_ties_to_the_lower_expert():
    """Equal probabilities: the lower expert id comes first, as lax.top_k."""
    cfg = configs.get_reduced("olmoe-1b-7b")
    w = torch.zeros((cfg.d_model, cfg.moe.num_experts), dtype=torch.bfloat16)
    w[:, 5] = w[:, 3] = 1.0
    x = torch.ones((2, cfg.d_model), dtype=torch.bfloat16)
    _, _, gates, idx = layers.moe_route(cfg.moe, x, w)
    assert idx.tolist() == [[3, 5], [3, 5]]
    assert torch.equal(gates, torch.full((2, 2), 0.5))
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x.float().numpy() @ w.float().numpy()), axis=-1), 2)
    assert np.asarray(jidx).tolist() == idx.tolist()


def test_forced_experts_reproduce_the_router(expert_layer):
    """``experts=`` the router's own top k gives the same bits; another
    routing does not."""
    _, cfg, _, tl, embed = expert_layer
    m = cfg.moe
    x = bridge._to_torch(np.asarray(_inputs((1, 20), cfg.d_model, embed)))
    shared = (tl["ws_gate"], tl["ws_up"], tl["ws_down"]) if m.shared_expert else None
    args = (cfg, x, tl["router"], tl["we_gate"], tl["we_up"], tl["we_down"], shared)
    out, aux = layers.moe_ffn(*args)
    _, _, _, idx = layers.moe_route(m, x.reshape(20, -1), tl["router"])
    forced, forced_aux = layers.moe_ffn(*args, experts=idx)
    assert torch.equal(out, forced) and torch.equal(aux, forced_aux)
    assert layers.moe_ffn(*args, aux=False)[1] == 0.0
    assert not torch.equal(out, layers.moe_ffn(*args, experts=(idx + 1) % m.num_experts)[0])
