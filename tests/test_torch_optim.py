"""The port's optimizer substrate against JAX's on the CPU: AdamW (fp32
master, global-norm clip), int8 compression with error feedback, and the
cosine schedule; and the analogs of tests/test_substrate.py:22-52."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.configs import OptimConfig as JaxOptimConfig
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.optim.grad_compress import compress_decompress as jax_compress_decompress
from repro.optim.grad_compress import error_feedback_update as jax_error_feedback_update
from repro.optim.schedules import cosine_schedule as jax_cosine_schedule
from repro_torch import bridge
from repro_torch.configs import OptimConfig
from repro_torch.optim import (adamw_init, adamw_update, compress_decompress, cosine_schedule, error_feedback_update,
                               global_norm)
from repro_torch.optim.grad_compress import quantize_int8

torch.set_num_threads(2)


def _np(t):
    return t.detach().float().numpy()


def test_adamw_converges_quadratic():
    cfg = OptimConfig(lr=0.1, warmup_steps=0, total_steps=100, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0], dtype=torch.bfloat16)}
    state = adamw_init(params)
    lr = torch.tensor(0.1)
    for _ in range(200):
        grads = {"w": 2 * state.master["w"].clone()}  # d/dw ||w||^2
        params, state = adamw_update(cfg, state, grads, lr, params, global_norm(grads))
    assert float(state.master["w"].abs().sum()) < 1e-2
    assert torch.equal(params["w"], state.master["w"].to(torch.bfloat16))
    assert state.step == 200


@settings(max_examples=20, deadline=None)
@given(st.lists(st.floats(-100, 100, allow_nan=False), min_size=4, max_size=64))
def test_compress_error_bounded(vals):
    g = torch.tensor(vals, dtype=torch.float32)
    g_hat, err = compress_decompress(g)
    scale = max(float(g.abs().max()), 1e-12) / 127.0
    assert float(err.abs().max()) <= scale * 0.5 + 1e-6
    np.testing.assert_allclose(_np(g_hat + err), _np(g), atol=1e-5)


def test_error_feedback_accumulates():
    """The residual carries the quantization error to the next step."""
    g = {"w": torch.full((8,), 0.001)}
    res = {"w": torch.zeros(8)}
    total = torch.zeros(8)
    for _ in range(50):
        g_hat, res = error_feedback_update(g, res)
        total = total + g_hat["w"]
    np.testing.assert_allclose(_np(total), 0.001 * 50, rtol=0.1)
    assert torch.equal(g["w"], torch.full((8,), 0.001))  # the grads are not consumed


def _leaves(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.normal(size=(7, 5)) * scale).astype(np.float32), "b": (rng.normal(size=(11,)) * scale).astype(np.float32),
            "c.d": (rng.normal(size=(3, 2, 4)) * scale).astype(np.float32)}


def _nested(flat):
    return bridge.params_to_jax({k: torch.from_numpy(v) for k, v in flat.items()})


@pytest.mark.parametrize("grad_scale", [1e-2, 10.0])  # under and over the clip
def test_adamw_matches_jax(grad_scale):
    """Three steps from the same bf16 params and fp32 grads: master, mu, nu
    within 1e-6 of the leaf's max (every term is JAX's, in JAX's order;
    fp32 ops round alike up to the pow and sqrt implementations), the bf16
    params bf16(master), the grad norm within 1e-6 relative."""
    p0 = {k: v.astype(np.float32) for k, v in _leaves(0).items()}
    params = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p0.items()}
    jparams = jax.tree_util.tree_map(jnp.asarray, bridge.params_to_jax(params))
    cfg = OptimConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    jcfg = JaxOptimConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    state, jstate = adamw_init(params), jax_adamw_init(jparams)
    for step in range(3):
        g = _leaves(10 + step, grad_scale)
        lr, jlr = cosine_schedule(cfg, state.step), jax_cosine_schedule(jcfg, jstate.step)
        grads = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
        gnorm = global_norm(grads)
        params, state = adamw_update(cfg, state, grads, lr, params, gnorm)
        jparams, jstate, jgnorm = jax_adamw_update(jcfg, jstate, jax.tree_util.tree_map(jnp.asarray, _nested(g)), jlr)
        np.testing.assert_allclose(float(gnorm), float(jgnorm), rtol=1e-6)
    assert state.step == int(jstate.step) == 3
    for name, tree in (("mu", jstate.mu), ("nu", jstate.nu), ("master", jstate.master)):
        want = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
        for k, t in getattr(state, name).items():
            w = want[k].numpy()
            assert float(np.abs(t.numpy() - w).max()) <= 1e-6 * float(np.abs(w).max()), (name, k)
    for k, p in params.items():
        assert torch.equal(p, state.master[k].to(torch.bfloat16)), k


def test_error_feedback_matches_jax():
    """Same grads and residual: the compressed grads and the new residual
    equal JAX's (one fp32 rounding of the scale at most)."""
    g, r = _leaves(20, 3.0), _leaves(21, 0.01)
    j_hat, j_res = jax_error_feedback_update(jax.tree_util.tree_map(jnp.asarray, _nested(g)),
                                             jax.tree_util.tree_map(jnp.asarray, _nested(r)))
    res = {k: torch.from_numpy(v.copy()) for k, v in r.items()}
    g_hat, res = error_feedback_update({k: torch.from_numpy(v) for k, v in g.items()}, res)
    for tree, port in ((j_hat, g_hat), (j_res, res)):
        want = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
        for k, t in port.items():
            np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=1e-6, atol=1e-7)


def test_quantize_rounds_half_to_even_as_jax():
    """x / scale exactly k + 1/2 rounds to the even k, as jnp.round."""
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5])  # scale 1
    q, scale = quantize_int8(x, x.abs().max())
    assert float(scale) == 1.0
    jq = jnp.clip(jnp.round(jnp.asarray(x.numpy())), -127, 127).astype(jnp.int8)
    assert q.tolist() == np.asarray(jq).tolist() == [127, 0, 2, 2, 0, -2, -2, 4]


@pytest.mark.parametrize("warmup,total", [(5, 30), (0, 12), (1, 1)])
def test_cosine_schedule_matches_jax(warmup, total):
    """The rate at every step within 1e-7 x lr of JAX's (torch's and XLA's
    cos differ by an ulp, which 1 + cos(pi frac) turns into a few ulps of a
    small rate near the end: measured 3.9e-8 x lr); 0 at step 0 with a
    warmup (the first update of a run with warmup moves nothing)."""
    cfg, jcfg = OptimConfig(lr=3e-3, warmup_steps=warmup, total_steps=total), \
        JaxOptimConfig(lr=3e-3, warmup_steps=warmup, total_steps=total)
    for step in range(total + 3):
        got = cosine_schedule(cfg, step)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(jax_cosine_schedule(jcfg, jnp.int32(step))), rtol=0, atol=1e-7 * cfg.lr)
    assert (float(cosine_schedule(cfg, 0)) == 0.0) == (warmup > 0)
