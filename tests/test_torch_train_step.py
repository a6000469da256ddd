"""The port's train step (``launch/steps.py::build_train_step``) against
JAX's on the CPU: one step of reduced qwen3-1.7b with ``accum_steps=2``,
without and with int8 error feedback, from the same state (moved across
with ``bridge.train_state_from_jax``); the schedule's lr-0 first step;
``make_train_state``; the microbatch accumulation. Harness in
tests/test_torch_train_cases.py.

Tolerances, stated with their reason (measured on this case):
- loss: LOSS_RTOL; grad_norm 1e-3 relative (measured 1.6e-4: bf16
  gradients summed in other orders);
- mu and nu within 2e-2 and 4e-2 of the leaf's max (the clipped gradient
  and its square; measured 8.5e-3 and 1.6e-2);
- master: AdamW's first step moves each weight by lr x (g / |g| + wd x
  master), so where the two sides' mu agree in sign (and |mu| > 1e-6)
  the masters agree to 1e-5 (measured 2e-6); elsewhere (a gradient near 0
  whose sign is noise) they differ by at most 2 lr;
- residual: the compression error moves by at most one quantization step
  where the two sides' sums round to neighbouring int8 levels;
- params are bf16(master), bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import OptimConfig as JaxOptimConfig
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro_torch import bridge
from repro_torch.configs import OptimConfig, get_reduced
from repro_torch.launch.steps import build_train_step, make_train_state
from repro_torch.models.api import ModelSpec
from test_torch_train_cases import LOSS_RTOL, batches, jax_exact, jax_flash_attention, train_pair  # noqa: F401

LR = 1e-3


def _step_both(compress: bool, warmup: int = 0):
    """One step on each side from the same state. Returns (port state,
    metrics, JAX state in the port's form, JAX metrics, the port's fp32
    gradient of the step, the state's residual before it)."""
    pair = train_pair("qwen3-1.7b")
    rng = np.random.default_rng(9)
    jstate = {"params": pair.jparams, "opt": jax_adamw_init(pair.jparams)}
    if compress:  # a residual carried from earlier steps
        jstate["residual"] = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32) * 1e-3), pair.jparams)
    state = bridge.train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate))
    jb, tb = batches(pair.cfg, 4, 32, seed=11)
    kw = dict(lr=LR, warmup_steps=warmup, total_steps=10, compress_grads=compress)
    jnew, jm = jax_exact(jax_build_train_step(pair.jspec, JaxOptimConfig(**kw), accum_steps=2), jstate, jb)(jstate, jb)
    step = build_train_step(pair.spec, OptimConfig(**kw), accum_steps=2)
    grads, _ = step.grads_and_loss(state["params"], tb)  # what the step computes (deterministic)
    residual0 = {n: t.clone() for n, t in state.get("residual", {}).items()}
    new, m = step(state, tb)
    return new, m, bridge.train_state_from_jax(jax.tree_util.tree_map(np.asarray, jnew)), jm, grads, residual0


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("compress", [False, True])
def test_train_step_matches_jax(compress):
    new, m, want, jm, grads, residual0 = _step_both(compress)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    assert float(m["lr"]) == float(jm["lr"]) and m["step"] == int(jm["step"]) == 1
    opt, jopt = new["opt"], want["opt"]
    assert opt.step == jopt.step == 1
    for n, p in new["params"].items():
        assert torch.equal(p, opt.master[n].to(torch.bfloat16)), n
        assert p.requires_grad and p.grad is None
        assert _rel(opt.mu[n], jopt.mu[n]) <= 2e-2, ("mu", n)
        assert _rel(opt.nu[n], jopt.nu[n]) <= 4e-2, ("nu", n)
        moved = (opt.master[n] - jopt.master[n]).abs()
        agree = (torch.sign(opt.mu[n]) == torch.sign(jopt.mu[n])) & (jopt.mu[n].abs() > 1e-6)
        assert float(moved.max()) <= 2 * LR * 1.001, n
        if agree.any():
            assert float(moved[agree].max()) <= 1e-5, n
    if compress:
        for n, r in new["residual"].items():
            x = grads[n] + residual0[n]  # what was compressed
            quant_step = max(float(x.abs().max()), 1e-12) / 127.0
            assert float((r - want["residual"][n]).abs().max()) <= 1.05 * quant_step, n
            assert float(r.abs().max()) <= 0.5 * quant_step * 1.0001, n


def test_first_step_with_warmup_has_rate_zero():
    """JAX takes the rate at the step before the increment, so with
    ``warmup_steps > 0`` the first update has lr 0: master and params stay
    as they were, while mu, nu and the step advance (copied, not fixed)."""
    new, m, want, jm, _, _ = _step_both(False, warmup=3)
    assert float(m["lr"]) == float(jm["lr"]) == 0.0
    start = train_pair("qwen3-1.7b").params  # the bf16 weights both sides started from
    for n, p in new["params"].items():
        assert torch.equal(new["opt"].master[n], start[n].float()), n
        assert torch.equal(want["opt"].master[n], start[n].float()), n
        assert torch.equal(p.detach(), start[n]), n
    assert any(t.any() for t in new["opt"].mu.values()) and new["opt"].step == 1


def test_make_train_state():
    spec = ModelSpec(get_reduced("olmoe-1b-7b"))
    state = make_train_state(spec, torch.Generator().manual_seed(0), compress=True, device="cpu")
    assert set(state) == {"params", "opt", "residual"} and state["opt"].step == 0
    for n, p in state["params"].items():
        assert p.dtype == torch.bfloat16 and p.requires_grad
        assert torch.equal(state["opt"].master[n], p.detach().float())
        for t in (state["opt"].mu[n], state["opt"].nu[n], state["residual"][n]):
            assert t.dtype == torch.float32 and not t.any()
    assert "residual" not in make_train_state(spec, torch.Generator().manual_seed(0), device="cpu")


def test_microbatches_sum_in_fp32():
    """``accum_steps=2`` gives (g(first half) + g(second half)) / 2 of the
    bf16 per-microbatch gradients, summed in fp32, and the mean loss."""
    spec = ModelSpec(get_reduced("smollm-135m"))
    params = {n: t.requires_grad_(True) for n, t in spec.init(torch.Generator().manual_seed(0), device="cpu").items()}
    batch = spec.smoke_batch(torch.Generator().manual_seed(1), batch=4, seq=16, device="cpu")
    grads, loss = build_train_step(spec, OptimConfig(), accum_steps=2).grads_and_loss(params, batch)
    halves = []
    for rows in (slice(0, 2), slice(2, 4)):
        h_loss, _ = spec.loss(params, {"tokens": batch["tokens"][rows]})
        h_loss.backward()
        halves.append((h_loss.detach(), {n: p.grad for n, p in params.items()}))
        for p in params.values():
            p.grad = None
    assert torch.equal(loss, (halves[0][0] + halves[1][0]) / 2)
    for n, g in grads.items():
        assert g.dtype == torch.float32
        assert torch.equal(g, (halves[0][1][n].float() + halves[1][1][n].float()) / 2), n
    with pytest.raises(ValueError):
        build_train_step(spec, OptimConfig(), accum_steps=3).grads_and_loss(params, batch)
