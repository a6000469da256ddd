"""Shared harness of the port-vs-JAX training tests
(tests/test_torch_{loss,train_step}*.py; this module holds no tests itself).

Weights and constant-initialised leaves as in tests/test_torch_family_cases.py
(``make_pair``: JAX's init moved through the bridge, constant leaves
randomised on both sides). JAX runs through ``jax_exact`` (no excess
precision) with ``chunked_attention`` (which rounds the softmax weights to
bf16) replaced by its flash-attention oracle in every family that trains
through it (dense, moe and vlm through ``repro.models.dense``; encdec;
zamba2's shared block): the function the port's kernel and its backward
compute. JAX differentiates the oracle with XLA's autodiff; the port runs
``flash_attention_ref`` on the CPU, which autograd differentiates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.models import dense as jax_dense
from repro.models import encdec as jax_encdec
from repro.models import mamba2 as jax_mamba2
from repro.models.api import ModelSpec as JaxSpec
from repro_torch import bridge, configs
from repro_torch.models.api import ModelSpec
from repro_torch.models.common import flat_leaves
from test_torch_engine_cases import jax_exact
from test_torch_family_cases import Pair, f32, frames, make_pair, t2np, tokens  # noqa: F401

torch.set_num_threads(2)

ARCHS = ("qwen3-1.7b", "smollm-135m", "qwen2.5-32b", "mistral-large-123b", "olmoe-1b-7b",
         "llama4-scout-17b-a16e", "llava-next-34b", "whisper-base", "rwkv6-3b", "zamba2-7b")
# The loss is a mean of fp32 log-probabilities over bf16 logits that both
# sides round alike except where torch's CPU GEMMs and XLA's dots sum in
# another order. Measured (seed 3, batch 2 x 32): <= 5e-6 for nine archs;
# llama4-scout 1.09e-5, where 6 of 64 logit rows differ by one bf16 ulp
# (CE moves ~1e-3 on 4 tokens). A wrong loss is off by far more.
from torch_step_rules import LOSS_RTOL  # noqa: E402  (2e-5)
# Each gradient leaf within this fraction of its largest |value| (bf16
# gradients, summed in other orders by the two autodiffs; JAX under
# jax_exact rounds its bf16 reductions as it goes). Measured (seed 3): at
# most 0.0098 on the matrices of every arch but rwkv6.
GRAD_TOL = 2e-2
# Looser, with the measured reason: leaves whose gradient is a sum over
# every position of bf16 products that cancel (gains, biases, rwkv6's
# token-shift coefficients: qwen2.5-32b's bv 0.022, zamba2's dt_bias
# 0.014), and every leaf of rwkv6 (mu 0.039, embed 0.032; on mu both sides
# lie 0.18 of its max from the fp32 gradient, so this is bf16 noise).
GRAD_TOL_SUMS = 5e-2
NOISY_ARCHS = ("rwkv6-3b",)


@pytest.fixture(autouse=True, scope="module")
def jax_flash_attention():
    """JAX's ``chunked_attention`` in every family is its flash oracle.
    Module scope: in place before module-scoped fixtures run JAX (a test
    module imports this fixture by name)."""
    flash = lambda q, k, v, causal: jax_flash_ref(q, k, v, causal=causal)  # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_dense, jax_encdec, jax_mamba2):
            mp.setattr(mod, "chunked_attention", flash)
        yield


def train_pair(arch: str, seed: int = 3) -> Pair:
    """The same weights on both sides: ``make_pair``'s (constant leaves
    randomised), except zamba2's, which keep JAX's init: with random
    ``A_log`` a chunk's cumulative log-decay passes 88, and JAX's
    ``where(lower, exp(diff), 0)`` then has NaN gradients (0 x inf above
    the diagonal; the port masks before the exp, ROADMAP.md §3)."""
    if arch != "zamba2-7b":
        return make_pair(arch, seed)
    jspec = JaxSpec(jax_get_reduced(arch))
    tree = jax.tree_util.tree_map(np.asarray, jspec.init(jax.random.PRNGKey(seed)))
    return Pair(ModelSpec(configs.get_reduced(arch)), bridge.params_from_jax(tree), jspec,
                jax.tree_util.tree_map(jnp.asarray, tree))


def batches(cfg, B: int, S: int, seed: int):
    """(JAX batch, torch batch): tokens (B, S) and, for a vlm, patch
    embeddings (B, n_frontend_tokens, d), for an encdec frame embeddings
    (B, S // 4, d), bf16, the same numbers on both sides."""
    tok = tokens(cfg, B, S, seed)
    jb, tb = {"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok)}
    n_front = {"vlm": cfg.n_frontend_tokens, "encdec": max(S // 4, 1)}.get(cfg.family)
    if n_front is not None:
        jb["frontend"], tb["frontend"] = frames(cfg, B, n_front, seed + 1)
    return jb, tb


def jax_loss_and_grads(jspec, jparams, jbatch):
    """(loss, metrics, grads) of JAX's ``spec.loss`` by ``value_and_grad``."""
    fn = lambda p, b: jax.value_and_grad(lambda q: jspec.loss(q, b), has_aux=True)(p)  # noqa: E731
    (loss, metrics), grads = jax_exact(fn, jparams, jbatch)(jparams, jbatch)
    return loss, metrics, grads


def port_loss_and_grads(spec, params, batch, remat=True):
    """(loss, metrics, {name: grad}) of the port's ``spec.loss`` by
    ``backward``, on fresh leaves (``params`` is left as it was)."""
    leaves = {n: t.detach().clone().requires_grad_(True) for n, t in params.items()}
    loss, metrics = spec.loss(leaves, batch, remat=remat)
    loss.backward()
    return loss, metrics, {n: t.grad for n, t in leaves.items()}


def grad_tol(spec, arch: str, name: str) -> float:
    leaf = dict(flat_leaves(spec.schema()))[name]
    per_position_sum = sum(a != "layers" for a in leaf.axes) <= 1 or name.endswith((".mu", ".mu_c"))
    return GRAD_TOL_SUMS if per_position_sum or arch in NOISY_ARCHS else GRAD_TOL


def assert_grads_close(pair, arch, grads, jgrads):
    """Every leaf of the port's grads within ``grad_tol`` x its JAX leaf's
    largest |value|; none is NaN on either side."""
    jflat = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sorted(jflat) == sorted(grads)
    for n, g in grads.items():
        want = t2np(jflat[n])
        assert g is not None, n
        got = t2np(g)
        assert np.isfinite(want).all() and np.isfinite(got).all(), n
        tol = grad_tol(pair.spec, arch, n)
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        assert err <= tol * scale, (n, err, scale)
