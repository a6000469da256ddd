"""Flash attention's backward on the CPU: ``flash_attention_bwd`` (the
VJP the wrapper's autograd node runs on the card) against ``jax.vjp`` of
JAX's flash-attention oracle and against autograd of the port's plain
version, same inputs from numpy; and the autograd wrapper's wiring.

Tolerances: fp32 1e-5 of the gradient's max |value| (the same fp32 sums in
other orders); bf16 inputs 1e-2 of it (both sides compute in fp32 and round
the gradients to bf16 once; the two differ by at most a bf16 ulp, 2^-8
relative, where the fp32 values straddle a rounding)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro_torch import bridge
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

torch.set_num_threads(2)
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
DT = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}

# (B, S, S_kv, H, KV, hd, causal): GQA, full attention, S_q != S_kv both
# ways (whisper's cross-attention), head dims 64 and 112 (zamba2), 16
CASES = [
    (2, 37, 37, 4, 2, 16, True),
    (2, 37, 37, 4, 2, 16, False),
    (1, 45, 45, 4, 1, 64, True),
    (2, 29, 11, 4, 4, 64, False),
    (1, 20, 48, 6, 3, 16, True),
    (1, 33, 33, 2, 2, 112, True),
    (2, 19, 9, 2, 1, 112, False),
]


def _inputs(B, S, S_kv, H, KV, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    shapes = ((B, S, H, hd), (B, S_kv, KV, hd), (B, S_kv, KV, hd), (B, S, H, hd))
    tdt, jdt = DT[dtype]
    arrays = [np.asarray(jnp.asarray(rng.normal(size=s).astype(np.float32), jdt)) for s in shapes]
    return [jnp.asarray(a) for a in arrays], [bridge._to_torch(a) for a in arrays]


def _assert_close(got, want, tol, what):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,S_kv,H,KV,hd,causal", CASES)
def test_backward_matches_jax_vjp(B, S, S_kv, H, KV, hd, causal, dtype):
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(B, S, S_kv, H, KV, hd, dtype, seed=S * 7 + hd)
    out, vjp = jax.vjp(lambda a, b, c: jax_flash_ref(a, b, c, causal=causal), jq, jk, jv)
    want = vjp(jdo)
    got = flash_attention_bwd(q, k, v, bridge._to_torch(np.asarray(out)), do, causal=causal, chunk=16)
    for x, a, b in zip("qkv", got, want):
        assert a.dtype == q.dtype and tuple(a.shape) == tuple(b.shape)
        _assert_close(a, b, TOL[dtype], f"d{x}")


@pytest.mark.parametrize("chunk", [7, 1024])
@pytest.mark.parametrize("B,S,S_kv,H,KV,hd,causal", CASES)
def test_backward_matches_autograd_of_the_plain_version(B, S, S_kv, H, KV, hd, causal, chunk):
    """Query chunks of 7 (several, the last ragged) and of 1024 (one) give
    autograd's gradients of ``flash_attention_ref``."""
    _, (q, k, v, do) = _inputs(B, S, S_kv, H, KV, hd, "float32", seed=S + hd)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention_ref(*leaves, causal=causal)
    want = torch.autograd.grad(out, leaves, do)
    got = flash_attention_bwd(q, k, v, out.detach(), do, causal=causal, chunk=chunk)
    for x, a, b in zip("qkv", got, want):
        _assert_close(a, b.numpy(), TOL["float32"], f"d{x}")


def test_autograd_wrapper_runs_the_backward(monkeypatch):
    """The wrapper's autograd node (what the card runs: the kernel, here
    stood in for by the plain version's forward) gives
    ``flash_attention_bwd``'s gradients, and the backward never calls the
    plain version."""
    _, (q, k, v, do) = _inputs(2, 37, 37, 4, 2, 16, "float32", seed=3)
    monkeypatch.setattr(ops, "_launch", lambda q_, k_, v_, causal: flash_attention_ref(q_, k_, v_, causal=causal))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops._FlashAttention.apply(*leaves, True)
    assert out.grad_fn is not None
    monkeypatch.setattr(ops, "flash_attention_ref", lambda *a, **kw: pytest.fail("the backward called the plain version"))
    got = torch.autograd.grad(out, leaves, do)
    want = flash_attention_bwd(q, k, v, out.detach(), do, causal=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_cpu_wrapper_is_the_differentiable_plain_version():
    """On the CPU the wrapper runs ``flash_attention_ref``, which autograd
    differentiates: its gradients are the plain version's."""
    _, (q, k, v, do) = _inputs(1, 21, 21, 4, 2, 16, "float32", seed=4)
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    b = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ga = torch.autograd.grad(ops.flash_attention(*a, causal=True), a, do)
    gb = torch.autograd.grad(flash_attention_ref(*b, causal=True), b, do)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))
