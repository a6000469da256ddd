"""The MoE's routing glue on the CPU: ``models/layers.py``'s moe_route,
moe_slots, moe_dispatch, moe_experts and moe_combine run the plain version
(``kernels/moe_routing/ref.py``) bit for bit, launch nothing, and agree with
a numpy oracle of their semantics written from the docstrings:

- ids: a stable descending sort of the probabilities (ties to the lower
  expert), exactly; gates within 2^-20 (8 fp32 ulps) of g / max(sum g,
  1e-9) in float64 (the fp32 sum of k gates rounds k - 1 times);
- pos and keep: a counter a expert, claimed in token-major, choice-minor
  order, exactly;
- the dispatch buffer: each kept slot its token's row, empty slots zero,
  bit for bit;
- the combine: within one bf16 ulp of the float64 sum of the bf16-rounded
  gates times the gathered rows (a single rounding of a sum the einsum
  takes in fp32).

The cases are the card's (tests/test_torch_gpu.py::test_moe_routing_kernels):
E/k of 64/8, 8/2, 16/1 and 4/1 at T of 1, 32, 381 and 2048, rows sharing a
component so that the favoured experts overflow, a run of repeated rows (as
padding repeats token 0), an exact tie between two router columns, and rows
whose logits all tie. ``moe_ffn`` against JAX is tests/test_torch_moe.py.

The card's autograd node (``ops._Kernel``: the kernel's outputs forward, the
plain version's gradient backward) is run here with the plain version
standing in for the kernel: its gradients equal plain autograd's bit for
bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import MoEConfig
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.moe_routing import ops, ref
from repro_torch.models import layers

torch.set_num_threads(2)

CASES = [(E, k, T, "random") for E, k in ((64, 8), (8, 2), (16, 1), (4, 1)) for T in (1, 32, 381, 2048)] \
    + [(E, k, 32, "ties") for E, k in ((64, 8), (8, 2), (16, 1), (4, 1))]


def _case(E, k, T, kind, d=32):
    rng = np.random.default_rng(E * 100_000 + k * 10_000 + T)
    x = rng.normal(size=(T, d)) + 1.5 * rng.normal(size=d)
    x[T // 2:T // 2 + T // 4] = x[0]
    w = rng.normal(size=(d, E)) / np.sqrt(d)
    w[:, E - 1] = w[:, 0]
    if kind == "ties":
        w[:] = 0.0
    as_bf16 = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    return as_bf16(x), as_bf16(w), max(1, int(T * k * 1.25 / E))


def _claims(idx: np.ndarray, E: int, cap: int):
    """pos and keep by a counter an expert, in token-major, choice-minor order."""
    seen = np.zeros(E, np.int64)
    pos = np.zeros(idx.shape, np.int64)
    for t, j in np.ndindex(*idx.shape):
        pos[t, j] = seen[idx[t, j]]
        seen[idx[t, j]] += 1
    return pos, pos < cap


@pytest.mark.parametrize("E,k,T,kind", CASES)
def test_moe_routing_plain_on_cpu(E, k, T, kind):
    m = MoEConfig(num_experts=E, top_k=k, d_ff_expert=16)
    xt, w, cap = _case(E, k, T, kind)
    reset_launch_counts()

    route = layers.moe_route(m, xt, w)
    for got, want in zip(route, ref.moe_route(m, xt, w)):
        assert torch.equal(got, want)
    logits, probs, gates, idx = (t.numpy() for t in route)
    np.testing.assert_array_equal(logits, (xt @ w).float().numpy())
    want_idx = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    np.testing.assert_array_equal(idx, want_idx)
    if kind == "ties":
        assert idx.tolist() == [list(range(k))] * T
    top = np.take_along_axis(probs, want_idx, axis=-1).astype(np.float64)
    np.testing.assert_allclose(gates, top / np.maximum(top.sum(-1, keepdims=True), 1e-9), rtol=2.0 ** -20, atol=0)

    pos, keep = layers.moe_slots(route[3], E, cap)
    rpos, rkeep = ref.moe_slots(route[3], E, cap)
    assert torch.equal(pos, rpos) and torch.equal(keep, rkeep) and pos.dtype == torch.int64
    want_pos, want_keep = _claims(idx, E, cap)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if kind == "random" and T >= 32:
        assert not keep.all(), "no (token, choice) was dropped: capacity not exercised"

    buf = layers.moe_dispatch(xt, route[3], pos, keep, E, cap)
    assert torch.equal(buf.view(torch.int16), ref.moe_dispatch(xt, route[3], pos, keep, E, cap).view(torch.int16))
    want_buf = np.zeros((E, cap, xt.shape[1]), np.float32)
    for t, j in zip(*np.nonzero(want_keep)):
        want_buf[idx[t, j], want_pos[t, j]] = xt[t].float().numpy()
    np.testing.assert_array_equal(buf.float().numpy(), want_buf)

    gen = torch.Generator().manual_seed(T)
    wg, wu = (torch.randn((E, xt.shape[1], 16), generator=gen).to(torch.bfloat16) for _ in range(2))
    wd = torch.randn((E, 16, xt.shape[1]), generator=gen).to(torch.bfloat16)
    eo = layers.moe_experts(buf, wg, wu, wd)
    assert torch.equal(eo.view(torch.int16), ref.moe_experts(buf, wg, wu, wd).view(torch.int16))

    out = layers.moe_combine(eo, route[3], pos, route[2], keep, cap)
    want = ref.moe_combine(eo, route[3], pos, route[2], keep, cap)
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))
    g = (route[2] * keep).to(torch.bfloat16).double().numpy()
    rows = eo.double().numpy()[idx, np.clip(want_pos, 0, cap - 1)]  # (T, k, d)
    want_out = np.einsum("tk,tkd->td", g, rows)
    ulp = np.maximum(2.0 ** (np.floor(np.log2(np.maximum(np.abs(want_out), 2.0 ** -126))) - 7), 2.0 ** -133)
    assert (np.abs(out.double().numpy() - want_out) <= ulp).all()

    assert launch_counts()["moe_routing"] == 0


def test_combine_keep_is_the_gates_times_keep():
    """A dropped pair contributes nothing to ``moe_combine``: its token's
    output is the same whatever the expert row at clip(pos) holds."""
    m = MoEConfig(num_experts=8, top_k=2, d_ff_expert=16)
    xt, w, cap = _case(8, 2, 32, "random")
    _, _, gates, idx = layers.moe_route(m, xt, w)
    pos, keep = layers.moe_slots(idx, 8, cap)
    eo = torch.randn((8, cap, xt.shape[1]), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    assert not keep.all()
    dropped = ~keep
    scrawled = eo.clone()
    scrawled[idx[dropped], pos[dropped].clamp(0, cap - 1)] = 1e4  # each dropped pair's row
    kept_rows = torch.zeros_like(eo, dtype=torch.bool)
    kept_rows[idx[keep], pos[keep]] = True
    scrawled[kept_rows] = eo[kept_rows]  # a row a kept pair also reads stays as it was
    out = layers.moe_combine(eo, idx, pos, gates, keep, cap)
    assert torch.equal(layers.moe_combine(scrawled, idx, pos, gates, keep, cap), out)
    assert not torch.equal(out, layers.moe_combine(eo, idx, pos, gates, torch.ones_like(keep), cap))


def test_moe_ffn_on_cpu_launches_nothing():
    """A CPU ``moe_ffn`` with weights that require grad runs the plain
    version: no launch, and the gradients flow."""
    from repro_torch.configs import get_reduced

    cfg = get_reduced("olmoe-1b-7b")
    m, d = cfg.moe, cfg.d_model
    gen = torch.Generator().manual_seed(0)
    w = [torch.randn(s, generator=gen).to(torch.bfloat16).requires_grad_(True)
         for s in ((d, m.num_experts), (m.num_experts, d, m.d_ff_expert), (m.num_experts, d, m.d_ff_expert),
                   (m.num_experts, m.d_ff_expert, d))]
    x = torch.randn((2, 5, d), generator=gen).to(torch.bfloat16)
    reset_launch_counts()
    out, aux = layers.moe_ffn(cfg, x, *w)
    (out.float().sum() + aux).backward()
    assert all(t.grad is not None for t in w)
    assert launch_counts()["moe_routing"] == 0


def _node_case(name):
    """(kernel/plain function, its arguments) at a small MoE shape, the float
    inputs leaves that require grad."""
    E, k = 8, 2
    m = MoEConfig(num_experts=E, top_k=k, d_ff_expert=16)
    xt, w, cap = _case(E, k, 32, "random")
    _, _, gates, idx = ref.moe_route(m, xt, w)
    pos, keep = ref.moe_slots(idx, E, cap)
    gen = torch.Generator().manual_seed(1)

    def leaf(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16).requires_grad_(True)

    if name == "route":
        return ref.route, (leaf(32, E), k)
    if name == "dispatch":
        return ref.moe_dispatch, (leaf(32, xt.shape[1]), idx, pos, keep, E, cap)
    if name == "swiglu":
        return ref.swiglu_epilogue, (leaf(E, cap, 16), leaf(E, cap, 16))
    return ref.moe_combine, (leaf(E, cap, xt.shape[1]), idx, pos, gates.clone().requires_grad_(True), keep, cap)


@pytest.mark.parametrize("name", ["route", "dispatch", "swiglu", "combine"])
def test_kernel_node_takes_the_plain_gradient(name):
    """``ops._Kernel`` (the autograd node of a kernel's outputs) gives the
    plain version's gradients bit for bit, with the plain version standing
    in for the kernel; integer outputs carry no gradient; with no input
    that requires grad, ``ops._run`` makes no node."""
    fn, args = _node_case(name)
    leaves = [a for a in args if isinstance(a, torch.Tensor) and a.requires_grad]
    gen = torch.Generator().manual_seed(2)

    def grads(outs):
        outs = [o for o in (outs if isinstance(outs, tuple) else (outs,)) if o.requires_grad]
        assert outs
        up = [torch.randn(o.shape, generator=gen).to(o.dtype) for o in outs]
        return torch.autograd.grad(outs, leaves, up)

    gen.manual_seed(2)
    want = grads(fn(*args))
    gen.manual_seed(2)
    outs = ops._run(fn, fn, *args)
    got = grads(outs)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if name == "route":
        assert not outs[3].requires_grad and outs[3].dtype == torch.int64
    with torch.no_grad():
        outs = ops._run(fn, fn, *args)
    assert all(o.grad_fn is None for o in (outs if isinstance(outs, tuple) else (outs,)))
    outs = ops._run(fn, fn, *[a.detach() if isinstance(a, torch.Tensor) else a for a in args])
    assert all(o.grad_fn is None for o in (outs if isinstance(outs, tuple) else (outs,)))
