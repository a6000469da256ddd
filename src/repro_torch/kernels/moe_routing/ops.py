"""The capacity MoE's routing glue: wrappers of ``csrc/moe_routing.cu``.

Replaces no Pallas kernel: the JAX package's ``moe_ffn`` is plain jnp that
XLA fuses, which eager PyTorch ran as ~37 launches a call. Five kernels, one
behind each of ``models/layers.py``'s ``moe_route`` (softmax, top k and
gates of the router's logits), ``moe_slots`` (the capacity slots),
``moe_dispatch`` (the experts' buffers) and ``moe_combine`` (the gated sum),
and the SwiGLU epilogue inside ``moe_experts``: with the router's matmul and
the three expert GEMMs, a ``moe_ffn`` call is 9 launches.

How a call chooses, by what it can observe: CPU or meta tensors take the
plain version (``ref.py``), CUDA tensors the kernels, each launch counted in
``counts.launches``. Where autograd records a graph (grad mode on and an
input that requires grad: training, remat's recompute) the kernel's outputs
carry a ``_Kernel`` node, whose backward differentiates the plain version
recomputed from the saved inputs; elsewhere no node is made, which spares
the node's host time (~7 us a call). The slot kernel's outputs are integers
and never carry one.
No path falls back: a shape, dtype or launch the kernels do not take raises.
Shapes, dtypes and contiguity are checked once per (shapes, strides,
dtypes, device) key, the 16-byte alignment of copied rows on every call.
"""
from __future__ import annotations

import ctypes
import types
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_routing import ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_EXPERTS, _MAX_K = 1024, 32
_SLOT_VPT = 4  # SLOT_VPT in the source: consecutive pairs a thread
_COMBINE_THREADS, _SWIGLU_THREADS, _SWIGLU_BLOCKS = 256, 256, 4096

_P, _I = _build.P, _build.I
_ROUTE_ARGS = [_P] * 5 + [_I] * 5 + [_P]
_SLOTS_ARGS = [_P] * 3 + [_I] * 4 + [_P]
_DISPATCH_ARGS = [_P] * 5 + [_I] * 5 + [_P]
_SWIGLU_ARGS = [_P, _P, _P, ctypes.c_longlong, _I, _I, _P]
_COMBINE_ARGS = [_P] * 6 + [_I] * 7 + [_P]

counts = types.SimpleNamespace(launches=0)
_SAVED = object()  # a tensor argument, kept by save_for_backward


def _tuple(outs):
    return outs if isinstance(outs, tuple) else (outs,)


class _Kernel(torch.autograd.Function):
    """A kernel's outputs with the plain version's gradient: the backward
    recomputes ``plain`` from the saved inputs under autograd and
    differentiates it (``flash_attention`` pairs its kernel with a plain-op
    backward alike). Integer outputs are not differentiable."""

    @staticmethod
    def forward(ctx, kernel, plain, *args):
        ctx.save_for_backward(*[a for a in args if isinstance(a, torch.Tensor)])
        ctx.plain, ctx.args = plain, [_SAVED if isinstance(a, torch.Tensor) else a for a in args]
        outs = kernel(*args)
        ctx.mark_non_differentiable(*[o for o in _tuple(outs) if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        saved = iter(ctx.saved_tensors)
        args = [next(saved).detach().requires_grad_(need) if a is _SAVED else a
                for a, need in zip(ctx.args, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            outs = _tuple(ctx.plain(*args))
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        wrt = [a for a in args if isinstance(a, torch.Tensor) and a.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs], allow_unused=True))
        return (None, None, *[next(got) if isinstance(a, torch.Tensor) and a.requires_grad else None for a in args])


def _run(kernel, plain, *args):
    """``kernel(*args)``, through ``_Kernel`` where autograd records a graph."""
    if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return _Kernel.apply(kernel, plain, *args)
    return kernel(*args)


def _launch(name: str, args, *values) -> None:
    _build.check(_build.function(name, args)(*values), f"{name} kernel")
    counts.launches += 1


def _pairs(what: str, device, T: int, k: int, **tensors) -> None:
    """Raise unless each (T, k) integer or bool input is as the kernels take it."""
    want = {"idx": torch.int64, "pos": torch.int64, "keep": torch.bool}
    _build.expect(what, device, *[(n, t, (T, k), want[n]) for n, t in tensors.items()])


def _aligned(what: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what} moves 16-byte vectors: its rows must be 16-byte aligned")


def moe_route(m, xt: torch.Tensor, w_router: torch.Tensor):
    """The router's matmul, then one launch: (fp32 logits (T, E), probs,
    gates (T, k), ids (T, k) int64), the plain version's bits."""
    if _build.plain(xt, "moe_route"):
        return ref.moe_route(m, xt, w_router)
    return _run(_route, ref.route, xt @ w_router, m.top_k)


def _route(raw: torch.Tensor, k: int):
    T, E = raw.shape

    def check():
        if raw.dtype not in _DTYPE_CODES:
            raise ValueError(f"moe_route takes f32/bf16 logits, got {raw.dtype}")
        if E > _MAX_EXPERTS or not 0 < k <= min(E, _MAX_K):
            raise ValueError(f"moe_route takes up to {_MAX_EXPERTS} experts and top k <= {_MAX_K}: got {E}, {k}")
        if not raw.is_contiguous():
            raise ValueError("moe_route: the router's logits must be contiguous")

    _build.validate_once(("moe_route", k), (raw,), check)
    logits = torch.empty((T, E), dtype=torch.float32, device=raw.device)
    probs = torch.empty((T, E), dtype=torch.float32, device=raw.device)
    gates = torch.empty((T, k), dtype=torch.float32, device=raw.device)
    idx = torch.empty((T, k), dtype=torch.int64, device=raw.device)
    if T:
        _launch("repro_moe_route", _ROUTE_ARGS, raw.data_ptr(), logits.data_ptr(), probs.data_ptr(),
                gates.data_ptr(), idx.data_ptr(), T, E, k, 1 << (k.bit_length() - 1),
                _DTYPE_CODES[raw.dtype], _build.stream(raw.device))
    return logits, probs, gates, idx


def moe_slots(idx: torch.Tensor, num_experts: int, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch: (pos (T, k) int64, keep (T, k) bool), the plain version's
    values; an id outside [0, E) gets pos -1, keep False (the plain version
    raises there)."""
    if _build.plain(idx, "moe_slots"):
        return ref.moe_slots(idx, num_experts, cap)
    idx = idx.contiguous()
    T, k = idx.shape
    _build.validate_once("moe_slots", (idx,), lambda: _pairs("moe_slots", idx.device, T, k, idx=idx))
    pos = torch.empty((T, k), dtype=torch.int64, device=idx.device)
    keep = torch.empty((T, k), dtype=torch.bool, device=idx.device)
    n = T * k
    if n:
        threads = min(1024, -(-n // (_SLOT_VPT * 32)) * 32)
        _launch("repro_moe_slots", _SLOTS_ARGS, idx.data_ptr(), pos.data_ptr(), keep.data_ptr(), n,
                num_experts, cap, threads, _build.stream(idx.device))
    return pos, keep


def moe_dispatch(xt: torch.Tensor, idx, pos, keep, num_experts: int, cap: int) -> torch.Tensor:
    """One launch: the (E, cap, d) buffers, each kept slot its token's row,
    empty slots zero (the plain version's bits)."""
    if _build.plain(xt, "moe_dispatch"):
        return ref.moe_dispatch(xt, idx, pos, keep, num_experts, cap)
    return _run(_dispatch, ref.moe_dispatch, xt, idx, pos, keep, num_experts, cap)


def _dispatch(xt, idx, pos, keep, num_experts: int, cap: int) -> torch.Tensor:
    xt, idx, pos, keep = xt.contiguous(), idx.contiguous(), pos.contiguous(), keep.contiguous()
    T, d = xt.shape
    k = idx.shape[1]
    row_bytes = d * xt.element_size()

    def check():
        _pairs("moe_dispatch", xt.device, T, k, idx=idx, pos=pos, keep=keep)
        if row_bytes % 16:
            raise ValueError("moe_dispatch copies 16-byte vectors: rows must be a multiple of 16 bytes")

    _build.validate_once("moe_dispatch", (xt, idx, pos, keep), check)
    _aligned("moe_dispatch", xt)
    buf = torch.empty((num_experts, cap, d), dtype=xt.dtype, device=xt.device)
    if T * k == 0:
        return buf.zero_()
    _launch("repro_moe_dispatch", _DISPATCH_ARGS, xt.data_ptr(), idx.data_ptr(), pos.data_ptr(),
            keep.data_ptr(), buf.data_ptr(), T * k, k, num_experts, cap, row_bytes, _build.stream(xt.device))
    return buf


def swiglu_epilogue(h: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One launch: ``silu(h.float()).to(h.dtype) * u``, the plain version's bits."""
    if _build.plain(h, "swiglu_epilogue"):
        return ref.swiglu_epilogue(h, u)
    return _run(_swiglu, ref.swiglu_epilogue, h, u)


def _swiglu(h: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    def check():
        if h.dtype not in _DTYPE_CODES:
            raise ValueError(f"swiglu_epilogue takes f32/bf16, got {h.dtype}")
        _build.expect("swiglu_epilogue", h.device, ("h", h, h.shape, h.dtype), ("u", u, h.shape, h.dtype))

    _build.validate_once("swiglu_epilogue", (h, u), check)
    _aligned("swiglu_epilogue", h, u)
    out = torch.empty_like(h)
    n = h.numel()
    if n:
        blocks = max(1, min(_SWIGLU_BLOCKS, -(-n // (16 // h.element_size() * _SWIGLU_THREADS))))
        _launch("repro_moe_swiglu", _SWIGLU_ARGS, out.data_ptr(), h.data_ptr(), u.data_ptr(), n, blocks,
                _DTYPE_CODES[h.dtype], _build.stream(h.device))
    return out


def moe_experts(dispatch: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """The gate and up GEMMs, ``swiglu_epilogue``, the down GEMM."""
    h, u = torch.bmm(dispatch, w_gate), torch.bmm(dispatch, w_up)
    return torch.bmm(swiglu_epilogue(h, u), w_down)


def moe_combine(eo: torch.Tensor, idx, pos, gate_vals, keep, cap: int) -> torch.Tensor:
    """One launch: (T, d), each token's sum over its choices of the gate
    times ``keep`` rounded to ``eo``'s dtype, times the expert's row at
    clip(pos), in fp32 and rounded once (the plain version's einsum within
    bf16 rounding)."""
    if _build.plain(eo, "moe_combine"):
        return ref.moe_combine(eo, idx, pos, gate_vals, keep, cap)
    return _run(_combine, ref.moe_combine, eo, idx, pos, gate_vals, keep, cap)


def _combine(eo, idx, pos, gate_vals, keep, cap: int) -> torch.Tensor:
    idx, pos, gate_vals, keep = idx.contiguous(), pos.contiguous(), gate_vals.contiguous(), keep.contiguous()
    E, _, d = eo.shape
    T, k = idx.shape
    vec = 16 // eo.element_size()

    def check():
        if eo.dtype not in _DTYPE_CODES:
            raise ValueError(f"moe_combine takes f32/bf16 expert outputs, got {eo.dtype}")
        if k > _MAX_K or d % vec:
            raise ValueError(f"moe_combine takes top k <= {_MAX_K} and rows of 16-byte vectors: k {k}, d {d}")
        _build.expect("moe_combine", eo.device, ("eo", eo, (E, cap, d), eo.dtype),
                      ("gate_vals", gate_vals, (T, k), torch.float32))
        _pairs("moe_combine", eo.device, T, k, idx=idx, pos=pos, keep=keep)

    _build.validate_once(("moe_combine", cap), (eo, idx, pos, gate_vals, keep), check)
    _aligned("moe_combine", eo)
    out = torch.empty((T, d), dtype=eo.dtype, device=eo.device)
    if T:
        threads = min(_COMBINE_THREADS, -(-d // (vec * 32)) * 32)
        _launch("repro_moe_combine", _COMBINE_ARGS, eo.data_ptr(), idx.data_ptr(), pos.data_ptr(),
                gate_vals.data_ptr(), keep.data_ptr(), out.data_ptr(), T, k, E, cap, d,
                threads, _DTYPE_CODES[eo.dtype], _build.stream(eo.device))
    return out
