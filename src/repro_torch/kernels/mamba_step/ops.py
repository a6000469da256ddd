"""One decode token of a Mamba2 layer over per-request state slots: wrapper
of ``csrc/mamba_step.cu``.

Replaces no Pallas kernel: the JAX package decodes Mamba2 in jnp, which
eager PyTorch runs as ~35 launches a layer and, over a batch of requests,
a gather and a scatter of every row's state. One launch a layer: the conv
update (with bias and silu), dt's softplus, the decay, the state update,
C.S + D x, the gate and the group norm, each row's conv window and SSM
state read and written once, in place in its request's slot.

Beside it, ``rms_norm_rows``: the RMSNorm of each row of a (rows, d) bf16
tensor in one launch (the plain recipe, ``models/layers.py::rmsnorm``, is ~8
eager ops), for the decode step's norms of the "zamba2" family.

CUDA tensors take the kernels, CPU and meta tensors the plain versions
(``ref.py``, ``layers.rmsnorm``); no path falls back. Shapes, dtypes and
contiguity are checked once per (shapes, strides, dtypes, device) key.
``mamba_step.launches`` and ``rms_norm_rows.launches`` count their launches.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_step.ref import mamba_step_ref
from repro_torch.models.layers import rmsnorm

_ARGS = [_build.P] * 14 + [_build.I] * 7 + [_build.F32, _build.P]
_NORM_ARGS = [_build.P] * 3 + [_build.I] * 2 + [_build.F32, _build.P]
_STATE_COLS = (32, 64, 128)  # N: 32 x {1, 2, 4} columns a lane
_MAX_P, _MAX_W = 128, 8

# (device, B, H, P, G) -> (ybuf, part, count): the kernel's scratch; count holds
# zeros between launches (the kernel resets what it uses)
_scratch: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def _buffers(device, B: int, H: int, P: int, G: int):
    key = (device, B, H, P, G)
    if key not in _scratch:
        _scratch[key] = (torch.empty((B, H * P), dtype=torch.float32, device=device),
                         torch.empty((B, H), dtype=torch.float32, device=device),
                         torch.zeros((B, G), dtype=torch.int32, device=device))
    return _scratch[key]


def mamba_step(zxbcdt, conv_state, ssm_state, conv_w, conv_b, dt_bias, A_log, D, norm_w, req_ids, *,
               groups: int, eps: float = 1e-5) -> torch.Tensor:
    """``zxbcdt`` (B, 2 inner + 2 G N + H) -> y (B, inner), the states of
    the rows' slots (``req_ids``, -1: the scratch slot) updated in place.
    See ``ref.py`` for the shapes and the recipe."""
    if _build.plain(zxbcdt, "mamba_step"):
        return mamba_step_ref(zxbcdt, conv_state, ssm_state, conv_w, conv_b, dt_bias, A_log, D, norm_w, req_ids,
                              groups=groups, eps=eps)
    B = zxbcdt.shape[0]
    slots, H, P, N = ssm_state.shape
    G, inner = groups, H * P
    W = conv_w.shape[-1]
    C = inner + 2 * G * N

    def check():
        dt = torch.bfloat16
        if N not in _STATE_COLS or P > _MAX_P or W > _MAX_W or H % G:
            raise ValueError(f"mamba_step: H={H} P={P} N={N} G={G} W={W} not supported")
        checks = [
            ("zxbcdt", zxbcdt, (B, 2 * inner + 2 * G * N + H), dt), ("conv_state", conv_state, (slots, W - 1, C), dt),
            ("ssm_state", ssm_state, (slots, H, P, N), torch.float32), ("conv_w", conv_w, (C, W), dt),
            ("dt_bias", dt_bias, (H,), dt), ("A_log", A_log, (H,), dt), ("D", D, (H,), dt),
            ("norm_w", norm_w, (inner,), dt), ("req_ids", req_ids, (B,), torch.int32),
        ]
        if conv_b is not None:
            checks.append(("conv_b", conv_b, (C,), dt))
        _build.expect("mamba_step", zxbcdt.device, *checks)

    _build.validate_once(("mamba_step", G),
                         (zxbcdt, conv_state, ssm_state, conv_w, conv_b, dt_bias, A_log, D, norm_w, req_ids), check)
    ybuf, part, count = _buffers(zxbcdt.device, B, H, P, G)
    out = torch.empty((B, inner), dtype=zxbcdt.dtype, device=zxbcdt.device)
    err = _build.function("repro_mamba_step", _ARGS)(
        _build.ptr(zxbcdt), _build.ptr(conv_state), _build.ptr(ssm_state), _build.ptr(conv_w),
        None if conv_b is None else _build.ptr(conv_b), _build.ptr(dt_bias), _build.ptr(A_log), _build.ptr(D),
        _build.ptr(norm_w), _build.ptr(req_ids), _build.ptr(ybuf), _build.ptr(part), _build.ptr(count),
        _build.ptr(out), B, H, P, N, G, W, slots, float(eps), _build.stream(zxbcdt.device),
    )
    _build.check(err, "mamba_step kernel")
    mamba_step.launches += 1
    return out


mamba_step.launches = 0


def rms_norm_rows(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """``layers.rmsnorm`` of each row of x (rows, d) in one launch on the
    card (bf16, d a multiple of 8): within a bf16 ulp of the plain recipe,
    whose squares it sums in another order."""
    if _build.plain(x, "rms_norm_rows"):
        return rmsnorm(x, gamma, eps)
    rows, d = x.shape

    def check():
        if d % 8:
            raise ValueError(f"rms_norm_rows: d={d} is not a multiple of 8")
        _build.expect("rms_norm_rows", x.device, ("x", x, (rows, d), torch.bfloat16),
                      ("gamma", gamma, (d,), torch.bfloat16))

    _build.validate_once("rms_norm_rows", (x, gamma), check)
    out = torch.empty_like(x)
    err = _build.function("repro_rms_norm_rows", _NORM_ARGS)(
        _build.ptr(x), _build.ptr(gamma), _build.ptr(out), rows, d, float(eps), _build.stream(x.device))
    _build.check(err, "rms_norm_rows kernel")
    rms_norm_rows.launches += 1
    return out


rms_norm_rows.launches = 0
