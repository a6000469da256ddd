"""Prefill attention: wrapper of ``csrc/flash_attention.cu``.

Replaces ``src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas``
(which JAX's dense prefill never calls; the port wires it into
``models/dense.py::_block``). Bound on the card: bytes at prompt lengths
below ~900 for the ideal bf16 tensor-core kernel, but this first kernel does
its arithmetic on the fp32 CUDA cores. It tiles 32 queries x 32 keys in
shared memory with fp32 register blocks, skips key tiles above the causal
diagonal and masks the ragged edge, so any prompt length works.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, S_kv, KV, hd) -> (B, S, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    B, S, H, hd = q.shape
    S_kv, KV = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, S_kv, KV, hd) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} {t.device} does not match q")
    if H % KV or hd % 16 or hd > 128 or S == 0 or S_kv == 0:
        raise ValueError(f"flash_attention: H={H} KV={KV} hd={hd} S={S} S_kv={S_kv} not supported")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    fn = _build.function("repro_flash_attention", [_build.P] * 4 + [_build.I] * 8 + [_build.P])
    err = fn(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        B, S, S_kv, H, KV, hd, int(causal), _DTYPE_CODES[q.dtype], _build.stream(q.device),
    )
    _build.check(err, "flash_attention kernel")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
