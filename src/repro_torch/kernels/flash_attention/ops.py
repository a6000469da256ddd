"""Prefill attention: wrapper of ``csrc/flash_attention.cu``.

Replaces ``src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas``
(which JAX's prefill never calls; the port wires it in where JAX calls
``chunked_attention``: ``models/dense.py::_block``, the encoder-decoder's
three attentions in ``models/encdec.py`` — the cross-attention non-causal
with S_q != S_kv — and zamba2's shared block in ``models/mamba2.py``).
Bound on the card: bytes at prompt lengths below ~900 at the bf16 tensor
rate. Two routes, chosen by dtype and never
as a fallback:

- ``tensor_core`` (bf16): TMA brings Q and a 6-stage ring of 64-key K/V
  tiles into shared memory; per 64-query tile and head, three warpgroups
  take the key tiles in turn and run S = Q.K^T and O += P.V on wgmma, with
  the online softmax in registers, and merge at the end. hd must be 16, 32,
  64, 112 or 128 (112 runs the 128 instantiation on zero-filled columns).
- ``cuda_core`` (fp32): 32 x 32 tiles in fp32 shared memory, fp32 register
  blocks; keeps the 3e-5 tolerance that TF32 or bf16 rounding would not.

Both skip key tiles above the causal diagonal and mask the ragged edge, so
any prompt length works. ``flash_attention.launches`` counts every launch;
``flash_attention.route_launches`` counts them by route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

TC_HEAD_DIMS = (16, 32, 64, 112, 128)
_ARGS = [_build.P] * 4 + [_build.I] * 7 + [_build.P]


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, S_kv, KV, hd) -> (B, S, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    B, S, H, hd = q.shape
    S_kv, KV = k.shape[1], k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, S_kv, KV, hd) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} {t.device} does not match q")
    if H % KV or S == 0 or S_kv == 0:
        raise ValueError(f"flash_attention: H={H} KV={KV} S={S} S_kv={S_kv} not supported")
    if q.dtype == torch.bfloat16:
        route, entry = "tensor_core", "repro_flash_attention_bf16"
        if hd not in TC_HEAD_DIMS:
            raise ValueError(f"flash_attention (tensor cores): hd={hd} not in {TC_HEAD_DIMS}")
    elif q.dtype == torch.float32:
        route, entry = "cuda_core", "repro_flash_attention_f32"
        if hd % 16 or hd > 128:
            raise ValueError(f"flash_attention (CUDA cores): hd={hd} not supported")
    else:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    err = _build.function(entry, _ARGS)(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        B, S, S_kv, H, KV, hd, int(causal), _build.stream(q.device),
    )
    _build.check(err, f"flash_attention kernel ({route})")
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    return out


flash_attention.launches = 0
flash_attention.route_launches = {"tensor_core": 0, "cuda_core": 0}
