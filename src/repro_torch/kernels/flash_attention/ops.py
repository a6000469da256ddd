"""Prefill attention: wrapper of ``csrc/flash_attention.cu``.

Replaces ``src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas``
(which JAX's prefill never calls; the port wires it in where JAX calls
``chunked_attention``: ``models/dense.py::_block``, the encoder-decoder's
three attentions in ``models/encdec.py`` — the cross-attention non-causal
with S_q != S_kv — and zamba2's shared blocks in ``models/mamba2.py`` and
``models/zamba2.py``). The scores are scaled by 1/sqrt(hd); a caller that
wants another scale folds it into q (``zamba2.scale_q``).
Bound on the card: bytes at prompt lengths below ~900 at the bf16 tensor
rate. Two routes, chosen by dtype and never
as a fallback:

- ``tensor_core`` (bf16): TMA brings Q and a 6-stage ring of 64-key K/V
  tiles into shared memory; per 64-query tile and head, three warpgroups
  take the key tiles in turn and run S = Q.K^T and O += P.V on wgmma, with
  the online softmax in registers, and merge at the end. hd must be 16, 32,
  64, 112, 128 or 224 (112 runs the 128 instantiation on zero-filled
  columns, 224 the 256 one, with two warpgroups and a 2-stage ring).
- ``cuda_core`` (fp32): 32 x 32 tiles in fp32 shared memory, fp32 register
  blocks; keeps the 3e-5 tolerance that TF32 or bf16 rounding would not.

Both skip key tiles above the causal diagonal and mask the ragged edge, so
any prompt length works. ``flash_attention.launches`` counts every launch;
``flash_attention.route_launches`` counts them by route.

Training differentiates through it: on the card the kernel runs inside a
``torch.autograd.Function`` whose backward is ``flash_attention_bwd``, the
attention VJP in PyTorch ops (fp32, over query chunks of ``Q_CHUNK``, the
chunk of JAX's ``chunked_attention``, whose XLA autodiff is what the JAX
package differentiates; it has no backward kernel). The backward launches
no flash kernel. On the CPU the wrapper runs ``flash_attention_ref``, which
autograd differentiates.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import NEG_INF, flash_attention_ref

TC_HEAD_DIMS = (16, 32, 64, 112, 128, 224)
_ARGS = [_build.P] * 4 + [_build.I] * 7 + [_build.P]
Q_CHUNK = 1024  # the backward's query chunk: O(Q_CHUNK x S_kv) fp32 scratch


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, S_kv, KV, hd) -> (B, S, H, hd) in q's dtype.
    Differentiable: on a CUDA tensor the kernel's output carries an autograd
    node whose backward is ``flash_attention_bwd``."""
    if _build.plain(q, "flash_attention"):
        return flash_attention_ref(q, k, v, causal=causal)
    return _FlashAttention.apply(q, k, v, causal)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = _launch(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention_bwd(q, k, v, out, dout, *, causal: bool = True, chunk: int = Q_CHUNK):
    """The attention VJP: (dq, dk, dv) of ``out = attention(q, k, v)`` for
    the upstream gradient ``dout``, in the inputs' dtypes. Per query chunk,
    in fp32: S = q.k^T / sqrt(hd) under the finite causal mask, P =
    softmax(S), dV = P^T.dO, dP = dO.V^T, dS = P o (dP - rowsum(dO o O)),
    dQ = dS.K / sqrt(hd), dK = dS^T.Q / sqrt(hd); dK and dV summed over the
    GQA group. Causal chunks read only the keys up to their last query.
    Device-agnostic PyTorch ops (no kernel launch, no call of the plain
    version)."""
    B, S, H, hd = q.shape
    S_kv, KV = k.shape[1], k.shape[2]
    g = H // KV
    root = math.sqrt(hd)

    def grouped(t, s0, s1):  # (B, c, H, hd) rows s0:s1 -> (B, KV, g * c, hd) fp32, rows (group, query)
        c = s1 - s0
        return t[:, s0:s1].float().reshape(B, c, KV, g, hd).permute(0, 2, 3, 1, 4).reshape(B, KV, g * c, hd)

    dq = torch.empty_like(q)
    dk = torch.zeros((B, KV, S_kv, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for s0 in range(0, S, chunk):
        s1 = min(S, s0 + chunk)
        c, end = s1 - s0, (min(S_kv, s1) if causal else S_kv)
        qh, oh, doh = grouped(q, s0, s1), grouped(out, s0, s1), grouped(dout, s0, s1)
        kh = k[:, :end].float().transpose(1, 2)  # (B, KV, end, hd)
        vh = v[:, :end].float().transpose(1, 2)
        s = (qh @ kh.transpose(-1, -2)) / root  # (B, KV, g * c, end)
        if causal:
            rows = (s0 + torch.arange(c, device=q.device)).repeat(g)
            s = torch.where(torch.arange(end, device=q.device)[None, :] <= rows[:, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        dv[:, :, :end] += p.transpose(-1, -2) @ doh
        ds = doh @ vh.transpose(-1, -2)  # dP
        ds = p.mul_(ds.sub_((doh * oh).sum(-1, keepdim=True)))  # P o (dP - rowsum(dO o O)), in P's buffer
        dq[:, s0:s1] = ((ds @ kh) / root).reshape(B, KV, g, c, hd).permute(0, 3, 1, 2, 4).reshape(B, c, H, hd)
        dk[:, :, :end] += (ds.transpose(-1, -2) @ qh) / root
    return dq, dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    """One launch of the kernel on contiguous CUDA tensors."""
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
