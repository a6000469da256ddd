"""KV write-log append (decode write path): wrappers of ``csrc/kv_log_append.cu``.

Replaces ``src/repro/kernels/kv_log_append/kernel.py::kv_log_append_pallas``.
One kernel, two entry points:

  kv_log_append  — the standalone append (the Pallas kernel's counterpart):
                   copy B new K/V rows of every layer to the tail of the log
                   ring, bit for bit, and write their meta rows.
  qkv_log_append — the decode step's K/V epilogue fused into the append:
                   from the raw projections x @ wq, x @ wk, x @ wv of one
                   layer, add the bias, apply qk-norm and RoPE, return q as
                   (B, H, hd) and store the finished k and v rows in the log.

Both count their launches in ``kv_log_append.launches``. Shapes, dtypes and
contiguity are checked once per (shapes, strides, dtypes, device) key; the
log tail on every call, and for the standalone append (16-byte copies) the
alignment of the bases. In place; both return the new tail.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.kernels import _build
from repro_torch.kernels.kv_log_append.ref import kv_log_append_ref, qkv_log_append_ref
from repro_torch.models.layers import AttnParams, rope_freqs

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [_build.P] * 16 + [_build.I] * 8 + [_build.F32, _build.P]
# head dims of the fused epilogue: min(hd, 32) lanes a head row, hd / lanes
# in {1, 2, 4} elements a lane, in the order torch's CUDA reduction sums them;
# 224 (7 a lane) without qk-norm, whose sum the kernel does not order there
_HEAD_DIMS = (8, 16, 32, 64, 128, 224)
_NORM_HEAD_DIMS = (8, 16, 32, 64, 128)


@functools.lru_cache(maxsize=None)
def cached_rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_freqs`` computed once per (head dim, theta, device)."""
    return rope_freqs(head_dim, theta, device=device)


def _overflow(tail: int, B: int, S: int) -> None:
    if not 0 <= tail <= S - B:
        raise ValueError(f"append of {B} rows at tail {tail} overflows {S} log slots")


def _launch(log_k, log_v, log_meta, q_out, q, k, v, bq, bk, bv, q_gain, k_gain, freqs,
            positions, req_ids, meta_pos, L, S, B, nq, nkv, seg, tail, eps) -> None:
    def ptr(t):  # NULL for an absent tensor
        return None if t is None else t.data_ptr()

    err = _build.function("repro_kv_log_append", _ARGS)(
        ptr(log_k), ptr(log_v), ptr(log_meta), ptr(q_out), ptr(q), ptr(k), ptr(v), ptr(bq), ptr(bk),
        ptr(bv), ptr(q_gain), ptr(k_gain), ptr(freqs), ptr(positions), ptr(req_ids), ptr(meta_pos),
        _DTYPE_CODES[log_k.dtype], L, S, B, nq, nkv, seg, tail, eps, _build.stream(log_k.device),
    )
    _build.check(err, "kv_log_append kernel")
    kv_log_append.launches += 1


def kv_log_append(log_k, log_v, log_meta, tail: int, k_new, v_new, req_ids, positions) -> int:
    """Append B tokens' K/V (all L layers of ``k_new``) at ``tail``; write
    their (request, position) meta rows. Returns ``tail + B``."""
    if _build.plain(log_k, "kv_log_append"):
        return kv_log_append_ref(log_k, log_v, log_meta, tail, k_new, v_new, req_ids, positions)
    L, S, KV, hd = log_k.shape
    B = k_new.shape[1]
    _overflow(tail, B, S)

    def check():
        if log_k.dtype not in _DTYPE_CODES:
            raise ValueError(f"kv_log_append takes f32/bf16 logs, got {log_k.dtype}")
        dt = log_k.dtype
        _build.expect(
            "kv_log_append", log_k.device, ("log_k", log_k, (L, S, KV, hd), dt), ("log_v", log_v, (L, S, KV, hd), dt),
            ("k_new", k_new, (L, B, KV, hd), dt), ("v_new", v_new, (L, B, KV, hd), dt),
            ("log_meta", log_meta, (S, 2), torch.int32), ("req_ids", req_ids, (B,), torch.int32),
            ("positions", positions, (B,), torch.int32),
        )
        if (KV * hd * log_k.element_size()) % 16:
            raise ValueError("kv_log_append copies 16-byte vectors: rows must be a multiple of 16 bytes")

    _build.validate_once("kv_log_append", (log_k, log_v, log_meta, k_new, v_new, req_ids, positions), check)
    if (log_k.data_ptr() | log_v.data_ptr() | k_new.data_ptr() | v_new.data_ptr()) % 16:
        raise ValueError("kv_log_append copies 16-byte vectors: bases must be 16-byte aligned")
    _launch(log_k, log_v, log_meta, None, None, k_new, v_new, None, None, None, None, None, None,
            None, req_ids, positions, L, S, B, 0, 1, KV * hd, tail, 0.0)
    return tail + B


def qkv_log_append(
    cfg: ModelConfig, p: AttnParams, q, k, v, positions, log_k, log_v, log_meta, tail: int, req_ids,
    meta_positions,
) -> Tuple[torch.Tensor, int]:
    """One layer of the decode step from the q/k/v matmuls to the write log.

    q: (B, 1, H*hd), k/v: (B, 1, KV*hd) raw projections; positions (B,)
    int32 RoPE positions; log_k/log_v: this layer's (S, KV, hd) log;
    meta_positions (B,) int32 (-1 on padded rows, which are written too, so
    the tail advances by B). Returns (q (B, H, hd) ready for
    ``paged_decode_attention``, tail + B)."""
    if _build.plain(q, "qkv_log_append"):
        return qkv_log_append_ref(cfg, p, q, k, v, positions, log_k, log_v, log_meta, tail, req_ids, meta_positions)
    S, KV, hd = log_k.shape
    B, H = q.shape[0], cfg.n_heads
    _overflow(tail, B, S)
    opt = (p.bq, p.bk, p.bv, p.q_norm, p.k_norm)

    def check():
        dt = log_k.dtype
        if dt not in _DTYPE_CODES:
            raise ValueError(f"qkv_log_append takes f32/bf16 tensors, got {dt}")
        if (cfg.n_kv_heads, cfg.resolved_head_dim) != (KV, hd):
            raise ValueError(f"log of {KV} heads of {hd}, config {cfg.n_kv_heads} of {cfg.resolved_head_dim}")
        if hd not in _HEAD_DIMS:
            raise ValueError(f"qkv_log_append: head dim {hd} not in {_HEAD_DIMS}")
        checks = [
            ("q", q, (B, 1, H * hd), dt), ("k", k, (B, 1, KV * hd), dt), ("v", v, (B, 1, KV * hd), dt),
            ("log_k", log_k, (S, KV, hd), dt), ("log_v", log_v, (S, KV, hd), dt),
            ("log_meta", log_meta, (S, 2), torch.int32), ("positions", positions, (B,), torch.int32),
            ("req_ids", req_ids, (B,), torch.int32), ("meta_positions", meta_positions, (B,), torch.int32),
        ]
        if (p.bq is None) != (p.bk is None) or (p.bq is None) != (p.bv is None):
            raise ValueError("qkv_log_append: give all three biases or none")
        if (p.q_norm is None) != (p.k_norm is None):
            raise ValueError("qkv_log_append: give both qk-norm gains or neither")
        if p.q_norm is not None and hd not in _NORM_HEAD_DIMS:
            raise ValueError(f"qkv_log_append: qk-norm at head dim {hd} not in {_NORM_HEAD_DIMS}")
        if p.bq is not None:
            checks += [("bq", p.bq, (H * hd,), dt), ("bk", p.bk, (KV * hd,), dt), ("bv", p.bv, (KV * hd,), dt)]
        if p.q_norm is not None:
            checks += [("q_norm", p.q_norm, (hd,), dt), ("k_norm", p.k_norm, (hd,), dt)]
        _build.expect("qkv_log_append", log_k.device, *checks)

    _build.validate_once(
        ("qkv_log_append", H, KV, hd),
        (q, k, v, positions, log_k, log_v, log_meta, req_ids, meta_positions, *opt), check,
    )
    q_out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    freqs = cached_rope_freqs(hd, float(cfg.rope_theta), q.device)
    _launch(log_k, log_v, log_meta, q_out, q, k, v, *opt, freqs, positions, req_ids, meta_positions,
            1, S, B, H, KV, hd, tail, float(cfg.norm_eps))
    return q_out, tail + B


kv_log_append.launches = 0
