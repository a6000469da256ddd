"""KV write-log append (decode write path): wrapper of ``csrc/kv_log_append.cu``.

Replaces ``src/repro/kernels/kv_log_append/kernel.py::kv_log_append_pallas``.
Bound on the card: bytes (the B new rows, read and written once per layer);
the kernel is one 16-byte-copy block per (row, layer) and touches nothing
else of the log. In place; returns the new tail.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kv_log_append.ref import kv_log_append_ref


def kv_log_append(log_k, log_v, log_meta, tail: int, k_new, v_new, req_ids, positions) -> int:
    """Append B tokens' K/V (all L layers of ``k_new``) at ``tail``; write
    their (request, position) meta rows. Returns ``tail + B``."""
    if log_k.device.type == "cpu":
        return kv_log_append_ref(log_k, log_v, log_meta, tail, k_new, v_new, req_ids, positions)
    L, S, KV, hd = log_k.shape
    B = k_new.shape[1]
    row_bytes = KV * hd * log_k.element_size()
    if not 0 <= tail <= S - B:
        raise ValueError(f"append of {B} rows at tail {tail} overflows {S} log slots")
    for name, t, shape, dtype in (
        ("log_v", log_v, (L, S, KV, hd), log_k.dtype),
        ("k_new", k_new, (L, B, KV, hd), log_k.dtype),
        ("v_new", v_new, (L, B, KV, hd), log_k.dtype),
        ("log_meta", log_meta, (S, 2), torch.int32),
        ("req_ids", req_ids, (B,), torch.int32),
        ("positions", positions, (B,), torch.int32),
    ):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != log_k.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} {t.device}, want {shape} {dtype} {log_k.device}")
    for t in (log_k, log_v, k_new, v_new, log_meta, req_ids, positions):
        if not t.is_contiguous():
            raise ValueError("kv_log_append takes contiguous tensors")
    if row_bytes % 16 or any(t.data_ptr() % 16 for t in (log_k, log_v, k_new, v_new)):
        raise ValueError("kv_log_append copies 16-byte vectors: rows and bases must be 16-byte aligned")
    fn = _build.function("repro_kv_log_append", [_build.P] * 7 + [_build.I] * 5 + [_build.P])
    err = fn(
        _build.ptr(log_k), _build.ptr(log_v), _build.ptr(log_meta), _build.ptr(k_new),
        _build.ptr(v_new), _build.ptr(req_ids), _build.ptr(positions),
        L, S, B, row_bytes, tail, _build.stream(log_k.device),
    )
    _build.check(err, "kv_log_append kernel")
    kv_log_append.launches += 1
    return tail + B


kv_log_append.launches = 0
