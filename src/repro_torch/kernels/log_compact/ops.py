"""Write-log compaction: wrapper of ``csrc/log_compact.cu``.

Replaces ``src/repro/kernels/log_compact/kernel.py::log_compact_pallas``.
Bound on the card: bytes (only the matched log rows are read and written);
one block per (flush target, layer), each in-page offset owned by one thread
that picks the last matching log slot, then 16-byte copies in place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.log_compact.ref import log_compact_ref


def log_compact(k_pages, v_pages, log_k, log_v, log_meta, flush_targets) -> None:
    """Coalesce the log into the page pool, in place (see ``ref.py``)."""
    if k_pages.device.type == "cpu":
        return log_compact_ref(k_pages, v_pages, log_k, log_v, log_meta, flush_targets)
    L, P, page, KV, hd = k_pages.shape
    S = log_k.shape[1]
    F = flush_targets.shape[0]
    row_bytes = KV * hd * k_pages.element_size()
    for name, t, shape, dtype in (
        ("v_pages", v_pages, (L, P, page, KV, hd), k_pages.dtype),
        ("log_k", log_k, (L, S, KV, hd), k_pages.dtype),
        ("log_v", log_v, (L, S, KV, hd), k_pages.dtype),
        ("log_meta", log_meta, (S, 2), torch.int32),
        ("flush_targets", flush_targets, (F, 3), torch.int32),
    ):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != k_pages.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} {t.device}, want {shape} {dtype} {k_pages.device}")
    for t in (k_pages, v_pages, log_k, log_v, log_meta, flush_targets):
        if not t.is_contiguous():
            raise ValueError("log_compact takes contiguous tensors")
    if F == 0:
        return None
    if row_bytes % 16 or any(t.data_ptr() % 16 for t in (k_pages, v_pages, log_k, log_v)):
        raise ValueError("log_compact copies 16-byte vectors: rows and bases must be 16-byte aligned")
    fn = _build.function("repro_log_compact", [_build.P] * 6 + [_build.I] * 6 + [_build.P])
    err = fn(
        _build.ptr(k_pages), _build.ptr(v_pages), _build.ptr(log_k), _build.ptr(log_v),
        _build.ptr(log_meta), _build.ptr(flush_targets),
        L, P, page, S, F, row_bytes, _build.stream(k_pages.device),
    )
    _build.check(err, "log_compact kernel")
    log_compact.launches += 1
    return None


log_compact.launches = 0
