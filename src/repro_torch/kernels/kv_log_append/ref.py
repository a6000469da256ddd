"""Plain PyTorch version of the KV write-log append (port of
``repro/kernels/kv_log_append/ref.py``).

log_k/log_v: (L, S, KV, hd) ring buffers, log_meta: (S, 2) int32 rows
(request, abs_pos), tail: host int. Appends B tokens contiguously at the
tail. Updates the log IN PLACE (JAX returns new arrays) and returns the new
tail. The caller guarantees tail + B <= S (the engine compacts first).
"""
from __future__ import annotations

import torch


def kv_log_append_ref(
    log_k: torch.Tensor,  # (L, S, KV, hd)
    log_v: torch.Tensor,
    log_meta: torch.Tensor,  # (S, 2) int32
    tail: int,
    k_new: torch.Tensor,  # (L, B, KV, hd)
    v_new: torch.Tensor,
    req_ids: torch.Tensor,  # (B,) int32
    positions: torch.Tensor,  # (B,) int32
) -> int:
    B = k_new.shape[1]
    if not 0 <= tail <= log_k.shape[1] - B:
        raise ValueError(f"append of {B} rows at tail {tail} overflows {log_k.shape[1]} log slots")
    log_k[:, tail:tail + B] = k_new
    log_v[:, tail:tail + B] = v_new
    log_meta[tail:tail + B] = torch.stack([req_ids, positions], dim=-1).to(log_meta.dtype)
    return tail + B
