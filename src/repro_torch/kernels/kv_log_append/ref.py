"""Plain PyTorch versions of the KV write-log append (port of
``repro/kernels/kv_log_append/ref.py``) and of the decode step's K/V
epilogue fused with it (``qkv_log_append_ref``).

log_k/log_v: (L, S, KV, hd) ring buffers, log_meta: (S, 2) int32 rows
(request, abs_pos), tail: host int. Appends B tokens contiguously at the
tail. Updates the log IN PLACE (JAX returns new arrays) and returns the new
tail. The caller guarantees tail + B <= S (the engine compacts first).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models.layers import AttnParams, qkv_epilogue


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


def qkv_log_append_ref(
    cfg: ModelConfig,
    p: AttnParams,
    q: torch.Tensor,  # (B, 1, H*hd) raw projections x @ wq
    k: torch.Tensor,  # (B, 1, KV*hd)
    v: torch.Tensor,
    positions: torch.Tensor,  # (B,) int32 RoPE positions
    log_k: torch.Tensor,  # (S, KV, hd): one layer of the log
    log_v: torch.Tensor,
    log_meta: torch.Tensor,  # (S, 2) int32
    tail: int,
    req_ids: torch.Tensor,  # (B,) int32
    meta_positions: torch.Tensor,  # (B,) int32
) -> Tuple[torch.Tensor, int]:
    """The decode step's K/V epilogue and append, op by op: ``project_qkv``'s
    bias, qk-norm and RoPE (``qkv_epilogue``), then ``kv_log_append_ref`` of
    this layer's k and v rows. Returns (q (B, H, hd), tail + B)."""
    q, k, v = qkv_epilogue(cfg, p, q, k, v, positions[:, None])
    tail = kv_log_append_ref(
        log_k[None], log_v[None], log_meta, tail,
        k[None, :, 0].to(log_k.dtype), v[None, :, 0].to(log_v.dtype), req_ids, meta_positions,
    )
    return q[:, 0].contiguous(), tail
