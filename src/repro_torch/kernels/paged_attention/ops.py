"""Paged decode attention (+ write-log merge): wrapper of ``csrc/paged_attention.cu``.

Replaces ``src/repro/kernels/paged_attention/kernel.py::paged_decode_attention_pallas``.
Bound on the card: bytes — every valid K/V byte of the pages is read once.
The kernel gives one block to each (row, KV head), visits only resident
pages below the compaction watermark, and reuses each K/V tile for the g
query heads of its KV head; see the source for the rest.

As in the JAX ``ops.py``, the kernel covers the page pool and the (small)
write log is attended by plain tensor code, merged by the flash-decoding
(m, l) combine. Runtime invariant (append-only KV): a logical position
lives in EITHER the log or a page (pages are valid only below
``page_lengths``, the compaction watermark), so the merge needs no
shadowing. On the CPU the whole function is the plain version (``ref.py``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import NEG_INF, paged_decode_attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 128
_SMEM_MAX = 227 * 1024


def paged_attention_pages(
    q: torch.Tensor,  # (B, H, hd)
    k_pages: torch.Tensor,  # (P, page, KV, hd)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, N) int32
    page_lengths: torch.Tensor,  # (B,) int32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA kernel: attention over the pages below ``page_lengths``.
    Returns (out (B, H, hd) normalised, m (B, KV, g, 1), l (B, KV, g, 1))."""
    B, H, hd = q.shape
    P, page, KV, _ = k_pages.shape
    N = page_table.shape[1]
    if q.device.type != "cuda" or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"paged_attention kernel takes CUDA f32/bf16 tensors, got {q.dtype} on {q.device}")
    for name, t, shape, dtype in (
        ("k_pages", k_pages, (P, page, KV, hd), q.dtype),
        ("v_pages", v_pages, (P, page, KV, hd), q.dtype),
        ("page_table", page_table, (B, N), torch.int32),
        ("page_lengths", page_lengths, (B,), torch.int32),
    ):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} {t.device}, want {shape} {dtype} {q.device}")
    for t in (q, k_pages, v_pages, page_table, page_lengths):
        if not t.is_contiguous():
            raise ValueError("paged_attention takes contiguous tensors")
    g = H // KV
    if H % KV or g > 8 or hd > 2 * _THREADS or (hd * q.element_size()) % 16:
        raise ValueError(f"paged_attention: H={H} KV={KV} hd={hd} not supported")
    if any(t.data_ptr() % 16 for t in (k_pages, v_pages)):
        raise ValueError("paged_attention: page pools must be 16-byte aligned")
    tile_pages = max(1, 64 // page)  # about 64 tokens of K/V in shared memory
    tile = tile_pages * page
    smem = 4 * (g * hd + tile * (hd + 1) + tile * hd + g * tile + 3 * g + tile)
    if smem > _SMEM_MAX:
        raise ValueError(f"paged_attention: {smem} bytes of shared memory > {_SMEM_MAX}")
    out = torch.empty_like(q)
    m = torch.empty((B, KV, g, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    fn = _build.function("repro_paged_attention", [_build.P] * 8 + [_build.I] * 9 + [_build.P])
    err = fn(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages), _build.ptr(page_table),
        _build.ptr(page_lengths), _build.ptr(out), _build.ptr(m), _build.ptr(l),
        B, H, KV, hd, page, N, tile_pages, smem, _DTYPE_CODES[q.dtype], _build.stream(q.device),
    )
    _build.check(err, "paged_attention kernel")
    paged_attention_pages.launches += 1
    return out, m, l


paged_attention_pages.launches = 0


def _log_attention(q, log_k, log_v, log_meta, lengths, req_ids):
    """Attention over the write-log ring. Returns (out, m, l); out is
    UN-normalised (sum of p*v)."""
    B, H, hd = q.shape
    S, KV, _ = log_k.shape
    g = H // KV
    qg = q.reshape(B, KV, g, hd).float()
    scores = torch.einsum("bkgh,skh->bkgs", qg, log_k.float()) / math.sqrt(1.0 * hd)
    owner, lpos = log_meta[:, 0], log_meta[:, 1]
    valid = (owner[None] == req_ids[:, None]) & (owner[None] >= 0) & (req_ids[:, None] >= 0)
    valid = valid & (lpos[None] < lengths[:, None]) & (lpos[None] >= 0)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = torch.where(valid[:, None, None, :], p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,skh->bkgh", p, log_v.float())
    return out, m, l


def merge_log(q, out_p, m_p, l_p, log_k, log_v, log_meta, lengths, req_ids) -> torch.Tensor:
    """Flash-decoding combine of the pages' (normalised out, m, l) with the
    write-log pass (JAX ``ops.py:86-95``)."""
    B, H, hd = q.shape
    KV = log_k.shape[1]
    g = H // KV
    out_l, m_l, l_l = _log_attention(q, log_k, log_v, log_meta, lengths, req_ids)
    out_pg = out_p.reshape(B, KV, g, hd).float()
    m = torch.maximum(m_p, m_l)
    a_p = torch.exp(m_p - m) * l_p
    a_l = torch.exp(m_l - m)
    denom = torch.clamp(a_p + a_l * l_l, min=1e-30)
    out = (out_pg * a_p + out_l * a_l) / denom
    return out.reshape(B, H, hd).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    log_k: Optional[torch.Tensor] = None,
    log_v: Optional[torch.Tensor] = None,
    log_meta: Optional[torch.Tensor] = None,
    page_lengths: Optional[torch.Tensor] = None,
    req_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, H, hd) attention output over pages (+ log).

    ``page_lengths`` (default = lengths): per-request compaction watermark —
    page entries are valid only below it; positions at/above it live in the
    write log. ``req_ids`` (default arange(B)): the request each batch row
    serves — log entries are owned by request id, not batch position.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q, k_pages, v_pages, page_table, lengths, log_k, log_v, log_meta,
            page_lengths=page_lengths, req_ids=req_ids,
        )
    if page_lengths is None:
        page_lengths = lengths
    if req_ids is None:
        req_ids = torch.arange(q.shape[0], dtype=torch.int32, device=q.device)
    out_p, m_p, l_p = paged_attention_pages(q, k_pages, v_pages, page_table, page_lengths)
    if log_k is None:
        return out_p
    return merge_log(q, out_p, m_p, l_p, log_k, log_v, log_meta, lengths, req_ids)
