"""Plain PyTorch version of paged decode attention with write-log merge
(port of ``repro/kernels/paged_attention/ref.py``).

Semantics (one decode step, GQA):
  q:          (B, H, hd)
  k_pages:    (P, page, KV, hd)  page pool (shared across requests)
  v_pages:    (P, page, KV, hd)
  page_table: (B, N) int32 — pool slot of row b's n-th logical page; -1 =
              not resident (masked)
  lengths:    (B,) int32 — valid tokens per row
  log_k/v:    (S, KV, hd) — token-granular write log (ring)
  log_meta:   (S, 2) int32 — (request, abs_pos) per slot; request -1 = empty

A logical position covered by BOTH a page and a log entry takes the LOG
value. The value contraction follows ``layers.decode_attention`` to the
letter (weights rounded to the cache dtype first): the tiered engine's
greedy decode must be token-identical to dense decode on the CPU.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def paged_decode_attention_ref(
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
    B, H, hd = q.shape
    P, page, KV, _ = k_pages.shape
    N = page_table.shape[1]
    g = H // KV
    dev = q.device
    if page_lengths is None:
        page_lengths = lengths
    if req_ids is None:
        req_ids = torch.arange(B, dtype=torch.int32, device=dev)  # row b serves request b

    safe_table = page_table.clamp(min=0).long()
    k = k_pages[safe_table].reshape(B, N * page, KV, hd)
    v = v_pages[safe_table].reshape(B, N * page, KV, hd)
    pos = torch.arange(N * page, device=dev)[None]
    resident = (page_table >= 0).repeat_interleave(page, dim=1)  # (B, N*page)
    valid = (pos < page_lengths[:, None]) & resident

    if log_k is not None:
        S = log_k.shape[0]
        owner, lpos = log_meta[:, 0], log_meta[:, 1]
        match = (owner[None, :] == req_ids[:, None]) & (owner[None, :] >= 0) & (req_ids[:, None] >= 0)
        # page entries shadowed by a log entry of the same (request, position);
        # out-of-range positions land on a discarded sentinel column
        in_range = match & (lpos[None, :] >= 0) & (lpos[None, :] < N * page)
        idx = torch.where(in_range, lpos[None, :], N * page).long()  # (B, S)
        shadow = torch.zeros((B, N * page + 1), dtype=torch.bool, device=dev)
        shadow.scatter_(1, idx, True)
        valid = valid & ~shadow[:, :-1]
        log_valid = match & (lpos[None, :] < lengths[:, None]) & (lpos[None, :] >= 0)
        k = torch.cat([k, log_k[None].expand(B, S, KV, hd)], dim=1)
        v = torch.cat([v, log_v[None].expand(B, S, KV, hd)], dim=1)
        valid = torch.cat([valid, log_valid], dim=1)

    qg = q.reshape(B, KV, g, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k).float()
    scores = scores / torch.tensor(math.sqrt(hd), dtype=torch.float32)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", w.to(v.dtype), v)
    return out.reshape(B, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# The CUDA kernels' algorithm, written plainly: per-split partials over runs
# of whole pages, the write-log pass, and the flash-decoding combine, all in
# fp32 (the weights are NOT rounded to the cache dtype before p.v, as in the
# kernels and the Pallas kernel).
# ---------------------------------------------------------------------------


def paged_split_ref(q, k_pages, v_pages, page_table, page_lengths, pages_per_split: int):
    """Partials of each run of ``pages_per_split`` pages: un-normalised
    acc (B, KV, n_split, g, hd), and m, l (B, KV, n_split, g), fp32. A split
    with no valid key gives m = -1e30, l = 0, acc = 0."""
    B, H, hd = q.shape
    P, page, KV, _ = k_pages.shape
    N = page_table.shape[1]
    g = H // KV
    pps = pages_per_split
    n_split = -(-N // pps)
    table = torch.full((B, n_split * pps), -1, dtype=page_table.dtype, device=q.device)
    table[:, :N] = page_table
    T = pps * page
    safe = table.clamp(min=0).long()
    k = k_pages[safe].reshape(B, n_split, T, KV, hd).float()
    v = v_pages[safe].reshape(B, n_split, T, KV, hd).float()
    pos = torch.arange(n_split * T, device=q.device).reshape(n_split, T)
    resident = (table >= 0).repeat_interleave(page, dim=1).reshape(B, n_split, T)
    valid = (pos[None] < page_lengths[:, None, None]) & resident  # (B, n_split, T)
    qg = q.reshape(B, KV, g, hd).float()
    scores = torch.einsum("bkgh,bstkh->bksgt", qg, k) / math.sqrt(hd)
    mask = valid[:, None, :, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.where(mask, torch.exp(scores - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bksgt,bstkh->bksgh", p, v)
    return acc, m, l


def log_partial_ref(q, log_k, log_v, log_meta, lengths, req_ids=None):
    """The write-log pass as one more partial: acc (B, KV, 1, g, hd), m, l
    (B, KV, 1, g). Slot s counts for row b when its owner is the row's
    request (>= 0) and 0 <= position < lengths[b]."""
    B, H, hd = q.shape
    S, KV, _ = log_k.shape
    g = H // KV
    if req_ids is None:
        req_ids = torch.arange(B, dtype=torch.int32, device=q.device)
    owner, lpos = log_meta[:, 0], log_meta[:, 1]
    valid = (owner[None] == req_ids[:, None]) & (req_ids[:, None] >= 0)
    valid = valid & (lpos[None] >= 0) & (lpos[None] < lengths[:, None])  # (B, S)
    qg = q.reshape(B, KV, g, hd).float()
    scores = torch.einsum("bkgh,skh->bkgs", qg, log_k.float()) / math.sqrt(hd)
    mask = valid[:, None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.where(mask, torch.exp(scores - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgs,skh->bkgh", p, log_v.float())
    return acc[:, :, None], m[:, :, None], l[:, :, None]


def combine_ref(q, acc, m, l, log_k=None, log_v=None, log_meta=None, lengths=None, req_ids=None):
    """Flash-decoding combine of the partials (and the write log, if given),
    normalised by max(l, 1e-30), in q's dtype."""
    if log_k is not None:
        a_l, m_l, l_l = log_partial_ref(q, log_k, log_v, log_meta, lengths, req_ids)
        acc, m, l = torch.cat([acc, a_l], dim=2), torch.cat([m, m_l], dim=2), torch.cat([l, l_l], dim=2)
    M = m.amax(dim=2, keepdim=True)
    w = torch.exp(m - M)  # (B, KV, n, g)
    denom = torch.clamp((w * l).sum(dim=2), min=1e-30)
    out = (w[..., None] * acc).sum(dim=2) / denom[..., None]
    return out.reshape(q.shape).to(q.dtype)


def paged_decode_attention_split_ref(
    q, k_pages, v_pages, page_table, lengths, log_k=None, log_v=None, log_meta=None,
    page_lengths=None, req_ids=None, *, pages_per_split: int = 4,
):
    """What the CUDA kernels compute, split by split (same arguments as
    ``paged_decode_attention_ref``)."""
    if page_lengths is None:
        page_lengths = lengths
    acc, m, l = paged_split_ref(q, k_pages, v_pages, page_table, page_lengths, pages_per_split)
    return combine_ref(q, acc, m, l, log_k, log_v, log_meta, lengths, req_ids)
