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
