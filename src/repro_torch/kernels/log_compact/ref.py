"""Plain PyTorch versions of write-log compaction (port of
``repro/kernels/log_compact/ref.py``), into one pool and into both tiers.

For each flush target f (request r, logical page p, pool slot s), every log
entry whose (request, abs_pos // page_size) matches (r, p) is written into
page-pool slot s at offset abs_pos % page_size; later log slots win. Rows
with r < 0 or s < 0 write nothing (the Pallas kernel's valid-slot scatter,
kernel.py:109-118; the JAX oracle differs only for r >= 0 with s < 0, which
the engine never builds). PRECONDITION (engine-guaranteed): rows reference
distinct (request, logical_page) pairs and distinct pool slots.
Updates the pools IN PLACE (JAX returns new arrays).
"""
from __future__ import annotations

import torch


def log_compact_ref(
    k_pages: torch.Tensor,  # (L, P, page, KV, hd)
    v_pages: torch.Tensor,
    log_k: torch.Tensor,  # (L, S, KV, hd)
    log_v: torch.Tensor,
    log_meta: torch.Tensor,  # (S, 2)
    flush_targets: torch.Tensor,  # (F, 3)
) -> None:
    page = k_pages.shape[2]
    S = log_k.shape[1]
    owner, lpos = log_meta[:, 0], log_meta[:, 1]
    offsets = torch.arange(page, device=log_meta.device)
    slots = torch.arange(S, device=log_meta.device)
    for r, logical, slot in flush_targets.tolist():
        if r < 0 or slot < 0:
            continue
        match = (owner == r) & (lpos >= 0) & (torch.div(lpos, page, rounding_mode="floor") == logical)
        # the last matching log slot of each in-page offset wins
        hit = match[None, :] & (lpos[None, :] % page == offsets[:, None])  # (page, S)
        last = torch.where(hit, slots[None, :], -1).amax(dim=1)  # (page,)
        offs = torch.nonzero(last >= 0).flatten()
        src = last[offs]
        k_pages[:, slot, offs] = log_k[:, src].to(k_pages.dtype)
        v_pages[:, slot, offs] = log_v[:, src].to(v_pages.dtype)


def log_compact_tiers_ref(
    fast_k: torch.Tensor,  # (L, P_fast, page, KV, hd)
    fast_v: torch.Tensor,
    host_k: torch.Tensor,  # (L, P_host, page, KV, hd)
    host_v: torch.Tensor,
    log_k: torch.Tensor,  # (L, S, KV, hd)
    log_v: torch.Tensor,
    log_meta: torch.Tensor,  # (S, 2)
    targets: torch.Tensor,  # (F, 4): request, logical page, fast slot, host slot
) -> None:
    """Compaction into both tiers: ``log_compact_ref`` into the fast pool
    with columns (0, 1, 2) and into the host pool with columns (0, 1, 3); a
    slot of -1 leaves that tier's copy of the page alone."""
    log_compact_ref(fast_k, fast_v, log_k, log_v, log_meta, targets[:, [0, 1, 2]])
    log_compact_ref(host_k, host_v, log_k, log_v, log_meta, targets[:, [0, 1, 3]])
