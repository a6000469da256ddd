"""Paged decode attention with the write log: wrapper of ``csrc/paged_attention.cu``.

Replaces ``src/repro/kernels/paged_attention/kernel.py::paged_decode_attention_pallas``
and the jnp write-log pass and combine around it (JAX ``ops.py``). Bound on
the card: bytes — every valid K/V byte of the pages and the log is read once.

One call is two launches and no other device op: a page pass over
(row, KV head, split) blocks, each a run of ``pages_per_split`` whole pages
(``split_plan`` picks it so that the grid covers the card about twice),
then a combine that attends the write log and merges every split and the
log by the flash-decoding (m, l) combine. Runtime invariant (append-only
KV): a logical position lives in EITHER the log or a page (pages are valid
only below ``page_lengths``, the compaction watermark), so nothing is
shadowed. On the CPU the whole function is the plain version (``ref.py``);
``ref.paged_decode_attention_split_ref`` is the plain version of the
kernels' split-and-combine algorithm.

``paged_decode_attention.launches`` counts calls of the op (each is the two
launches); ``paged_attention_pages`` counts there too.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_MAX = 227 * 1024
_TOKENS_PER_SPLIT = 32  # 2 pages of 16 at full width: 640 blocks
_THREADS = 256
_ARGS = [_build.P] * 14 + [_build.I] * 12 + [_build.P]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(B: int, KV: int, N: int, page: int, sms: int) -> Tuple[int, int]:
    """(pages a split, splits a row): about 32 tokens a split, halved until
    B x KV x n_split covers ``sms`` SMs at least twice (or one page a split)."""
    pps = max(1, min(N, _TOKENS_PER_SPLIT // page))
    while pps > 1 and B * KV * -(-N // pps) < 2 * sms:
        pps //= 2
    return pps, -(-N // pps)


def _paged_attention_cuda(
    q, k_pages, v_pages, page_table, page_lengths,
    log_k=None, log_v=None, log_meta=None, lengths=None, req_ids=None,
    *, pages_per_split: Optional[int] = None,
) -> torch.Tensor:
    """Both launches; ``log_k is None``: pages only. Returns (B, H, hd) in q's dtype."""
    B, H, hd = q.shape
    P, page, KV, _ = k_pages.shape
    N = page_table.shape[1]
    if q.device.type != "cuda" or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"paged_attention kernel takes CUDA f32/bf16 tensors, got {q.dtype} on {q.device}")
    checks = [
        ("k_pages", k_pages, (P, page, KV, hd), q.dtype),
        ("v_pages", v_pages, (P, page, KV, hd), q.dtype),
        ("page_table", page_table, (B, N), torch.int32),
        ("page_lengths", page_lengths, (B,), torch.int32),
    ]
    S_log = 0
    if log_k is not None:
        S_log = log_k.shape[0]
        checks += [
            ("log_k", log_k, (S_log, KV, hd), q.dtype),
            ("log_v", log_v, (S_log, KV, hd), q.dtype),
            ("log_meta", log_meta, (S_log, 2), torch.int32),
            ("lengths", lengths, (B,), torch.int32),
        ]
    if req_ids is not None:
        checks.append(("req_ids", req_ids, (B,), torch.int32))
    for name, t, shape, dtype in checks:
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} {t.device}, want {shape} {dtype} {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("paged_attention: q must be contiguous")
    g = H // KV
    if H % KV or g > 8 or hd > 256 or (hd * q.element_size()) % 16:
        raise ValueError(f"paged_attention: H={H} KV={KV} hd={hd} not supported")
    if any(t.data_ptr() % 16 for t in (k_pages, v_pages, log_k, log_v) if t is not None):
        raise ValueError("paged_attention: page pools and log must be 16-byte aligned")
    if pages_per_split is None:
        pps, n_split = split_plan(B, KV, N, page, _sm_count(q.device.index or 0))
    else:
        pps, n_split = pages_per_split, -(-N // pages_per_split)
    tile, es = pps * page, q.element_size()
    red = max(1, _THREADS // (hd // 2)) * g * hd  # floats of the token-group reduction
    smem_split = 2 * tile * hd * es + 4 * (g * hd + g * tile + 2 * g + red + pps + tile)
    smem_combine = 2 * S_log * hd * es + 4 * (2 * g * hd + g * S_log + g * n_split + 4 * g + red + S_log + 1)
    if max(smem_split, smem_combine) > _SMEM_MAX:
        raise ValueError(f"paged_attention: {max(smem_split, smem_combine)} bytes of shared memory > {_SMEM_MAX}")
    parts = n_split * g
    scratch = torch.empty(B * KV * parts * (hd + 2), dtype=torch.float32, device=q.device)
    acc, m, l = scratch.split([B * KV * parts * hd, B * KV * parts, B * KV * parts])
    out = torch.empty_like(q)

    def opt(t):  # NULL for an absent log or req_ids
        return None if t is None else _build.ptr(t)

    err = _build.function("repro_paged_attention", _ARGS)(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages), _build.ptr(page_table),
        _build.ptr(page_lengths), opt(log_k), opt(log_v), opt(log_meta), opt(lengths), opt(req_ids),
        _build.ptr(acc), _build.ptr(m), _build.ptr(l), _build.ptr(out),
        B, H, KV, hd, page, N, pps, n_split, S_log, smem_split, smem_combine, _DTYPE_CODES[q.dtype],
        _build.stream(q.device),
    )
    _build.check(err, "paged_attention kernels")
    paged_decode_attention.launches += 1
    return out


def paged_attention_pages(
    q: torch.Tensor,  # (B, H, hd)
    k_pages: torch.Tensor,  # (P, page, KV, hd)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, N) int32
    page_lengths: torch.Tensor,  # (B,) int32
) -> torch.Tensor:
    """The kernels without the write log: attention over the pages below
    ``page_lengths`` (page pass + combine). Returns (B, H, hd), normalised."""
    return _paged_attention_cuda(q, k_pages, v_pages, page_table, page_lengths)


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
    write log. ``req_ids`` (default: row b serves request b): the request
    each batch row serves — log entries are owned by request id, not batch
    position.
    """
    if _build.plain(q, "paged_decode_attention"):
        return paged_decode_attention_ref(
            q, k_pages, v_pages, page_table, lengths, log_k, log_v, log_meta,
            page_lengths=page_lengths, req_ids=req_ids,
        )
    return _paged_attention_cuda(
        q, k_pages, v_pages, page_table, lengths if page_lengths is None else page_lengths,
        log_k, log_v, log_meta, lengths if log_k is not None else None, req_ids,
    )


paged_decode_attention.launches = 0
