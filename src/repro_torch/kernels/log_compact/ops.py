"""Write-log compaction: wrappers of ``csrc/log_compact.cu``.

Replaces ``src/repro/kernels/log_compact/kernel.py::log_compact_pallas``.
One kernel, two entry points:

  log_compact       — one pool, (F, 3) targets (request, logical page,
                      slot): the Pallas kernel's counterpart.
  log_compact_tiers — both tiers in one launch, (F, 4) targets (request,
                      logical page, fast slot or -1, host slot or -1): each
                      matched log row is read once and stored into every
                      pool that holds its page. The decode path's compaction.

Bound on the card: bytes (the matched log rows, read once and written once
per pool). Both count their launches in ``log_compact.launches``. Shapes,
dtypes and contiguity are checked once per (shapes, strides, dtypes,
device) key, the bases' alignment on every call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.log_compact.ref import log_compact_ref, log_compact_tiers_ref

_ARGS = [_build.P] * 8 + [_build.I] * 7 + [_build.P]
_THREADS, _SMEM_MAX = 128, 227 * 1024


def _smem_bytes(page: int, S: int, row_bytes: int) -> int:
    """A block's shared memory (``lc_smem`` in the source): the page's rows,
    the meta rows, the partial scans and the newest slot of each offset."""
    parts = _THREADS // page if page < _THREADS else 1
    return page * row_bytes + S * 8 + parts * page * 4 + page * 4


def _compact(a_k, a_v, b_k, b_v, log_k, log_v, log_meta, targets) -> None:
    """One launch; pool B (``b_k``, ``b_v``) absent: (F, 3) targets into pool A."""
    L, PA, page, KV, hd = a_k.shape
    PB = 0 if b_k is None else b_k.shape[1]
    S, F = log_k.shape[1], targets.shape[0]
    row_bytes = KV * hd * a_k.element_size()

    def check():
        dt = a_k.dtype
        checks = [
            ("pages", a_k, (L, PA, page, KV, hd), dt), ("v_pages", a_v, (L, PA, page, KV, hd), dt),
            ("log_k", log_k, (L, S, KV, hd), dt), ("log_v", log_v, (L, S, KV, hd), dt),
            ("log_meta", log_meta, (S, 2), torch.int32),
            ("targets", targets, (F, 3 if b_k is None else 4), torch.int32),
        ]
        if b_k is not None:
            checks += [("host_k", b_k, (L, PB, page, KV, hd), dt), ("host_v", b_v, (L, PB, page, KV, hd), dt)]
        _build.expect("log_compact", a_k.device, *checks)
        if row_bytes % 16:
            raise ValueError("log_compact copies 16-byte vectors: rows must be a multiple of 16 bytes")
        if _smem_bytes(page, S, row_bytes) > _SMEM_MAX:
            raise ValueError(f"log_compact: a page of {page} rows of {row_bytes} bytes and {S} log slots "
                             f"need more than {_SMEM_MAX} bytes of shared memory")

    _build.validate_once("log_compact", (a_k, a_v, b_k, b_v, log_k, log_v, log_meta, targets), check)
    if F == 0:
        return
    addr = a_k.data_ptr() | a_v.data_ptr() | log_k.data_ptr() | log_v.data_ptr() | log_meta.data_ptr()
    if b_k is not None:
        addr |= b_k.data_ptr() | b_v.data_ptr()
    if addr % 16:
        raise ValueError("log_compact copies 16-byte vectors: pools, log and meta must be 16-byte aligned")
    err = _build.function("repro_log_compact", _ARGS)(
        a_k.data_ptr(), a_v.data_ptr(), None if b_k is None else b_k.data_ptr(),
        None if b_v is None else b_v.data_ptr(), log_k.data_ptr(), log_v.data_ptr(), log_meta.data_ptr(),
        targets.data_ptr(), L, PA, PB, page, S, F, row_bytes, _build.stream(a_k.device),
    )
    _build.check(err, "log_compact kernel")
    log_compact.launches += 1


def log_compact(k_pages, v_pages, log_k, log_v, log_meta, flush_targets) -> None:
    """Coalesce the log into one page pool, in place (see ``ref.py``)."""
    if _build.plain(k_pages, "log_compact"):
        return log_compact_ref(k_pages, v_pages, log_k, log_v, log_meta, flush_targets)
    return _compact(k_pages, v_pages, None, None, log_k, log_v, log_meta, flush_targets)


def log_compact_tiers(fast_k, fast_v, host_k, host_v, log_k, log_v, log_meta, targets) -> None:
    """Coalesce the log into both tiers in one pass, in place. targets:
    (F, 4) int32 (request, logical page, fast slot or -1, host slot or -1);
    the slots of each tier distinct across rows."""
    if _build.plain(fast_k, "log_compact_tiers"):
        return log_compact_tiers_ref(fast_k, fast_v, host_k, host_v, log_k, log_v, log_meta, targets)
    return _compact(fast_k, fast_v, host_k, host_v, log_k, log_v, log_meta, targets)


log_compact.launches = 0
