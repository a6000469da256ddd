"""Least time of one paged decode attention call (``csrc/paged_attention.cu``,
kernels ``paged_split_kernel`` + ``paged_combine_kernel``): one layer of one
decode step.

Bytes each live row needs, each read once: its K and V at every position it
attends (pages below the compaction watermark, the write log above it), its
page-table entries, q in and the output out; the log's meta rows once a
call. FLOPs: 4 x H x hd a position (q.k and w.v)."""
from __future__ import annotations

from typing import Sequence, Tuple

KERNELS = ("paged_split_kernel", "paged_combine_kernel")


def bytes_flops(model: dict, rows: Sequence[Tuple[int, int]], log_rows: int, page_size: int,
                elem: int = 2) -> Tuple[float, float]:
    """``rows``: (positions attended, positions in pages) of each live row;
    ``log_rows``: rows of the log the call scans."""
    H, KV, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    kv = sum(ctx for ctx, _ in rows) * 2 * KV * hd * elem
    table = sum(-(-paged // page_size) for _, paged in rows) * 4
    qo = len(rows) * 2 * H * hd * elem
    meta = log_rows * 2 * 4
    flops = sum(ctx for ctx, _ in rows) * 4 * H * hd
    return float(kv + table + qo + meta), float(flops)
