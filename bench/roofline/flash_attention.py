"""Least time of one causal flash attention call of a prefill
(``csrc/flash_attention.cu``): one layer of one batch-1 prompt of S tokens.

Bytes: q, k, v in and the output out, once. FLOPs: q.k and w.v over the
causal triangle, S (S + 1) / 2 pairs a head, 4 x hd a pair."""
from __future__ import annotations

from typing import Tuple

KERNELS = ("flash_attention_wgmma_kernel", "flash_attention_kernel")


def bytes_flops(model: dict, S: int, elem: int = 2) -> Tuple[float, float]:
    H, KV, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    nbytes = S * (2 * H + 2 * KV) * hd * elem
    flops = 4 * hd * H * S * (S + 1) / 2
    return float(nbytes), float(flops)
