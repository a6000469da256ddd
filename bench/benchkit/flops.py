"""The card's peaks, and the model FLOPs of a decoder (the decoder family's
count, ``families/decoder.py``) from the configuration's sizes: 2 x the
matmul parameters a token touches (attention projections, the FFN or the k
experts and the router a token is routed through, the logits) plus
attention's 4 x H x hd x context a layer (q.k and w.v, 2 FLOPs a
multiply-add)."""
from __future__ import annotations

from typing import Iterable

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 (NVIDIA's data sheet)
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s


def matmul_params_per_token(model: dict) -> int:
    d, L, V = model["d_model"], model["n_layers"], model["vocab"]
    H, KV, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    attn = d * H * hd + 2 * d * KV * hd + H * hd * d
    moe = model.get("moe")
    if moe:
        ffn = d * moe["num_experts"] + moe["top_k"] * 3 * d * moe["d_ff_expert"]
    else:
        ffn = 3 * d * model["d_ff"]
    return L * (attn + ffn) + d * V


def decode_flops(model: dict, contexts: Iterable[int]) -> float:
    """One decode step: a row per context (the positions it attends,
    its new token included)."""
    per_token = 2 * matmul_params_per_token(model)
    attn = 4 * model["n_layers"] * model["n_heads"] * model["head_dim"]
    return float(sum(per_token + attn * c for c in contexts))
