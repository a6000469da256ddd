"""Plain PyTorch version of causal (or full) GQA attention (port of
``repro/kernels/flash_attention/ref.py``): fp32 scores, softmax and value
contraction, output in the input dtype."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S_kv, KV, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
) -> torch.Tensor:
    B, S, H, hd = q.shape
    S_kv, KV = k.shape[1], k.shape[2]
    g = H // KV
    qg = q.reshape(B, S, KV, g, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) / math.sqrt(hd)
    if causal:
        mask = torch.arange(S_kv, device=q.device)[None, :] <= torch.arange(S, device=q.device)[:, None]
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)
