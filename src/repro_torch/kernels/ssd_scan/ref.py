"""Plain PyTorch version of a Mamba2 layer's prefill scan
(``csrc/ssd_scan.cu``; the JAX package has no such kernel): the chunked
SSD (``models/mamba2.py::ssd_chunked``) from a zero state, plus D x.

Shapes: ``xbc`` (B, S, H x P + 2 x G x N), the conv's output laid out
[x | B | C]; ``dt`` (B, S, H) fp32 after the softplus; ``loga`` (B, S, H)
fp32, the per-token log decay dt x -exp(A_log); ``D`` (H,). Returns y (B, S,
H x P) fp32 and the state at the sequence's end (B, H, P, N) fp32. Head h
reads B and C of group h // (H / G).
"""
from __future__ import annotations

import torch

from repro_torch.models.mamba2 import ssd_chunked


def ssd_scan_ref(xbc, dt, loga, D, *, heads: int, groups: int, state_dim: int, chunk: int):
    B, S, _ = xbc.shape
    H, G, N = heads, groups, state_dim
    inner = xbc.shape[-1] - 2 * G * N
    x = xbc[..., :inner].reshape(B, S, H, inner // H).float()
    Bm = xbc[..., inner:inner + G * N].reshape(B, S, G, N).float()
    Cm = xbc[..., inner + G * N:].reshape(B, S, G, N).float()
    state0 = torch.zeros((B, H, inner // H, N), dtype=torch.float32, device=xbc.device)
    y, state = ssd_chunked(x, dt, loga, Bm, Cm, state0, chunk)
    return (y + D.float()[:, None] * x).reshape(B, S, inner), state
