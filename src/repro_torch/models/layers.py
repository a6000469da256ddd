"""Shared transformer building blocks (port of ``repro/models/layers.py``).

Plain functions on tensors, following the JAX arithmetic recipes: rmsnorm in
fp32, rope in fp32, and decode attention's value contraction with the
softmax weights rounded to the cache dtype first. ``shard_hint`` and
``use_weight`` are gone: they do nothing without a mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.configs import ModelConfig

NEG_INF = -1e30  # finite mask value: -inf - -inf would be NaN


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    ang = positions.float()[..., None] * freqs  # (..., S, hd/2)
    ang = ang[..., None, :]  # (..., S, 1, hd/2) — broadcast over heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class AttnParams:
    """View over one layer's attention weights (already layer-sliced)."""

    wq: torch.Tensor  # (d, H*hd)
    wk: torch.Tensor  # (d, KV*hd)
    wv: torch.Tensor  # (d, KV*hd)
    wo: torch.Tensor  # (H*hd, d)
    bq: Optional[torch.Tensor] = None
    bk: Optional[torch.Tensor] = None
    bv: Optional[torch.Tensor] = None
    q_norm: Optional[torch.Tensor] = None  # (hd,) qk-norm gains
    k_norm: Optional[torch.Tensor] = None


def project_qkv(
    cfg: ModelConfig, p: AttnParams, x: torch.Tensor, positions: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> q: (B, S, H, hd), k/v: (B, S, KV, hd)."""
    return qkv_epilogue(cfg, p, x @ p.wq, x @ p.wk, x @ p.wv, positions)


def qkv_epilogue(
    cfg: ModelConfig, p: AttnParams, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    positions: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What ``project_qkv`` does after the three matmuls: bias, qk-norm and
    RoPE. q: (B, S, H*hd), k/v: (B, S, KV*hd) -> (B, S, heads, hd) each."""
    B, S, _ = q.shape
    hd = cfg.resolved_head_dim
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if p.q_norm is not None:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, S_max, KV, hd)
    v_cache: torch.Tensor,
    length: int,  # valid prefix length (uniform across batch)
) -> torch.Tensor:
    """Single-token attention against a dense KV cache."""
    B, _, H, hd = q.shape
    S_max, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    qg = q.reshape(B, KV, g, hd)
    # scores are formed in the cache dtype, then widened (JAX's recipe)
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k_cache).float()
    scores = scores / torch.tensor(math.sqrt(hd), dtype=torch.float32)
    valid = torch.arange(S_max, device=q.device)[None, :] < length  # (1, S)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    # the weights are rounded to the cache dtype before w·v: the tiered
    # engine's paged path shares this recipe so greedy tokens agree
    out = torch.einsum("bkgs,bskh->bkgh", w.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, hd)
