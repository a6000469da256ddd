"""Decoder-only transformer, dense family (port of ``repro/models/dense.py``).

Parameters are the flat dict of ``models.common`` with stacked ``blocks.*``
entries; the forward pass is a Python loop over layers. Prefill attention
runs through the hand-written flash-attention kernel
(``repro_torch.kernels.flash_attention``) where JAX uses
``layers.chunked_attention``. The MoE and frontend branches belong to a later
slice of the port.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import Leaf, Params, layer_params, stacked
from repro_torch.models.layers import AttnParams, decode_attention, project_qkv, rmsnorm

_LATER = "ROADMAP.md §1 item 6 (MoE and VLM families through dense.py)"


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family == "moe" or cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is {_LATER}")
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not ported yet")


def schema(cfg: ModelConfig) -> Dict[str, Any]:
    _check_family(cfg)
    d, L = cfg.d_model, cfg.n_layers
    hd = cfg.resolved_head_dim
    H, KV, Ff, V = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab
    s: Dict[str, Any] = {
        "embed": Leaf((V, d), ("vocab", "embed"), scale=0.02),
        "final_norm": Leaf((d,), (None,), init="ones"),
        "blocks": {
            "attn_norm": stacked(L, (d,), (None,), init="ones"),
            "wq": stacked(L, (d, H * hd), ("embed", "heads")),
            "wk": stacked(L, (d, KV * hd), ("embed", "kv")),
            "wv": stacked(L, (d, KV * hd), ("embed", "kv")),
            "wo": stacked(L, (H * hd, d), ("heads", "embed")),
            "mlp_norm": stacked(L, (d,), (None,), init="ones"),
            "w_gate": stacked(L, (d, Ff), ("embed", "ffn")),
            "w_up": stacked(L, (d, Ff), ("embed", "ffn")),
            "w_down": stacked(L, (Ff, d), ("ffn", "embed")),
        },
    }
    b = s["blocks"]
    if cfg.qkv_bias:
        b["bq"] = stacked(L, (H * hd,), ("heads",), init="zeros")
        b["bk"] = stacked(L, (KV * hd,), ("kv",), init="zeros")
        b["bv"] = stacked(L, (KV * hd,), ("kv",), init="zeros")
    if cfg.qk_norm:
        b["q_norm"] = stacked(L, (hd,), (None,), init="ones")
        b["k_norm"] = stacked(L, (hd,), (None,), init="ones")
    if not cfg.tie_embeddings:
        s["lm_head"] = Leaf((d, V), ("embed", "vocab"), scale=0.02)
    return s


def _attn_params(cfg: ModelConfig, p: Params) -> AttnParams:
    return AttnParams(
        wq=p["wq"], wk=p["wk"], wv=p["wv"], wo=p["wo"],
        bq=p.get("bq"), bk=p.get("bk"), bv=p.get("bv"),
        q_norm=p.get("q_norm"), k_norm=p.get("k_norm"),
    )


def _ffn(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU (silu in fp32, as the JAX recipe)."""
    _check_family(cfg)
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p["w_down"]


def _block(
    cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer. Returns (x_out, k, v)."""
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = project_qkv(cfg, _attn_params(cfg, p), h, positions)
    o = flash_attention(q, k, v, causal=True)
    o = o.reshape(*o.shape[:2], -1)
    x = x + o @ p["wo"]
    h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    x = x + _ffn(cfg, p, h)
    return x, k, v


def embed_inputs(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def unembed(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # (B, S) integer
    *,
    collect_kv: bool = False,
    unembed_last_only: bool = False,
):
    """Full-sequence forward. Returns (logits, aux_loss, kv | None).

    kv (if collected): (k, v) each (L, B, S, KV, hd) — the prefill cache.
    ``unembed_last_only`` skips the (B, S, V) logit tensor (prefill path).
    """
    _check_family(cfg)
    x = embed_inputs(cfg, params, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    ks, vs = [], []
    for layer in range(cfg.n_layers):
        x, k, v = _block(cfg, layer_params(params, layer), x, positions)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    if unembed_last_only:
        x = x[:, -1:]
    logits = unembed(cfg, params, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if collect_kv:
        return logits, aux, (torch.stack(ks), torch.stack(vs))
    return logits, aux, None


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "length": 0,
    }


def decode_step(
    cfg: ModelConfig,
    params: Params,
    cache: Dict[str, Any],
    tokens: torch.Tensor,  # (B, 1)
    pos: int,  # current length (uniform across batch)
):
    """One decode step. Returns (logits (B, V), cache).

    The cache's k/v are updated IN PLACE at ``pos`` (JAX returns a new
    cache; writing the one new row saves copying the whole cache)."""
    _check_family(cfg)
    x = params["embed"][tokens]  # (B, 1, d)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    for layer in range(cfg.n_layers):
        p_l = layer_params(params, layer)
        h = rmsnorm(x, p_l["attn_norm"], cfg.norm_eps)
        q, k, v = project_qkv(cfg, _attn_params(cfg, p_l), h, positions)
        cache["k"][layer, :, pos] = k[:, 0]
        cache["v"][layer, :, pos] = v[:, 0]
        o = decode_attention(q, cache["k"][layer], cache["v"][layer], pos + 1)
        x = x + o.reshape(B, 1, -1) @ p_l["wo"]
        h = rmsnorm(x, p_l["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(cfg, p_l, h)
    logits = unembed(cfg, params, x)[:, 0]
    cache["length"] = pos + 1
    return logits, cache
