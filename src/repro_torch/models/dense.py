"""Decoder-only transformer: families "dense", "moe", "vlm" (port of
``repro/models/dense.py``).

vlm = dense backbone + stub vision frontend (precomputed patch embeddings
are an input, projected and prepended to the token sequence).
moe = dense with the FFN replaced by ``layers.moe_ffn``.

Parameters are the flat dict of ``models.common`` with stacked ``blocks.*``
entries; the forward pass is a Python loop over layers. Prefill attention
runs through the hand-written flash-attention kernel
(``repro_torch.kernels.flash_attention``) where JAX uses
``layers.chunked_attention``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.distributed.sharding import P
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import Leaf, Params, layer_stack, maybe_remat, stacked
from repro_torch.models.layers import AttnParams, decode_attention, moe_ffn, project_qkv, rmsnorm, swiglu

def schema(cfg: ModelConfig) -> Dict[str, Any]:
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
    if cfg.family == "moe":
        m = cfg.moe
        E, f = m.num_experts, m.d_ff_expert
        b["router"] = stacked(L, (d, E), ("embed", None), scale=0.02)
        b["we_gate"] = stacked(L, (E, d, f), ("experts", "embed", None))
        b["we_up"] = stacked(L, (E, d, f), ("experts", "embed", None))
        b["we_down"] = stacked(L, (E, f, d), ("experts", None, "embed"))
        if m.shared_expert:
            fs = m.d_ff_shared or Ff
            b["ws_gate"] = stacked(L, (d, fs), ("embed", "ffn"))
            b["ws_up"] = stacked(L, (d, fs), ("embed", "ffn"))
            b["ws_down"] = stacked(L, (fs, d), ("ffn", "embed"))
    else:
        b["w_gate"] = stacked(L, (d, Ff), ("embed", "ffn"))
        b["w_up"] = stacked(L, (d, Ff), ("embed", "ffn"))
        b["w_down"] = stacked(L, (Ff, d), ("ffn", "embed"))
    if not cfg.tie_embeddings:
        s["lm_head"] = Leaf((d, V), ("embed", "vocab"), scale=0.02)
    if cfg.frontend is not None:
        s["frontend_proj"] = Leaf((d, d), ("embed", None), scale=0.02)
    return s


def _attn_params(cfg: ModelConfig, p: Params) -> AttnParams:
    return AttnParams(
        wq=p["wq"], wk=p["wk"], wv=p["wv"], wo=p["wo"],
        bq=p.get("bq"), bk=p.get("bk"), bv=p.get("bv"),
        q_norm=p.get("q_norm"), k_norm=p.get("k_norm"),
    )


def _ffn(cfg: ModelConfig, p: Params, x: torch.Tensor, aux: bool = False, experts=None):
    """SwiGLU (silu in fp32, as the JAX recipe) or the MoE layer (``experts``:
    forced expert ids, see ``moe_ffn``). Returns (out, aux_loss): with
    ``aux`` the MoE's fp32 scalar tensor, else (and for a dense layer) the
    float 0.0 — no device op for a loss the caller drops (JAX's compiled
    prefill and decode drop it the same way)."""
    if cfg.family == "moe":
        shared = (p["ws_gate"], p["ws_up"], p["ws_down"]) if cfg.moe.shared_expert else None
        return moe_ffn(cfg, x, p["router"], p["we_gate"], p["we_up"], p["we_down"], shared, aux=aux,
                       experts=experts)
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"]), 0.0


def _block(
    cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor, aux: bool,
):
    """One layer. Returns (x_out, aux_loss (0.0 without ``aux``), k, v)."""
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = project_qkv(cfg, _attn_params(cfg, p), h, positions)
    o = flash_attention(q, k, v, causal=True)
    o = o.reshape(*o.shape[:2], -1)
    x = x + o @ p["wo"]
    h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    f, aux_loss = _ffn(cfg, p, h, aux)
    return x + f, aux_loss, k, v


def embed_inputs(
    cfg: ModelConfig, params: Params, tokens: torch.Tensor, frontend: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Token embeddings (B, S, d); a vlm's frontend embeddings (B, Sf, d)
    are projected and prepended."""
    x = params["embed"][tokens]
    if cfg.frontend is not None and frontend is not None:
        fe = frontend.to(x.dtype) @ params["frontend_proj"]
        x = torch.cat([fe, x], dim=1)
    return x


def unembed(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # (B, S) integer
    frontend: Optional[torch.Tensor] = None,  # (B, Sf, d) for a vlm
    *,
    remat: bool = True,
    collect_kv: bool = False,
    unembed_last_only: bool = False,
):
    """Full-sequence forward. Returns (logits, aux_loss, kv | None).

    kv (if collected): (k, v) each (L, B, Sf + S, KV, hd) — the prefill
    cache; aux_loss is then 0, as in JAX (the sum over layers otherwise).
    ``unembed_last_only`` skips the (B, S, V) logit tensor (prefill path).
    ``remat``: each layer's activations are recomputed in the backward
    (JAX's ``jax.checkpoint`` of the layer body).
    """
    x = embed_inputs(cfg, params, tokens, frontend)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    ks, vs = [], []
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p_l in layer_stack(params):
        x, aux, k, v = maybe_remat(_block, remat, cfg, p_l, x, positions, not collect_kv)
        if collect_kv:
            ks.append(k)
            vs.append(v)
        else:
            total_aux = total_aux + aux
    if unembed_last_only:
        x = x[:, -1:]
    logits = unembed(cfg, params, x)
    if collect_kv:
        return logits, total_aux, (torch.stack(ks), torch.stack(vs))
    return logits, total_aux, None


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


def cache_pspec():
    """KV sequence-sharded over "model" (flash-decoding combine via SPMD),
    batch over ("pod","data") — see DESIGN.md §4 (JAX's specs; the port
    has no sharded decode step yet: the dry run reads them)."""
    return {
        "k": P(None, ("pod", "data"), "model", None, None),
        "v": P(None, ("pod", "data"), "model", None, None),
        "length": P(),
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
    x = params["embed"][tokens]  # (B, 1, d)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    for layer, p_l in enumerate(layer_stack(params)):
        h = rmsnorm(x, p_l["attn_norm"], cfg.norm_eps)
        q, k, v = project_qkv(cfg, _attn_params(cfg, p_l), h, positions)
        cache["k"][layer, :, pos] = k[:, 0]
        cache["v"][layer, :, pos] = v[:, 0]
        o = decode_attention(q, cache["k"][layer], cache["v"][layer], pos + 1)
        x = x + o.reshape(B, 1, -1) @ p_l["wo"]
        h = rmsnorm(x, p_l["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(cfg, p_l, h)[0]
    logits = unembed(cfg, params, x)[:, 0]
    cache["length"] = pos + 1
    return logits, cache
