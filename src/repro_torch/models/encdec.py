"""Encoder-decoder transformer, the whisper-base backbone (port of
``repro/models/encdec.py``).

The conv audio frontend is a stub, as in JAX: the encoder takes frame
embeddings (B, S_enc, d) as its input. Positions are sinusoidal in both
stacks (no RoPE). Prefill attention — the encoder's, the decoder's causal
self-attention and its cross-attention to the encoder output — runs through
the flash-attention kernel where JAX calls ``chunked_attention``; decode
attends its dense self and cross caches with ``layers.decode_attention``,
as JAX does.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import ModelConfig
from repro_torch.distributed.sharding import P
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import dense
from repro_torch.models.common import Leaf, Params, layer_stack, maybe_remat, stacked
from repro_torch.models.layers import (AttnParams, cache_split, decode_attention, gelu_mlp, model_split, project_qkv,
                                       rmsnorm, split_model, use_weight, use_weights)


def _attn_leaves(cfg: ModelConfig, L: int, prefix: str) -> Dict[str, Leaf]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    return {
        f"{prefix}norm": stacked(L, (d,), (None,), init="ones"),
        f"{prefix}wq": stacked(L, (d, H * hd), ("embed", "heads")),
        f"{prefix}wk": stacked(L, (d, KV * hd), ("embed", "kv")),
        f"{prefix}wv": stacked(L, (d, KV * hd), ("embed", "kv")),
        f"{prefix}wo": stacked(L, (H * hd, d), ("heads", "embed")),
    }


def schema(cfg: ModelConfig) -> Dict[str, Any]:
    d, Ff, V = cfg.d_model, cfg.d_ff, cfg.vocab
    L, Le = cfg.n_layers, cfg.enc_layers
    enc = {
        **_attn_leaves(cfg, Le, "attn_"),
        "mlp_norm": stacked(Le, (d,), (None,), init="ones"),
        "w_in": stacked(Le, (d, Ff), ("embed", "ffn")),
        "w_out": stacked(Le, (Ff, d), ("ffn", "embed")),
    }
    dec = {
        **_attn_leaves(cfg, L, "attn_"),
        **_attn_leaves(cfg, L, "cross_"),
        "mlp_norm": stacked(L, (d,), (None,), init="ones"),
        "w_in": stacked(L, (d, Ff), ("embed", "ffn")),
        "w_out": stacked(L, (Ff, d), ("ffn", "embed")),
    }
    return {
        "embed": Leaf((V, d), ("vocab", "embed"), scale=0.02),
        "frontend_proj": Leaf((d, d), ("embed", None), scale=0.02),
        "enc": enc,
        "dec": dec,
        "enc_norm": Leaf((d,), (None,), init="ones"),
        "final_norm": Leaf((d,), (None,), init="ones"),
        "lm_head": Leaf((d, V), ("embed", "vocab"), scale=0.02),
    }


def sinusoid(S: int, d: int, offset: int = 0, device=None) -> torch.Tensor:
    """(S, d) fp32: [sin, cos] of ``pos / 10000 ** (2 i / d)`` at positions
    offset .. offset + S - 1, in fp32 as JAX computes it."""
    pos = (offset + torch.arange(S, device=device))[:, None].float()
    i = torch.arange(d // 2, device=device)[None, :].float()
    ang = pos / (10_000.0 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoid_at(pos: int, d: int, device=None) -> torch.Tensor:
    """The sinusoid at one position -> (1, 1, d)."""
    return sinusoid(1, d, offset=pos, device=device)[None]


def _aview(p: Params, prefix: str) -> AttnParams:
    return AttnParams(wq=p[f"{prefix}wq"], wk=p[f"{prefix}wk"], wv=p[f"{prefix}wv"], wo=p[f"{prefix}wo"])


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    return o.reshape(*o.shape[:2], -1)


def _attention(cfg: ModelConfig, p: Params, h: torch.Tensor, prefix: str, leaf: str, causal: bool,
               kv_in=None):
    """Attention of the layer's ``<prefix>`` weights (self-attention, or
    cross-attention to ``kv_in``): (output (B, S, d), k, v)."""
    ap = _aview(p, prefix)
    if split_model() is not None:
        return dense.split_attention(cfg, ap, h, None, leaf, causal=causal, kv_in=kv_in)
    if kv_in is None:
        q, k, v = project_qkv(cfg, ap, h, None, rope=False)
    else:
        q = (h @ ap.wq).reshape(*h.shape[:2], cfg.n_heads, cfg.resolved_head_dim)
        k, v = _cross_kv(cfg, p, kv_in)
    return _merge_heads(flash_attention(q, k, v, causal=causal)) @ ap.wo, k, v


def _mlp(p: Params, h: torch.Tensor, stack: str) -> torch.Tensor:
    return gelu_mlp(h, p["w_in"], p["w_out"], tp=model_split(f"{stack}.w_in", -1))


def _enc_block(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """One encoder layer (full attention)."""
    p = use_weights(p, "enc")
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    x = x + _attention(cfg, p, h, "attn_", "enc.attn_", causal=False)[0]
    h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + _mlp(p, h, "enc")


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor, *, remat: bool = True) -> torch.Tensor:
    """frames: (B, S_enc, d) stub frontend embeddings -> (B, S_enc, d). The
    frames are cast to the weights' dtype (bf16, as JAX casts them)."""
    proj = use_weight(params["frontend_proj"], "frontend_proj")
    x = frames.to(proj.dtype) @ proj
    x = x + sinusoid(x.shape[1], x.shape[2], device=x.device).to(x.dtype)
    for p in layer_stack(params, "enc"):
        x = maybe_remat(_enc_block, remat, cfg, p, x)
    return rmsnorm(x, use_weight(params["enc_norm"], "enc_norm"), cfg.norm_eps)


def _cross_kv(cfg: ModelConfig, p: Params, enc_out: torch.Tensor):
    """Cross-attention K/V of one decoder layer: plain matmuls of the
    encoder output (no bias, no RoPE) -> (B, S_enc, KV, hd) each."""
    B, Se, _ = enc_out.shape
    shape = (B, Se, cfg.n_kv_heads, cfg.resolved_head_dim)
    return (enc_out @ p["cross_wk"]).reshape(shape), (enc_out @ p["cross_wv"]).reshape(shape)


def _dec_block(cfg: ModelConfig, p: Params, x: torch.Tensor, enc_out: torch.Tensor):
    """One decoder layer over the whole sequence. Returns (x, (k, v, ck, cv))
    (in a split step the rank's KV heads)."""
    p = use_weights(p, "dec")
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    o, k, v = _attention(cfg, p, h, "attn_", "dec.attn_", causal=True)
    x = x + o
    h = rmsnorm(x, p["cross_norm"], cfg.norm_eps)
    o, ck, cv = _attention(cfg, p, h, "cross_", "dec.cross_", causal=False, kv_in=enc_out)
    x = x + o
    h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + _mlp(p, h, "dec"), (k, v, ck, cv)


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # (B, S) decoder tokens
    frontend: torch.Tensor,  # (B, S_enc, d) frame embeddings
    *,
    remat: bool = True,
    collect_kv: bool = False,
    unembed_last_only: bool = False,
):
    """Returns (logits, 0.0, (k, v, ck, cv) each stacked over layers, or
    None): k/v (L, B, S, KV, hd), ck/cv (L, B, S_enc, KV, hd). ``remat``:
    each encoder and decoder layer is recomputed in the backward (JAX's
    ``jax.checkpoint`` of both scan bodies)."""
    enc_out = encode(cfg, params, frontend, remat=remat)
    x = dense.embed_tokens(params, tokens)
    x = x + sinusoid(x.shape[1], x.shape[2], device=x.device).to(x.dtype)
    kvs = []
    for p in layer_stack(params, "dec"):
        x, kv = maybe_remat(_dec_block, remat, cfg, p, x, enc_out)
        if collect_kv:
            kvs.append(kv)
    if unembed_last_only:
        x = x[:, -1:]
    logits = dense.unembed(cfg, params, x)
    collected = tuple(torch.stack(t) for t in zip(*kvs)) if collect_kv else None
    return logits, 0.0, collected


def cache_heads(cfg: ModelConfig):
    """A split prefill cache's entries that hold this rank's KV heads (self
    and cross): {name: (heads dim, each rank's [start, stop))}."""
    self_kv, cross_kv = dense.kv_head_ranges(cfg, "dec.attn_"), dense.kv_head_ranges(cfg, "dec.cross_")
    return {"k": (3, self_kv), "v": (3, self_kv), "ck": (3, cross_kv), "cv": (3, cross_kv)}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Self K/V of ``max_len`` positions; cross K/V of ``max(max_len // 4,
    1)`` encoder rows (JAX's ``cache_specs``). Decode attends every cross
    row: a shorter prefill's rows are padded with zeros, which take softmax
    weight, as in JAX (ROADMAP.md §3)."""
    hd, L, KV = cfg.resolved_head_dim, cfg.n_layers, cfg.n_kv_heads
    Se = max(max_len // 4, 1)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.bfloat16, device=device)  # noqa: E731
    return {
        "k": zeros(L, batch, max_len, KV, hd),
        "v": zeros(L, batch, max_len, KV, hd),
        "ck": zeros(L, batch, Se, KV, hd),
        "cv": zeros(L, batch, Se, KV, hd),
        "length": 0,
    }


def cache_pspec():
    seqsharded = P(None, ("pod", "data"), "model", None, None)
    return {"k": seqsharded, "v": seqsharded, "ck": seqsharded, "cv": seqsharded, "length": P()}


def decode_step(cfg: ModelConfig, params: Params, cache: Dict[str, Any], tokens: torch.Tensor, pos: int):
    """One decoder step against the cached self and cross K/V. Returns
    (logits (B, V), cache); the self cache is written IN PLACE at ``pos``.
    In a split step the cache is this rank's (its rows, its chunk of each
    sequence where ``cache_pspec`` splits it)."""
    x = dense.embed_tokens(params, tokens)  # (B, 1, d)
    B = x.shape[0]
    x = x + sinusoid_at(pos, x.shape[-1], device=x.device).to(x.dtype)
    split = split_model() is not None
    for layer, p in enumerate(layer_stack(params, "dec")):
        p = use_weights(p, "dec")
        k_c, v_c, ck, cv = (cache[key][layer] for key in ("k", "v", "ck", "cv"))
        h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
        if split:
            x = x + dense.split_decode_attention(cfg, _aview(p, "attn_"), h, None, k_c, v_c, pos, cache_split("k", 2),
                                                 "dec.attn_")
            h = rmsnorm(x, p["cross_norm"], cfg.norm_eps)
            x = x + dense.split_cross_decode(cfg, _aview(p, "cross_"), h, ck, cv, cache_split("ck", 2), "dec.cross_")
        else:
            q, k, v = project_qkv(cfg, _aview(p, "attn_"), h, None, rope=False)
            k_c[:, pos] = k[:, 0]
            v_c[:, pos] = v[:, 0]
            o = decode_attention(q, k_c, v_c, pos + 1)
            x = x + o.reshape(B, 1, -1) @ p["attn_wo"]
            h = rmsnorm(x, p["cross_norm"], cfg.norm_eps)
            cq = (h @ p["cross_wq"]).reshape(B, 1, cfg.n_heads, cfg.resolved_head_dim)
            co = decode_attention(cq, ck, cv, ck.shape[1])
            x = x + co.reshape(B, 1, -1) @ p["cross_wo"]
        h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
        x = x + _mlp(p, h, "dec")
    logits = dense.unembed(cfg, params, x)[:, 0]
    cache["length"] = pos + 1
    return logits, cache
