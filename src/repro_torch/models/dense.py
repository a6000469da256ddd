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

In a split train step (``layers.split_compute``) the layers compute in
JAX's layout: each weight is gathered over "data" where it is used
(``layers.use_weight``, inside the remat region); ``wq``/``wk``/``wv`` are
column-parallel on whole heads (``sharding.head_route``: the KV heads a
rank's q heads read are gathered from its neighbours where the split cuts
them, and q heads that do not divide over "model" are computed on every
rank), flash attention runs on the local heads, and ``wo`` is row-parallel;
the FFN and the MoE as ``layers``; the embedding, the logits and the loss
(``ModelSpec.loss``) are vocab-parallel where "model" divides the vocab.
The attention helpers (``split_attention``, ``split_decode_attention``,
``split_cross_decode``) take the leaf prefix of their weights, and the
embedding and logits (``embed_tokens``, ``unembed``) serve every family:
the encoder-decoder and Zamba2's shared block split their attention the
same way.

The sharded prefill and decode steps (``launch/steps.py``, under no grad)
compute in the same layout. Prefill's cache holds this rank's rows and the
KV heads its route computed (``kv_head_ranges``); ``decode_cache`` moves
them from heads to sequence. Decode keeps JAX's cache layout
(``cache_pspec``: the sequence split over "model", every KV head whole on
each rank): the new token's K/V of every KV head is written by the rank
whose chunk holds its position, q of every head attends over each rank's
chunk (``layers.sharded_decode_attention``), and the rank's heads go into
the row-parallel ``wo``.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Any, Dict, Optional, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast

from repro_torch.configs import ModelConfig
from repro_torch.distributed.sharding import P, head_route
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import Leaf, Params, layer_stack, maybe_remat, stacked
from repro_torch.models.layers import (AttnParams, cache_split, decode_attention, model_split, moe_ffn, project_qkv,
                                       qkv_epilogue, rmsnorm, sharded_decode_attention, split_model, swiglu, use_weight,
                                       use_weights)

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
        # a host range for traces, opened only under a running profiler
        with _RecordFunctionFast("model.moe") if torch.autograd._profiler_enabled() else nullcontext():
            return moe_ffn(cfg, x, p["router"], p["we_gate"], p["we_up"], p["we_down"], shared, aux=aux,
                           experts=experts, ep=model_split("blocks.we_gate", 0),
                           shared_tp=model_split("blocks.ws_gate", -1) if shared else None)
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"], tp=model_split("blocks.w_gate", -1)), 0.0


def _routes(cfg: ModelConfig, ranks=None, leaf: str = "blocks."):
    """The ``head_route`` of each "model" rank of ``ranks`` (default: this
    rank alone) in a split step, for the attention whose leaves are
    ``<leaf>wq``, ``<leaf>wk``, ..."""
    tp = split_model()
    q_split, kv_split = model_split(f"{leaf}wq", -1) is not None, model_split(f"{leaf}wk", -1) is not None
    return [head_route(cfg.n_heads, cfg.n_kv_heads, tp.size, i, q_split, kv_split)
            for i in (ranks if ranks is not None else [tp.index])]


def kv_head_ranges(cfg: ModelConfig, leaf: str = "blocks."):
    """Each "model" rank's KV heads [start, stop) in a split step, in rank
    order: the heads its K/V projections compute."""
    return tuple(r.kv for r in _routes(cfg, range(split_model().size), leaf))


def cache_heads(cfg: ModelConfig):
    """A split prefill cache's entries that hold this rank's KV heads:
    {name: (heads dim, each rank's [start, stop))}."""
    ranges = kv_head_ranges(cfg)
    return {"k": (3, ranges), "v": (3, ranges)}


def split_qkv(cfg: ModelConfig, ap: AttnParams, h: torch.Tensor, positions, leaf: str = "blocks.",
              kv_in: Optional[torch.Tensor] = None):
    """The attention projections of a split step (leaves ``<leaf>wq``, ...;
    ``ap`` the layer's weights): (q of the route's q heads, k and v of its
    KV heads (``route.kv``), the route, the ``wo`` it computes with: the
    rank's rows, or the whole where it is replicated). ``kv_in``: the input
    of k and v where it is not ``h`` (cross-attention's encoder output)."""
    tp = split_model()
    hd = cfg.resolved_head_dim
    route = _routes(cfg, leaf=leaf)[0]
    src = h if kv_in is None else kv_in
    if route.route == "replicated":  # every rank computes every head: the whole projections, gathered
        def whole(name, w):
            dim = 0 if name == "wo" else -1  # wo's heads are its rows
            split = w is not None and model_split(f"{leaf}{name}", dim) is not None
            return tp.gather(w, dim, partial_grad=False) if split else w

        ap = AttnParams(**{n: whole(n, getattr(ap, n)) for n in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")},
                        q_norm=ap.q_norm, k_norm=ap.k_norm)
        if kv_in is None:
            return (*project_qkv(cfg, ap, h, positions), route, ap.wo)
        return (*qkv_epilogue(cfg, ap, h @ ap.wq, src @ ap.wk, src @ ap.wv, positions), route, ap.wo)
    kv = {"wk": ap.wk, "wv": ap.wv, "bk": ap.bk, "bv": ap.bv}
    if route.route == "kv_gather":  # the whole KV projections; this rank's q heads read heads route.kv
        cols = slice(route.kv[0] * hd, route.kv[1] * hd)
        kv = {name: (tp.gather(w, -1, partial_grad=True) if model_split(f"{leaf}{name}", -1) is not None
                     else tp.copy(w))[..., cols] for name, w in kv.items() if w is not None}
    norm = {"q_norm": tp.copy(ap.q_norm), "k_norm": tp.copy(ap.k_norm)} if ap.q_norm is not None else {}
    ap = AttnParams(wq=ap.wq, wo=ap.wo, bq=ap.bq, **{n: kv.get(n) for n in ("wk", "wv", "bk", "bv")}, **norm)
    if kv_in is None:
        q, k, v = tp.column_parallel(h, ap.wq, ap.wk, ap.wv)
    else:
        (q,), (k, v) = tp.column_parallel(h, ap.wq), tp.column_parallel(src, ap.wk, ap.wv)
    return (*qkv_epilogue(cfg, ap, q, k, v, positions), route, ap.wo)


def _split_out(route, o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """The attention output of the route's q heads ``o`` (B, S, heads, hd)
    through ``wo``: replicated, or row-parallel over "model"."""
    o = o.reshape(*o.shape[:2], -1)
    return o @ wo if route.route == "replicated" else split_model().row_parallel(o, wo)


def split_attention(cfg: ModelConfig, ap: AttnParams, h: torch.Tensor, positions, leaf: str = "blocks.",
                    causal: bool = True, kv_in: Optional[torch.Tensor] = None):
    """Attention in a split step, flash on the route's heads: (the layer's
    attention output (B, S, d), k, v of the KV heads this rank computed,
    ``route.kv``)."""
    q, k, v, route, wo = split_qkv(cfg, ap, h, positions, leaf, kv_in)
    kq, vq = k, v
    if route.kv_of_q is not None:  # local q heads that are not whole GQA groups: one KV head per q head
        index = torch.tensor(route.kv_of_q, device=k.device)
        kq, vq = k.index_select(2, index), v.index_select(2, index)
    return _split_out(route, flash_attention(q, kq, vq, causal=causal), wo), k, v


def _split_decode_attend(route, q: torch.Tensor, k_cache, v_cache, length: int, seq, wo) -> torch.Tensor:
    """q of the route's heads (B, 1, heads, hd) over a decode cache (every
    KV head; the sequence this rank's chunk where ``seq`` splits it, the
    whole else) of ``length`` valid rows, through ``wo``: q of every head
    gathered, attention combined over the chunks, the rank's heads out."""
    tp = split_model()
    if route.route != "replicated":
        q = tp.gather(q, 2, partial_grad=False)  # every q head (the ranks' heads are consecutive)
    if seq is None:
        o = decode_attention(q, k_cache, v_cache, length)
    else:
        o = sharded_decode_attention(q, k_cache, v_cache, length, seq)
    if route.route != "replicated":
        o = o[:, :, route.q[0]:route.q[1]]
    return _split_out(route, o, wo)


def split_decode_attention(cfg: ModelConfig, ap: AttnParams, h: torch.Tensor, positions, k_cache, v_cache,
                           pos: int, seq, leaf: str = "blocks.") -> torch.Tensor:
    """Self-attention of a split decode step over a K/V cache of every KV
    head (``seq``: the "model" axis its sequence is split over, or None):
    the projections by the head route; the new token's K/V of every KV head
    (``gather_heads``) written at ``pos`` by the rank whose chunk holds it
    (by every rank where the cache is whole); the attention output."""
    tp = split_model()
    q, k, v, route, wo = split_qkv(cfg, ap, h, positions, leaf)
    ranges = kv_head_ranges(cfg, leaf)
    k, v = tp.gather_heads(k, ranges, 2), tp.gather_heads(v, ranges, 2)
    chunk = k_cache.shape[1]
    if seq is None or pos // chunk == seq.index:
        row = pos if seq is None else pos % chunk
        k_cache[:, row], v_cache[:, row] = k[:, 0], v[:, 0]
    return _split_decode_attend(route, q, k_cache, v_cache, pos + 1, seq, wo)


def split_cross_decode(cfg: ModelConfig, ap: AttnParams, h: torch.Tensor, k_cache, v_cache, seq,
                       leaf: str) -> torch.Tensor:
    """Cross-attention of a split decode step: q by the head route (no
    bias, no RoPE), every row of the cross cache attended (its length is
    the whole cache's: padded rows count, as in JAX)."""
    tp = split_model()
    route = _routes(cfg, leaf=leaf)[0]
    hd = cfg.resolved_head_dim
    if route.route == "replicated":
        wq = tp.gather(ap.wq, -1, partial_grad=False) if model_split(f"{leaf}wq", -1) is not None else ap.wq
        wo = tp.gather(ap.wo, 0, partial_grad=False) if model_split(f"{leaf}wo", 0) is not None else ap.wo
        q = h @ wq
    else:
        (q,), wo = tp.column_parallel(h, ap.wq), ap.wo
    length = k_cache.shape[1] * (1 if seq is None else seq.size)
    return _split_decode_attend(route, q.reshape(*q.shape[:2], -1, hd), k_cache, v_cache, length, seq, wo)


def _block(
    cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor, aux: bool,
):
    """One layer. Returns (x_out, aux_loss (0.0 without ``aux``), k, v)."""
    p = use_weights(p, "blocks")
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    if split_model() is None:
        q, k, v = project_qkv(cfg, _attn_params(cfg, p), h, positions)
        o = flash_attention(q, k, v, causal=True)
        x = x + o.reshape(*o.shape[:2], -1) @ p["wo"]
    else:
        o, k, v = split_attention(cfg, _attn_params(cfg, p), h, positions)
        x = x + o
    h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    f, aux_loss = _ffn(cfg, p, h, aux)
    return x + f, aux_loss, k, v


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings (B, S, d) of ``params["embed"]`` (every family's).
    In a split step with the vocab split over "model", each rank looks up
    the tokens of its vocab range, writes zero for the rest, and the rows
    are summed over "model"."""
    embed = use_weight(params["embed"], "embed")
    tp = model_split("embed", 0)
    if tp is None:
        return embed[tokens]
    local = tokens.long() - tp.index * embed.shape[0]
    inside = (local >= 0) & (local < embed.shape[0])
    x = embed[local.clamp(0, embed.shape[0] - 1)]
    return tp.reduce(torch.where(inside[..., None], x, torch.zeros_like(x)))


def embed_inputs(
    cfg: ModelConfig, params: Params, tokens: torch.Tensor, frontend: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Token embeddings (B, S, d) (``embed_tokens``); a vlm's frontend
    embeddings (B, Sf, d) are projected and prepended."""
    x = embed_tokens(params, tokens)
    if cfg.frontend is not None and frontend is not None:
        fe = frontend.to(x.dtype) @ use_weight(params["frontend_proj"], "frontend_proj")
        x = torch.cat([fe, x], dim=1)
    return x


def logits_split(cfg: ModelConfig):
    """(the "model" axis, this rank's first vocab id) where a split step's
    logits are split over "model" by vocab, else None."""
    name, dim = ("embed", 0) if cfg.tie_embeddings else ("lm_head", -1)
    tp = model_split(name, dim)
    return None if tp is None else (tp, tp.index * (cfg.vocab // tp.size))


def unembed(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits (B, S, V) of the final norm and the tied embedding or
    ``lm_head`` (every family's); in a split step with the vocab split over
    "model", this rank's columns (``logits_split``)."""
    x = rmsnorm(x, use_weight(params["final_norm"], "final_norm"), cfg.norm_eps)
    w = use_weight(params["embed"], "embed").T if cfg.tie_embeddings else use_weight(params["lm_head"], "lm_head")
    return x @ w if logits_split(cfg) is None else split_model().column_parallel(x, w)[0]


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
    cache (in a split step the KV heads of this rank's route); aux_loss is
    then 0, as in JAX (the sum over layers otherwise).
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
    """KV sequence-sharded over "model" (flash-decoding combine:
    ``layers.sharded_decode_attention``), batch over ("pod","data") — see
    DESIGN.md §4 (JAX's specs). ``launch/steps.py::decode_cache(mesh=)``
    places a cache by them, and the dry run counts its bytes by them."""
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
    cache; writing the one new row saves copying the whole cache). In a
    split step with more than one "model" rank the layers take
    ``_split_decode_layer``, the cache is this rank's (its rows; its chunk
    of the sequence where ``cache_pspec`` splits it) and the logits are this
    rank's vocab columns where the vocab is split."""
    x = embed_inputs(cfg, params, tokens)  # (B, 1, d)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int64, device=x.device)
    body = _decode_layer if split_model() is None else _split_decode_layer
    for layer, p_l in enumerate(layer_stack(params)):  # a layer's gathered weights live in its call only
        x = body(cfg, use_weights(p_l, "blocks"), x, cache, layer, pos, positions)
    logits = unembed(cfg, params, x)[:, 0]
    cache["length"] = pos + 1
    return logits, cache


def _decode_layer(cfg: ModelConfig, p: Params, x: torch.Tensor, cache, layer: int, pos: int,
                  positions: torch.Tensor) -> torch.Tensor:
    """One layer of the decode step: the new token's K/V written at
    ``pos``, attention over the cache's valid prefix."""
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = project_qkv(cfg, _attn_params(cfg, p), h, positions)
    cache["k"][layer, :, pos] = k[:, 0]
    cache["v"][layer, :, pos] = v[:, 0]
    o = decode_attention(q, cache["k"][layer], cache["v"][layer], pos + 1)
    x = x + o.reshape(x.shape[0], 1, -1) @ p["wo"]
    h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + _ffn(cfg, p, h)[0]


def _split_decode_layer(cfg: ModelConfig, p: Params, x: torch.Tensor, cache, layer: int, pos: int,
                        positions: torch.Tensor) -> torch.Tensor:
    """One layer of a split decode step: attention by
    ``split_decode_attention`` over the sharded cache (or the whole); the
    FFN split as in training."""
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    x = x + split_decode_attention(cfg, _attn_params(cfg, p), h, positions, cache["k"][layer], cache["v"][layer],
                                   pos, cache_split("k", 2))
    h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + _ffn(cfg, p, h)[0]
