"""Mamba2 (SSD) layers and the Zamba2 hybrid, family "hybrid" (port of
``repro/models/mamba2.py``).

Zamba2 is a Mamba2 backbone with one shared full-attention block applied
after every ``shared_attn_every`` Mamba layers (fully shared weights, as in
JAX): ``n_super`` super-blocks of ``every`` Mamba layers and the shared
block, then ``n_tail`` Mamba layers (81 = 13 x 6 + 3 at full width). Each
invocation of the shared block keeps its own K/V cache.

Mamba2 recurrence (per head h, a scalar decay):
    a_t = exp(-exp(A_log_h) * dt_t)
    S_t = a_t S_{t-1} + dt_t x_t (x) B_t         state: (P = head_dim, N)
    y_t = C_t . S_t + D_h x_t
evaluated chunk by chunk from cumulative log-decay differences (<= 0 where
they count), the state carried by a Python loop over chunks, in fp32. The
shared block's prefill attention is the flash-attention kernel (JAX:
``chunked_attention``); its decode attention is ``layers.decode_attention``.

In a split step (``layers.split_compute``) a mixer runs on the rank's heads
where "model" divides them (``_head_route``; where it cuts a head, every
rank computes every head, the split projections gathered): ``w_z`` and
``w_x`` column-parallel; ``w_B``, ``w_C`` and ``w_dt`` computed whole on
every rank, the rank's heads of ``dt`` taken; the conv over the rank's x
channels and the whole B and C channels; ``dt_bias``, ``A_log``, ``D`` and
``ln_y`` sliced to the rank's heads; the gated RMSnorm's sum of squares
summed over "model" (it spans the whole inner dim); ``w_out``
row-parallel. The shared block takes dense's TP split (heads, ffn), its
weights gathered over "data" at each application, their gradients summed
over the applications and reduced into the shard once a microbatch
(``layers.weight_anchors``). The conv and SSM states are whole on every
rank (``cache_pspec``): each layer's are gathered over "model"; the shared
block's K/V cache is sequence-sharded as dense's.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.distributed.sharding import P, head_route
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import dense
from repro_torch.models.common import Leaf, Params, layer_stack, maybe_remat, stacked, sub_params
from repro_torch.models.layers import (AttnParams, cache_split, decode_attention, model_split, project_qkv, rmsnorm,
                                       split_model, swiglu, use_weights, weight_anchors)


def _mamba_leaves(cfg: ModelConfig, L: int) -> Dict[str, Leaf]:
    s = cfg.ssm
    d = cfg.d_model
    inner = s.heads * s.head_dim
    N = s.state_dim
    return {
        "norm": stacked(L, (d,), (None,), init="ones"),
        "w_z": stacked(L, (d, inner), ("embed", "inner")),
        "w_x": stacked(L, (d, inner), ("embed", "inner")),
        "w_B": stacked(L, (d, N), ("embed", None)),
        "w_C": stacked(L, (d, N), ("embed", None)),
        "w_dt": stacked(L, (d, s.heads), ("embed", None)),
        "dt_bias": stacked(L, (s.heads,), (None,), init="zeros"),
        "A_log": stacked(L, (s.heads,), (None,), init="zeros"),
        "D": stacked(L, (s.heads,), (None,), init="ones"),
        # depthwise causal conv over the (x, B, C) channels, width conv_dim
        "conv_w": stacked(L, (inner + 2 * N, s.conv_dim), (None, None), scale=0.3),
        "ln_y": stacked(L, (inner,), (None,), init="ones"),
        "w_out": stacked(L, (inner, d), ("inner", "embed")),
    }


def schema(cfg: ModelConfig) -> Dict[str, Any]:
    d, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    hd = cfg.resolved_head_dim
    H, KV, Ff = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    s: Dict[str, Any] = {
        "embed": Leaf((V, d), ("vocab", "embed"), scale=0.02),
        "final_norm": Leaf((d,), (None,), init="ones"),
        "lm_head": Leaf((d, V), ("embed", "vocab"), scale=0.02),
        "mamba": _mamba_leaves(cfg, L),
    }
    if cfg.shared_attn_every:
        s["shared_attn"] = {
            "attn_norm": Leaf((d,), (None,), init="ones"),
            "wq": Leaf((d, H * hd), ("embed", "heads")),
            "wk": Leaf((d, KV * hd), ("embed", "kv")),
            "wv": Leaf((d, KV * hd), ("embed", "kv")),
            "wo": Leaf((H * hd, d), ("heads", "embed")),
            "mlp_norm": Leaf((d,), (None,), init="ones"),
            "w_gate": Leaf((d, Ff), ("embed", "ffn")),
            "w_up": Leaf((d, Ff), ("embed", "ffn")),
            "w_down": Leaf((Ff, d), ("ffn", "embed")),
        }
    return s


def _split_counts(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_super_blocks, every, n_trailing)."""
    every = cfg.shared_attn_every
    if not every:
        return 0, 0, cfg.n_layers
    n_super = cfg.n_layers // every
    return n_super, every, cfg.n_layers - n_super * every


def causal_conv(x: torch.Tensor, w: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, Ch), w: (Ch, W), prev: (B, W-1, Ch).
    The W taps are summed in fp32 in tap order, then silu, then the cast."""
    W, S = w.shape[-1], x.shape[1]
    xp = torch.cat([prev, x], dim=1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):
        out = out + xp[:, i:i + S].float() * w[:, i].float()
    return F.silu(out).to(x.dtype)


def ssd_chunked(
    xh: torch.Tensor,  # (B, S, H, P) fp32, not yet scaled by dt
    dt: torch.Tensor,  # (B, S, H) fp32, after the softplus
    loga: torch.Tensor,  # (B, S, H) <= 0: per-token log decay
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    state0: torch.Tensor,  # (B, H, P, N)
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y (B, S, H, P), state (B, H, P, N))."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    C = min(chunk, S)
    pad = (-S) % C
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt, loga = F.pad(dt, (0, 0, 0, pad)), F.pad(loga, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    NC = xh.shape[1] // C
    xc = xh.reshape(B, NC, C, H, P).transpose(0, 1)
    dtc, lac = dt.reshape(B, NC, C, H).transpose(0, 1), loga.reshape(B, NC, C, H).transpose(0, 1)
    Bc, Cc = Bm.reshape(B, NC, C, N).transpose(0, 1), Cm.reshape(B, NC, C, N).transpose(0, 1)
    idx = torch.arange(C, device=xh.device)
    lower = (idx[:, None] >= idx[None, :])[None, :, :, None]  # j <= i, diagonal included
    state = state0.float()
    ys = []
    for n in range(NC):
        xb, dtb, lab, Bb, Cb = xc[n], dtc[n], lac[n], Bc[n], Cc[n]
        cum = torch.cumsum(lab, dim=1)  # (B, C, H) inclusive
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B, Ci, Cj, H), <= 0 on the mask
        # masked before the exp: the same numbers as JAX's where(lower,
        # exp(diff), 0), but the pairs above the diagonal (diff > 0, which
        # overflows to inf beyond ~88) give a gradient of 0, not 0 * inf = NaN
        decay = torch.exp(torch.where(lower, diff, float("-inf")))
        cb = Cb @ Bb.transpose(1, 2)  # (B, Ci, Cj), shared by the heads
        dtx = xb * dtb[..., None]  # (B, C, H, P)
        # y_i = sum_j cb_ij decay_ijh dtx_jh in two explicit steps: a
        # three-operand einsum may build a (B, C, C, H, P) fp32 intermediate
        w = (cb[..., None] * decay).permute(0, 3, 1, 2)  # (B, H, Ci, Cj)
        y = (w @ dtx.transpose(1, 2)).transpose(1, 2)  # (B, Ci, H, P)
        # the initial state's share: y_i += exp(cum_i) C_i . S0
        y = y + torch.einsum("bin,bhpn->bihp", Cb, state) * torch.exp(cum)[..., None]
        # S' = exp(cum_C) S0 + sum_j exp(cum_C - cum_j) dtx_j (x) B_j
        total = cum[:, -1:, :]  # (B, 1, H)
        wd = torch.exp(total - cum)  # (B, C, H)
        state = torch.exp(total[:, 0, :, None, None]) * state + torch.einsum(
            "bjhp,bjn->bhpn", dtx * wd[..., None], Bb)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, NC * C, H, P)
    return y[:, :S], state


def _head_route(cfg: ModelConfig):
    """The SSM heads this "model" rank computes in a split step: "local"
    (its shard of the "inner" columns is whole heads) or "replicated" (the
    split cuts a head, or does not split "inner")."""
    tp = split_model()
    H = cfg.ssm.heads
    return head_route(H, H, tp.size, tp.index, model_split("mamba.w_x", -1) is not None, True)


def _local_route(cfg: ModelConfig):
    """This rank's "local" head route in a split step, else None (no split,
    or every rank computes every head)."""
    if split_model() is None:
        return None
    route = _head_route(cfg)
    return route if route.route == "local" else None


def mamba_mix(cfg: ModelConfig, p: Params, x: torch.Tensor, conv_prev: torch.Tensor, state0: torch.Tensor):
    """One Mamba2 mixer. x: (B, S, d), conv_prev: (B, W-1, inner + 2N),
    state0: (B, H, P, N). Returns (out, conv state, ssm state); on a split
    step's "local" route the states are of this rank's x channels and
    heads (``_whole_states`` gathers them)."""
    s = cfg.ssm
    B, S, _ = x.shape
    H, P, N = s.heads, s.head_dim, s.state_dim
    inner = H * P
    tp, route = split_model(), _local_route(cfg)
    if route is None:
        w = dict(p)
        if tp is not None:  # the "replicated" route: the split projections gathered
            for name, dim in (("w_z", -1), ("w_x", -1), ("w_out", 0)):
                if model_split(f"mamba.{name}", dim) is not None:
                    w[name] = tp.gather(p[name], dim, partial_grad=False)
        z, xs = x @ w["w_z"], x @ w["w_x"]
        conv_w, dt_bias, A_log, D, ln_y = p["conv_w"], p["dt_bias"], p["A_log"], p["D"], p["ln_y"]
        heads, out_proj = slice(0, H), lambda y: y @ w["w_out"]
    else:  # this rank's heads h0:h1 and x channels c; the replicated leaves' gradients summed over "model"
        z, xs = tp.column_parallel(x, p["w_z"], p["w_x"])
        heads = slice(*route.q)
        c = slice(heads.start * P, heads.stop * P)
        conv_w = torch.cat([tp.copy(p["conv_w"][:inner])[c], p["conv_w"][inner:]])
        conv_prev = torch.cat([conv_prev[..., c], conv_prev[..., inner:]], dim=-1)
        dt_bias, A_log, D = (tp.copy(p[n])[heads] for n in ("dt_bias", "A_log", "D"))
        ln_y, state0 = tp.copy(p["ln_y"])[c], state0[:, heads]
        out_proj = lambda y: tp.row_parallel(y, p["w_out"])  # noqa: E731
    n = xs.shape[-1]  # the x channels this rank computes
    Bm, Cm, dt_raw = x @ p["w_B"], x @ p["w_C"], x @ p["w_dt"]
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out = causal_conv(conv_in, conv_w, conv_prev)
    xs, Bm, Cm = conv_out[..., :n], conv_out[..., n:n + N], conv_out[..., n + N:]
    if route is not None:  # B, C and dt are whole on every rank and feed this rank's heads only
        Bm, Cm, dt_raw = tp.copy(Bm), tp.copy(Cm), tp.copy(dt_raw)
    # the window: the last W-1 pre-conv inputs seen (any S, decode's 1 too)
    new_conv_prev = torch.cat([conv_prev, conv_in], dim=1)[:, -(s.conv_dim - 1):]
    dt = F.softplus((dt_raw[..., heads] + dt_bias).float())  # the bias added in bf16, before the cast
    loga = -torch.exp(torch.clamp(A_log.float(), -8.0, 4.0)) * dt
    xh = xs.reshape(B, S, -1, P).float()
    y, state1 = ssd_chunked(xh, dt, loga, Bm.float(), Cm.float(), state0, s.chunk)
    y = y + D.float()[None, None, :, None] * xh
    y = y.reshape(B, S, n)
    # gated rmsnorm over the whole inner dim (eps 1e-5), then the out-projection
    y = y * F.silu(z.float())
    if route is None:
        ms = torch.mean(y * y, dim=-1, keepdim=True)
    else:
        ms = tp.all_sum(torch.sum(y * y, dim=-1, keepdim=True)) / inner
    y = y * torch.rsqrt(ms + 1e-5)
    y = (y * ln_y.float()).to(x.dtype)
    return out_proj(y), new_conv_prev, state1


def _whole_states(cfg: ModelConfig, conv: torch.Tensor, ssm: torch.Tensor):
    """A mixer's conv and SSM states whole on every rank: on a split step's
    "local" route the ranks' x channels and heads gathered over "model"."""
    route = _local_route(cfg)
    if route is None:
        return conv, ssm
    tp, n = split_model(), conv.shape[-1] - 2 * cfg.ssm.state_dim
    conv = torch.cat([tp.gather(conv[..., :n], -1, partial_grad=False), conv[..., n:]], dim=-1)
    return conv, tp.gather(ssm, 1, partial_grad=False)


def _mamba_layer(cfg: ModelConfig, p: Params, x, conv_prev, state0):
    p = use_weights(p, "mamba")
    out, conv_state, ssm_state = mamba_mix(cfg, p, rmsnorm(x, p["norm"], cfg.norm_eps), conv_prev, state0)
    return x + out, conv_state, ssm_state


def _shared_attn_block(cfg: ModelConfig, p: Params, x, positions, *, kv_cache=None, pos=None, anchors=None):
    """The shared attention block over the whole sequence (``kv_cache``
    None: flash attention, returns the K/V) or one decode step (writes K/V
    into ``kv_cache`` IN PLACE at ``pos``). Returns (x, (k, v)); in a split
    step dense's TP split, the prefill's K/V of the rank's KV heads.
    ``anchors``: ``layers.weight_anchors`` of the block's weights."""
    p = use_weights(p, "shared_attn", anchors)
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    ap = AttnParams(wq=p["wq"], wk=p["wk"], wv=p["wv"], wo=p["wo"])
    split = split_model() is not None
    if kv_cache is None and split:
        o, k, v = dense.split_attention(cfg, ap, h, positions, "shared_attn.")
        x = x + o
    elif kv_cache is None:
        q, k, v = project_qkv(cfg, ap, h, positions)
        o = flash_attention(q, k, v, causal=True)
        x = x + o.reshape(*o.shape[:2], -1) @ p["wo"]
    elif split:
        k, v = kv_cache
        x = x + dense.split_decode_attention(cfg, ap, h, positions, k, v, pos, cache_split("attn_k", 2), "shared_attn.")
    else:
        q, k, v = project_qkv(cfg, ap, h, positions)
        k_c, v_c = kv_cache
        k_c[:, pos] = k[:, 0]
        v_c[:, pos] = v[:, 0]
        o = decode_attention(q, k_c, v_c, pos + 1)
        k, v = k_c, v_c
        x = x + o.reshape(*o.shape[:2], -1) @ p["wo"]
    h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + swiglu(h, p["w_gate"], p["w_up"], p["w_down"], tp=model_split("shared_attn.w_gate", -1)), (k, v)


def _schedule(cfg: ModelConfig):
    """The layer order: ("mamba", layer index) and ("attn", invocation)."""
    n_super, every, _ = _split_counts(cfg)
    for sb in range(n_super):
        for e in range(every):
            yield "mamba", sb * every + e
        yield "attn", sb
    for layer in range(n_super * every, cfg.n_layers):
        yield "mamba", layer


def _zero_states(cfg: ModelConfig, B: int, dtype, device):
    s = cfg.ssm
    conv = torch.zeros((B, s.conv_dim - 1, s.heads * s.head_dim + 2 * s.state_dim), dtype=dtype, device=device)
    ssm = torch.zeros((B, s.heads, s.head_dim, s.state_dim), dtype=torch.float32, device=device)
    return conv, ssm


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    frontend=None,
    *,
    remat: bool = True,
    collect_kv: bool = False,
    unembed_last_only: bool = False,
):
    """Returns (logits, 0.0, states or None): states (conv (L, B, W-1, ch),
    ssm (L, B, H, P, N)) and, with a shared block, (attn_k, attn_v) each
    (n_super, B, S, KV, hd) after them. ``remat`` recomputes in the backward
    what JAX's ``jax.checkpoint`` does: each Mamba layer, and each super
    block (its Mamba layers and the shared block) around them."""
    x = dense.embed_tokens(params, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    conv0, ssm0 = _zero_states(cfg, B, x.dtype, x.device)
    shared = sub_params(params, "shared_attn")
    anchors = weight_anchors(shared, "shared_attn") if shared else None
    mamba = layer_stack(params, "mamba")
    n_super, every, _ = _split_counts(cfg)
    states, ks, vs = [], [], []

    def mamba_run(x, layers):  # -> (x, [(conv, ssm) of each layer])
        out = []
        for p in layers:
            x, conv, ssm = maybe_remat(_mamba_layer, remat, cfg, p, x, conv0, ssm0)
            if collect_kv:
                out.append(_whole_states(cfg, conv, ssm))
        return x, out

    def super_block(x, layers):
        x, st = mamba_run(x, layers)
        return (*_shared_attn_block(cfg, shared, x, positions, anchors=anchors), st)

    for sb in range(n_super):
        x, (k, v), st = maybe_remat(super_block, remat, x, mamba[sb * every:(sb + 1) * every])
        states += st
        ks.append(k)
        vs.append(v)
    x, st = mamba_run(x, mamba[n_super * every:])
    states += st
    if unembed_last_only:
        x = x[:, -1:]
    logits = dense.unembed(cfg, params, x)
    if not collect_kv:
        return logits, 0.0, None
    convs, ssms = zip(*states)
    collected = (torch.stack(convs), torch.stack(ssms))
    if ks:
        collected += (torch.stack(ks), torch.stack(vs))
    return logits, 0.0, collected


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    s = cfg.ssm
    L = cfg.n_layers
    n_super, _, _ = _split_counts(cfg)
    conv_ch = s.heads * s.head_dim + 2 * s.state_dim
    cache = {
        "conv": torch.zeros((L, batch, s.conv_dim - 1, conv_ch), dtype=torch.bfloat16, device=device),
        "ssm": torch.zeros((L, batch, s.heads, s.head_dim, s.state_dim), dtype=torch.float32, device=device),
        "length": 0,
    }
    if n_super:
        kv = (n_super, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache["attn_k"] = torch.zeros(kv, dtype=torch.bfloat16, device=device)
        cache["attn_v"] = torch.zeros(kv, dtype=torch.bfloat16, device=device)
    return cache


def cache_heads(cfg: ModelConfig):
    """A split prefill cache's entries that hold this rank's KV heads (the
    shared block's; the conv and SSM states are whole):
    {name: (heads dim, each rank's [start, stop))}."""
    if not cfg.shared_attn_every:
        return {}
    ranges = dense.kv_head_ranges(cfg, "shared_attn.")
    return {"attn_k": (3, ranges), "attn_v": (3, ranges)}


def cache_pspec():
    return {
        "conv": P(None, ("pod", "data"), None, None),
        "ssm": P(None, ("pod", "data"), None, None, None),
        "attn_k": P(None, ("pod", "data"), "model", None, None),
        "attn_v": P(None, ("pod", "data"), "model", None, None),
        "length": P(),
    }


def decode_step(cfg: ModelConfig, params: Params, cache: Dict[str, Any], tokens: torch.Tensor, pos: int):
    """One token through the Mamba layers and the shared block. Returns
    (logits (B, V), cache); every state is written IN PLACE."""
    x = dense.embed_tokens(params, tokens)  # (B, 1, d)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    shared = sub_params(params, "shared_attn")
    mamba = layer_stack(params, "mamba")
    for kind, i in _schedule(cfg):
        if kind == "mamba":
            x, conv, ssm = _mamba_layer(cfg, mamba[i], x, cache["conv"][i], cache["ssm"][i])
            conv, ssm = _whole_states(cfg, conv, ssm)
            cache["conv"][i] = conv
            cache["ssm"][i] = ssm
        else:
            x, _ = _shared_attn_block(cfg, shared, x, positions, kv_cache=(cache["attn_k"][i], cache["attn_v"][i]),
                                      pos=pos)
    logits = dense.unembed(cfg, params, x)[:, 0]
    cache["length"] = pos + 1
    return logits, cache
