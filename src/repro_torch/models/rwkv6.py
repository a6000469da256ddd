"""RWKV6 ("Finch"): attention-free linear recurrence with data-dependent
decay, family "ssm" (port of ``repro/models/rwkv6.py``).

Within a chunk of C tokens the recurrence (state per head: K x V)

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t . (S_{t-1} + (u o k_t) v_t^T)

is evaluated from cumulative log-decay differences, which are <= 0 for every
pair that counts, so no exp overflows; a Python loop over chunks carries the
state (JAX's ``lax.scan``). Decode runs the same ``time_mix`` with chunks of
one token. The recurrence is fp32, the projections bf16. Plain PyTorch: the
JAX code is a scan, not a Pallas kernel.

In a split step (``layers.split_compute``) the time mix runs on the rank's
heads where "model" divides them (``_head_route``): ``w_r``/``w_k``/
``w_v``/``w_g`` and ``w_lora_b`` column-parallel, ``w_lora_a`` replicated,
``w0``, ``u`` and ``ln_x`` sliced to the rank's heads (their gradients
summed over "model"), the recurrence and the per-head group norm local,
``w_o`` row-parallel. Where "model" cuts a head, every rank computes every
head (the split projections gathered). The channel mix: ``w_ck``
column-parallel, ``w_cv`` row-parallel, ``w_cr`` replicated. The WKV state
(prefill's and the decode cache's, by ``cache_pspec``) holds the rank's
heads; the token shifts are whole on every rank.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.distributed.sharding import P, head_route
from repro_torch.models import dense
from repro_torch.models.common import Leaf, Params, layer_stack, maybe_remat, stacked
from repro_torch.models.layers import model_split, rmsnorm, split_model, use_weights

LORA = 64  # low-rank width of the data-dependent decay projection


def schema(cfg: ModelConfig) -> Dict[str, Any]:
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    s = cfg.ssm
    inner = s.heads * s.head_dim
    Ff = cfg.d_ff
    return {
        "embed": Leaf((V, d), ("vocab", "embed"), scale=0.02),
        "final_norm": Leaf((d,), (None,), init="ones"),
        "lm_head": Leaf((d, V), ("embed", "vocab"), scale=0.02),
        "blocks": {
            "attn_norm": stacked(L, (d,), (None,), init="ones"),
            # token-shift lerp coefficients for (r, k, v, g, w)
            "mu": stacked(L, (5, d), (None, None), init="zeros"),
            "w_r": stacked(L, (d, inner), ("embed", "inner")),
            "w_k": stacked(L, (d, inner), ("embed", "inner")),
            "w_v": stacked(L, (d, inner), ("embed", "inner")),
            "w_g": stacked(L, (d, inner), ("embed", "inner")),
            "w_o": stacked(L, (inner, d), ("inner", "embed")),
            # data-dependent decay: w_t = exp(-exp(w0 + tanh(x W_a) W_b))
            "w0": stacked(L, (inner,), (None,), init="zeros"),
            "w_lora_a": stacked(L, (d, LORA), ("embed", None)),
            "w_lora_b": stacked(L, (LORA, inner), (None, "inner"), scale=0.01),
            # per-head bonus for the current token
            "u": stacked(L, (s.heads, s.head_dim), (None, None), init="zeros"),
            "ln_x": stacked(L, (inner,), (None,), init="ones"),
            # channel mix
            "mlp_norm": stacked(L, (d,), (None,), init="ones"),
            "mu_c": stacked(L, (2, d), (None, None), init="zeros"),
            "w_ck": stacked(L, (d, Ff), ("embed", "ffn")),
            "w_cv": stacked(L, (Ff, d), ("ffn", "embed")),
            "w_cr": stacked(L, (d, d), ("embed", None)),
        },
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d); prev: (B, 1, d) the last token of the previous segment."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu  # mu=0 -> x (identity), mu=1 -> shifted


def wkv_chunked(
    r: torch.Tensor,  # (B, S, H, K) fp32
    k: torch.Tensor,  # (B, S, H, K)
    v: torch.Tensor,  # (B, S, H, V)
    logw: torch.Tensor,  # (B, S, H, K) <= 0
    u: torch.Tensor,  # (H, K)
    state0: torch.Tensor,  # (B, H, K, V)
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact chunked WKV. Returns (y (B, S, H, V), state (B, H, K, V))."""
    B, S, H, K = r.shape
    Vd = v.shape[-1]
    C = min(chunk, S)
    pad = (-S) % C
    if pad:  # padded tokens: r = k = v = 0 and logw = 0 (w = 1)
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, logw))
    N = r.shape[1] // C

    def to_chunks(t):
        return t.reshape(B, N, C, H, -1).permute(1, 0, 3, 2, 4)  # (N, B, H, C, ·)

    rc, kc, vc, wc = map(to_chunks, (r, k, v, logw))
    idx = torch.arange(C, device=r.device)
    strict = (idx[:, None] > idx[None, :])[None, None, :, :, None]  # j < i
    state = state0.float()
    ys = []
    for n in range(N):
        rb, kb, vb, wb = rc[n], kc[n], vc[n], wc[n]  # (B, H, C, K or V)
        cum = torch.cumsum(wb, dim=2)  # log W_i (inclusive)
        cum_prev = cum - wb  # log W_{i-1} (exclusive)
        # scores_ij = sum_k r_ik k_jk exp(cum_prev_ik - cum_jk) for j < i; the
        # mask is -inf before the exp, so masked pairs are exactly 0
        diff = cum_prev[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, H, C, C, K)
        decay = torch.exp(torch.where(strict, diff, float("-inf")))
        scores = (rb[:, :, :, None, :] * decay * kb[:, :, None, :, :]).sum(-1)  # (B, H, C, C)
        # the current token's bonus: r_i . (u o k_i), a separate term
        bonus = (rb * u[None, :, None, :] * kb).sum(-1)  # (B, H, C)
        y = scores @ vb + bonus[..., None] * vb
        # the initial state's share: r_i diag(exp(cum_prev_i)) S0
        y = y + (rb * torch.exp(cum_prev)) @ state
        # S' = diag(exp(cum_C)) S0 + sum_j exp(cum_C - cum_j) k_j v_j^T
        total = cum[:, :, -1:, :]  # (B, H, 1, K)
        kd = kb * torch.exp(total - cum)
        state = torch.exp(total[:, :, 0, :, None]) * state + kd.transpose(-1, -2) @ vb
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, N * C, H, Vd)
    return y[:, :S], state


def _head_route(cfg: ModelConfig, index=None):
    """The recurrent heads "model" rank ``index`` (default: this rank)
    computes in a split step: "local" (its shard of the "inner" columns is
    whole heads) or "replicated" (the split cuts a head, or does not split
    "inner": every rank computes every head)."""
    tp = split_model()
    H = cfg.ssm.heads
    return head_route(H, H, tp.size, tp.index if index is None else index,
                      model_split("blocks.w_r", -1) is not None, True)


def cache_heads(cfg: ModelConfig):
    """A split prefill cache's entries that hold this rank's heads:
    {name: (heads dim, each rank's [start, stop))}."""
    return {"wkv": (2, tuple(_head_route(cfg, i).q for i in range(split_model().size)))}


def _projections(cfg: ModelConfig, p: Params, xr, xk, xv, xg, xw):
    """(r, k, v, the gate's pre-activation, the decay's LoRA, w0, u, ln_x,
    the output projection) of the heads this rank computes: every head
    outside a split step and on the "replicated" route (the split
    projections gathered), the rank's heads on the "local" route."""
    tp = split_model()
    route = None if tp is None else _head_route(cfg)
    if route is None or route.route == "replicated":
        w = dict(p)
        if route is not None:
            for name, dim in (("w_r", -1), ("w_k", -1), ("w_v", -1), ("w_g", -1), ("w_lora_b", -1), ("w_o", 0)):
                if model_split(f"blocks.{name}", dim) is not None:
                    w[name] = tp.gather(p[name], dim, partial_grad=False)
        dlr = torch.tanh(xw @ w["w_lora_a"]) @ w["w_lora_b"]  # bf16
        return (xr @ w["w_r"], xk @ w["w_k"], xv @ w["w_v"], xg @ w["w_g"], dlr, w["w0"], w["u"], w["ln_x"],
                lambda y: y @ w["w_o"])
    (r,), (k,), (v,), (g,) = (tp.column_parallel(x, p[n]) for x, n in ((xr, "w_r"), (xk, "w_k"), (xv, "w_v"),
                                                                          (xg, "w_g")))
    (dlr,) = tp.column_parallel(torch.tanh(xw @ p["w_lora_a"]), p["w_lora_b"])
    K = cfg.ssm.head_dim
    h0, h1 = route.q
    cols = slice(h0 * K, h1 * K)  # the replicated leaves' rows of this rank's heads; their gradients summed
    return (r, k, v, g, dlr, tp.copy(p["w0"])[cols], tp.copy(p["u"])[h0:h1], tp.copy(p["ln_x"])[cols],
            lambda y: tp.row_parallel(y, p["w_o"]))


def time_mix(cfg: ModelConfig, p: Params, x: torch.Tensor, prev: torch.Tensor, state0: torch.Tensor,
             chunk: int = 64):
    """RWKV6 time mix over a segment. Returns (out, last x, state); in a
    split step ``state0`` and the state are of the heads this rank
    computes."""
    s = cfg.ssm
    B, S, _ = x.shape
    xs = _token_shift(x, prev)
    xr, xk, xv, xg, xw = (_lerp(x, xs, p["mu"][i]) for i in range(5))
    r, k, v, g, dlr, w0, u, ln_x, out_proj = _projections(cfg, p, xr, xk, xv, xg, xw)
    g = F.silu(g.float())
    logw = -torch.exp(torch.clamp((w0 + dlr).float(), -10.0, 5.0))

    def heads(t):
        return t.reshape(B, S, -1, s.head_dim).float()

    y, state = wkv_chunked(heads(r), heads(k), heads(v), heads(logw), u.float(), state0, chunk)
    # per-head group norm (gain only; eps 1e-5, not cfg.norm_eps), then the gate
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-5)
    y = (y.reshape(B, S, -1) * ln_x.float()) * g
    return out_proj(y.to(x.dtype)), x[:, -1:], state


def channel_mix(cfg: ModelConfig, p: Params, x: torch.Tensor, prev: torch.Tensor):
    """RWKV6 channel mix. Returns (out, last x). In a split step ``w_ck``
    is column-parallel and ``w_cv`` row-parallel; the receptance ``w_cr``
    is computed whole on every rank."""
    xs = _token_shift(x, prev)
    xk = _lerp(x, xs, p["mu_c"][0])
    xr = _lerp(x, xs, p["mu_c"][1])
    tp = model_split("blocks.w_ck", -1)
    k = xk @ p["w_ck"] if tp is None else tp.column_parallel(xk, p["w_ck"])[0]
    k = torch.square(F.relu(k.float())).to(x.dtype)
    kv = k @ p["w_cv"] if tp is None else tp.row_parallel(k, p["w_cv"])
    rgate = torch.sigmoid((xr @ p["w_cr"]).float())
    return (rgate * kv.float()).to(x.dtype), x[:, -1:]


def _layer(cfg: ModelConfig, p: Params, x, tm_prev, cm_prev, state, chunk: int):
    p = use_weights(p, "blocks")
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    out, last_tm, state = time_mix(cfg, p, h, tm_prev, state, chunk)
    x = x + out
    h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    out, last_cm = channel_mix(cfg, p, h, cm_prev)
    return x + out, last_tm, last_cm, state


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
    """Full-sequence forward from a zero state. Returns (logits, 0.0,
    (tm_prev (L, B, 1, d), cm_prev (L, B, 1, d), wkv (L, B, H, K, V)) or
    None; in a split step wkv of the heads this rank computes). ``remat``:
    each layer is recomputed in the backward (JAX's ``jax.checkpoint`` of
    the layer body)."""
    s = cfg.ssm
    x = dense.embed_tokens(params, tokens)
    B, _, d = x.shape
    zero_prev = torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
    route = None if split_model() is None else _head_route(cfg)
    heads = s.heads if route is None else route.q[1] - route.q[0]
    zero_state = torch.zeros((B, heads, s.head_dim, s.head_dim), dtype=torch.float32, device=x.device)
    tms, cms, sts = [], [], []
    for p in layer_stack(params):
        x, tm, cm, st = maybe_remat(_layer, remat, cfg, p, x, zero_prev, zero_prev, zero_state, s.chunk)
        if collect_kv:
            tms.append(tm)
            cms.append(cm)
            sts.append(st)
    if unembed_last_only:
        x = x[:, -1:]
    logits = dense.unembed(cfg, params, x)
    collected = (torch.stack(tms), torch.stack(cms), torch.stack(sts)) if collect_kv else None
    return logits, 0.0, collected


# ---------------------------------------------------------------------------
# decode: the O(1) state recurrence
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """The recurrent state: fp32 WKV state and the last token of each mix
    (no per-position cache: ``max_len`` is not used)."""
    s = cfg.ssm
    L, d = cfg.n_layers, cfg.d_model
    return {
        "wkv": torch.zeros((L, batch, s.heads, s.head_dim, s.head_dim), dtype=torch.float32, device=device),
        "tm_prev": torch.zeros((L, batch, 1, d), dtype=torch.bfloat16, device=device),
        "cm_prev": torch.zeros((L, batch, 1, d), dtype=torch.bfloat16, device=device),
        "length": 0,
    }


def cache_pspec():
    return {
        "wkv": P(None, ("pod", "data"), "model", None, None),
        "tm_prev": P(None, ("pod", "data"), None, None),
        "cm_prev": P(None, ("pod", "data"), None, None),
        "length": P(),
    }


def decode_step(cfg: ModelConfig, params: Params, cache: Dict[str, Any], tokens: torch.Tensor, pos: int):
    """One token through the recurrence: ``time_mix`` with chunks of one
    token, so decode is the prefill's function. Returns (logits (B, V),
    cache); the state is written IN PLACE. In a split step the cache is
    this rank's: its rows, and the WKV state of its heads where
    ``cache_pspec`` splits them (the route's heads)."""
    x = dense.embed_tokens(params, tokens)  # (B, 1, d)
    for layer, p in enumerate(layer_stack(params)):
        x, tm, cm, st = _layer(cfg, p, x, cache["tm_prev"][layer],
                               cache["cm_prev"][layer], cache["wkv"][layer], chunk=1)
        cache["tm_prev"][layer] = tm
        cache["cm_prev"][layer] = cm
        cache["wkv"][layer] = st
    logits = dense.unembed(cfg, params, x)[:, 0]
    cache["length"] = pos + 1
    return logits, cache
