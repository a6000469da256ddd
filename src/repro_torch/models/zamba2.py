"""The published Zamba2 block, family "zamba2" (``configs.Zamba2Config``;
Zamba2-7B-Instruct). The "hybrid" family (``models/mamba2.py``) is the JAX
package's simplified Zamba2 and stays as it is.

Per layer i of ``n_layers`` Mamba2 layers, x0 the token embeddings:
  at a hybrid site (i = ``hybrid_layer_ids[j]``; shared block b = j mod
  ``num_mem_blocks``):
    u = RMSNorm_b(concat(x, x0))                       (2 d wide)
    a = attn_b(u) Wo_b     RoPE on q and k, scores (hd / 2)^-1/2
    h = RMSNorm_b,ff(a);   g | up = h Wgu_b + (h A_j) B_j   (site j's adapter)
    t = (act(g) up) Wdown_b Wlin_j;   m = x + t       (the block has no residual)
  elsewhere m = x;
  x = x + Mamba2_i(RMSNorm_i(m))                        (the residual is x, not m)
then the final norm and the tied embedding. Mamba2: z | xBC | dt = u W_in;
xBC = silu(conv(xBC) + bias); dt = softplus(dt + dt_bias); A = -exp(A_log);
S = exp(dt A) S + dt x B; y = C.S + D x, head h reading B and C of group
h // (H / G); y silu(z), RMS-normalised per group; y W_out.

Prefill (``forward``) runs the chunked SSD on ``kernels/ssd_scan`` (one launch a
layer; its plain version is ``mamba2.ssd_chunked``, grouped) and the shared
blocks' attention on ``flash_attention``; the score scale is
folded into q (q x sqrt(2) before the kernels' 1/sqrt(hd)).
With ``collect_kv`` it returns the sites' K/V (after RoPE) and each layer's
conv window and SSM state. Decoding runs in ``core/tiering.py`` over the
tiered KV of the sites and per-request state slots, on ``decode_mamba``
(``kernels/mamba_step``) and ``block_ffn``.

Under a running torch.profiler each Mamba layer opens the function-scope
range ``model.mamba`` and each shared-block invocation ``model.shared_attn``
(args ``site=<j>``); with no profiler they open nothing.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch._C._profiler import _RecordFunctionFast

from repro_torch.configs import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.mamba_step.ops import mamba_step, rms_norm_rows
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models import dense
from repro_torch.models.common import Leaf, Params, layer_stack, stacked
from repro_torch.models.layers import AttnParams, project_qkv
from repro_torch.models.mamba2 import causal_conv

_OFF = contextlib.nullcontext()


def span(on: bool, name: str, args: str = ""):
    """The host range ``name`` when a profiler runs (``on``), else a no-op."""
    return _RecordFunctionFast(name, (), {"args": args}) if on else _OFF


def widths(cfg: ModelConfig):
    """(H, P, N, G, W, inner, conv channels C) of the Mamba layers."""
    s = cfg.ssm
    H, P, N, G = s.heads, s.head_dim, s.state_dim, cfg.ssm_groups
    inner = H * P
    return H, P, N, G, s.conv_dim, inner, inner + 2 * G * N


def schema(cfg: ModelConfig) -> Dict[str, Any]:
    d, V, L, Ff = cfg.d_model, cfg.vocab, cfg.n_layers, cfg.d_ff
    H, P, N, G, W, inner, C = widths(cfg)
    nb, ns, q = cfg.num_mem_blocks, len(cfg.hybrid_layer_ids), cfg.n_heads * cfg.resolved_head_dim
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    mamba = {
        "norm": stacked(L, (d,), (None,), init="ones"),
        "in_proj": stacked(L, (d, 2 * inner + 2 * G * N + H), ("embed", None)),
        "conv_w": stacked(L, (C, W), (None, None), scale=0.3),
        "dt_bias": stacked(L, (H,), (None,), init="zeros"),
        "A_log": stacked(L, (H,), (None,), init="zeros"),
        "D": stacked(L, (H,), (None,), init="ones"),
        "norm_y": stacked(L, (inner,), (None,), init="ones"),
        "out_proj": stacked(L, (inner, d), (None, "embed")),
    }
    if cfg.conv_bias:
        mamba["conv_b"] = stacked(L, (C,), (None,), init="zeros")
    shared = {
        "attn_norm": stacked(nb, (2 * d,), (None,), init="ones"),
        "wq": stacked(nb, (2 * d, q), (None, "heads")),
        "wk": stacked(nb, (2 * d, kv), (None, "kv")),
        "wv": stacked(nb, (2 * d, kv), (None, "kv")),
        "wo": stacked(nb, (q, d), ("heads", "embed")),
        "ffn_norm": stacked(nb, (d,), (None,), init="ones"),
        "w_gate_up": stacked(nb, (d, 2 * Ff), ("embed", "ffn")),
        "w_down": stacked(nb, (Ff, d), ("ffn", "embed")),
    }
    sites = {"linear": stacked(ns, (d, d), ("embed", None))}
    if cfg.adapter_rank:
        sites["adapter_in"] = stacked(ns, (d, cfg.adapter_rank), ("embed", None))
        sites["adapter_out"] = stacked(ns, (cfg.adapter_rank, 2 * Ff), (None, "ffn"))
    s: Dict[str, Any] = {
        "embed": Leaf((V, d), ("vocab", "embed"), scale=0.02),
        "final_norm": Leaf((d,), (None,), init="ones"),
        "mamba": mamba,
        "shared": shared,
        "sites": sites,
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = Leaf((d, V), ("embed", "vocab"), scale=0.02)
    return s


def attention_calls(cfg: ModelConfig) -> int:
    """Shared-block invocations a token: the K/V caches the tiers hold."""
    return len(cfg.hybrid_layer_ids)


def scale_q(q: torch.Tensor) -> torch.Tensor:
    """q x sqrt(2): the attention kernels' 1/sqrt(hd) then scales the scores
    by (hd / 2)^-1/2, Zamba2's attention scale (rounded once, in q's dtype)."""
    return q * math.sqrt(2)


def norm_rows(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """``layers.rmsnorm`` over the last dim of x (..., d) as rows of one
    ``rms_norm_rows`` launch on the card."""
    return rms_norm_rows(x.reshape(-1, x.shape[-1]), gamma, eps).view(x.shape)


def block_ffn(cfg: ModelConfig, p: Params, site: Params, a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """m = x + t: the shared block after its attention output ``a`` (norm,
    the gated FFN with the site's adapter on the gate/up projection, the
    site's linear) added to the residual stream x, rows flattened so that
    the adds ride on the matmuls (``addmm``)."""
    d = x.shape[-1]
    h = norm_rows(a.reshape(-1, d), p["ffn_norm"], cfg.norm_eps)
    gu = h @ p["w_gate_up"]
    if "adapter_in" in site:
        gu = torch.addmm(gu, h @ site["adapter_in"], site["adapter_out"])
    g, up = gu.chunk(2, dim=-1)
    act = F.gelu(g) if cfg.ffn_act == "gelu" else F.silu(g)  # in fp32, rounded once
    return torch.addmm(x.reshape(-1, d), (act * up) @ p["w_down"], site["linear"]).view(x.shape)


def _shared_block(cfg: ModelConfig, p: Params, site: Params, x, x0, positions):
    """Prefill of one invocation: (m = x + t, (k, v)), k after RoPE."""
    u = norm_rows(torch.cat([x, x0], dim=-1), p["attn_norm"], cfg.norm_eps)
    q, k, v = project_qkv(cfg, AttnParams(wq=p["wq"], wk=p["wk"], wv=p["wv"], wo=p["wo"]), u, positions)
    o = flash_attention(scale_q(q), k, v, causal=True)
    a = o.reshape(*o.shape[:2], -1) @ p["wo"]
    return block_ffn(cfg, p, site, a, x), (k, v)


def _gated_norm(cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """y silu(z), RMS-normalised over each of the G groups, times w; fp32 in."""
    G = cfg.ssm_groups
    y = y * F.silu(z.float())
    yg = y.view(*y.shape[:-1], G, -1)
    yg = yg * torch.rsqrt((yg * yg).mean(-1, keepdim=True) + 1e-5)
    return (yg.reshape(y.shape) * w.float()).to(dtype)


def _mamba_prefill(cfg: ModelConfig, p: Params, h: torch.Tensor):
    """One Mamba2 mixer over a whole sequence from zero states: (out, conv
    window (B, W-1, C), SSM state (B, H, P, N))."""
    H, P, N, G, W, inner, C = widths(cfg)
    B, S, _ = h.shape
    z, xbc, dt_raw = (h @ p["in_proj"]).split([inner, C, H], dim=-1)
    cv = causal_conv(xbc, p["conv_w"], bias=p.get("conv_b"))
    window = F.pad(xbc, (0, 0, W - 1, 0))[:, -(W - 1):]
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    loga = dt * -torch.exp(p["A_log"].float())
    y, state = ssd_scan(cv, dt, loga, p["D"], heads=H, groups=G, state_dim=N, chunk=cfg.ssm.chunk)
    return _gated_norm(cfg, y, z, p["norm_y"], h.dtype) @ p["out_proj"], window, state


def decode_mamba(cfg: ModelConfig, p: Params, x: torch.Tensor, m: torch.Tensor, conv_state, ssm_state,
                 req_ids) -> torch.Tensor:
    """One decode token of Mamba layer ``p``: x (B, d) plus the mixer's
    output over m (B, d), the residual added by the out-projection's
    ``addmm``; the rows' slots of ``conv_state`` / ``ssm_state`` (this
    layer's) updated in place. Four launches."""
    zxbcdt = rms_norm_rows(m, p["norm"], cfg.norm_eps) @ p["in_proj"]
    y = mamba_step(zxbcdt, conv_state, ssm_state, p["conv_w"], p.get("conv_b"), p["dt_bias"], p["A_log"], p["D"],
                   p["norm_y"], req_ids, groups=cfg.ssm_groups)
    return torch.addmm(x, y, p["out_proj"])


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, frontend=None, *, remat: bool = True,
            collect_kv: bool = False, unembed_last_only: bool = False):
    """Returns (logits, 0.0, states or None): states (k, v) of the sites,
    each (n_sites, B, S, KV, hd), then conv (L, B, W-1, C) and ssm (L, B, H,
    P, N). Inference only: ``remat`` is accepted and unused."""
    on = torch.autograd._profiler_enabled()
    x0 = dense.embed_tokens(params, tokens)
    B, S, _ = x0.shape
    positions = torch.arange(S, device=x0.device)[None].expand(B, S)
    shared, sites = layer_stack(params, "shared"), layer_stack(params, "sites")
    site_of = {layer: j for j, layer in enumerate(cfg.hybrid_layer_ids)}
    x, ks, vs, convs, ssms = x0, [], [], [], []
    for i, p in enumerate(layer_stack(params, "mamba")):
        m = x
        if i in site_of:
            j = site_of[i]
            with span(on, "model.shared_attn", f"site={j}" if on else ""):
                m, (k, v) = _shared_block(cfg, shared[j % cfg.num_mem_blocks], sites[j], x, x0, positions)
            ks.append(k)
            vs.append(v)
        with span(on, "model.mamba"):
            out, window, state = _mamba_prefill(cfg, p, norm_rows(m, p["norm"], cfg.norm_eps))
        x = x + out
        if collect_kv:
            convs.append(window)
            ssms.append(state)
    if unembed_last_only:
        x = x[:, -1:]
    logits = dense.unembed(cfg, params, x)
    if not collect_kv:
        return logits, 0.0, None
    return logits, 0.0, (torch.stack(ks), torch.stack(vs), torch.stack(convs), torch.stack(ssms))
