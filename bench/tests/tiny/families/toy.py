"""A toy family for the CPU tests: the tiny dense decoder the program serves,
with a weight layout, a FLOP count and a plain reference of its own, written
apart from the decoder family's. Its configuration names it by
``"family_module": "toy"``; nothing outside ``tests/tiny/`` knows it.

The reference runs in float64: RMSNorm and causal grouped-query attention
from ``torch.nn.functional``, RoPE as a complex rotation of the two halves
of each head.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F


def _matrices(model: dict) -> Dict[str, Tuple[int, int]]:
    """(input, output) width of each layer's matrix."""
    d, Ff = model["d_model"], model["d_ff"]
    q, kv = model["n_heads"] * model["head_dim"], model["n_kv_heads"] * model["head_dim"]
    return {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d),
            "w_gate": (d, Ff), "w_up": (d, Ff), "w_down": (Ff, d)}


def layout(model: dict) -> List[tuple]:
    """The leaves in this family's own order (layer matrices first)."""
    L, d, V, hd = model["n_layers"], model["d_model"], model["vocab"], model["head_dim"]
    leaves = [(f"blocks.{n}", (L, i, o), "normal", 1.0 / math.sqrt(i)) for n, (i, o) in _matrices(model).items()]
    leaves += [("embed", (V, d), "normal", 0.02), ("final_norm", (d,), "ones", 1.0),
               ("blocks.attn_norm", (L, d), "ones", 1.0), ("blocks.mlp_norm", (L, d), "ones", 1.0)]
    if model["qk_norm"]:
        leaves += [("blocks.q_norm", (L, hd), "ones", 1.0), ("blocks.k_norm", (L, hd), "ones", 1.0)]
    if not model["tie_embeddings"]:
        leaves.append(("lm_head", (d, V), "normal", 0.02))
    return leaves


def program_config(name: str, model: dict):
    from repro_torch.configs import ModelConfig

    return ModelConfig(name=name, **model)


def decode_flops(model: dict, contexts) -> float:
    """2 x the layers' matrices and the logits' a token, 4 x H x hd a
    position attended a layer."""
    L, d, V = model["n_layers"], model["d_model"], model["vocab"]
    matmul = L * sum(i * o for i, o in _matrices(model).values()) + d * V
    per_position = 4 * L * model["n_heads"] * model["head_dim"]
    return float(sum(2 * matmul + per_position * c for c in contexts))


def attention_calls(model: dict) -> Dict[str, int]:
    return {"paged_attention": model["n_layers"], "flash_attention": model["n_layers"]}


def replays_batches(model: dict) -> bool:
    return False


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd) float64, position i rotated by i x theta^(-2j/hd)."""
    S, _, hd = x.shape
    freq = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64) / hd)
    angle = torch.arange(S, dtype=torch.float64)[:, None] * freq
    turn = torch.polar(torch.ones_like(angle), angle)
    z = torch.complex(x[..., :hd // 2], x[..., hd // 2:]) * turn[:, None, :]
    return torch.cat([z.real, z.imag], -1)


@torch.no_grad()
def logits(model: dict, params: Dict[str, torch.Tensor], tokens: List[int], rope: bool = True) -> torch.Tensor:
    """Causal forward of one sequence -> logits (S, V), float64."""
    w = {k: v.double().cpu() for k, v in params.items()}
    d, H, KV, hd, eps = model["d_model"], model["n_heads"], model["n_kv_heads"], model["head_dim"], model["norm_eps"]
    S = len(tokens)
    x = w["embed"][torch.as_tensor(tokens)]
    for l in range(model["n_layers"]):
        h = F.rms_norm(x, (d,), w["blocks.attn_norm"][l], eps)
        q, k, v = (h @ w[f"blocks.{n}"][l] for n in ("wq", "wk", "wv"))
        q, k, v = q.view(S, H, hd), k.view(S, KV, hd), v.view(S, KV, hd)
        if model["qk_norm"]:
            q = F.rms_norm(q, (hd,), w["blocks.q_norm"][l], eps)
            k = F.rms_norm(k, (hd,), w["blocks.k_norm"][l], eps)
        if rope:
            q, k = _rope(q, model["rope_theta"]), _rope(k, model["rope_theta"])
        o = F.scaled_dot_product_attention(q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1),
                                           is_causal=True, enable_gqa=True)
        x = x + o.transpose(0, 1).reshape(S, H * hd) @ w["blocks.wo"][l]
        h = F.rms_norm(x, (d,), w["blocks.mlp_norm"][l], eps)
        x = x + (F.silu(h @ w["blocks.w_gate"][l]) * (h @ w["blocks.w_up"][l])) @ w["blocks.w_down"][l]
    head = w["embed"].T if model["tie_embeddings"] else w["lm_head"]
    return F.rms_norm(x, (d,), w["final_norm"], eps) @ head


def checked_gaps(run, ctx, control: bool = False, rope: bool = True):
    """The first ``check.requests`` finished requests and the longest: the
    gap of each served token below the reference's best. No control."""
    done = [r for r in run.rec["requests"] if not r["failed"] and r["req"].done]
    if not done:
        return None, {"reason": "no finished request"}
    items = done[:ctx.cell["check"]["requests"]]
    longest = max(done, key=lambda r: len(r["req"].out))
    if all(r is not longest for r in items):
        items.append(longest)
    gaps: List[float] = []
    for r in items:
        served = list(r["req"].out)
        lg = logits(ctx.model, run.params, r["prompt"] + served[:-1], rope)[len(r["prompt"]) - 1:]
        gaps += (lg.max(-1).values - lg[torch.arange(len(served)), torch.as_tensor(served)]).tolist()
    return {"program": gaps, "control": []}, {"requests": len(items), "tokens": len(gaps)}
