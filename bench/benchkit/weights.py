"""Weights drawn from the seed, in the flat dotted layout the program's
``ModelSpec`` takes (``embed``, ``blocks.wq``, ...; per-layer leaves stacked
on a leading layers axis).

The layout is written here from the configuration, not read from the
program, so the yardstick does not move with it; a CPU test holds it equal
to the program's schema. All normal leaves are drawn by ONE ``torch.randn``
into one buffer of the served dtype on the card, then scaled leaf by leaf in
place: a 13.8 GB draw is one call.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# (name, shape, init, scale): init "normal" (scale None: 1/sqrt(fan_in), the
# first non-layer dim), "ones"
Leaf = Tuple[str, Tuple[int, ...], str, float]


def layout(model: dict) -> List[Leaf]:
    """Every leaf of a decoder (``family`` dense or moe) in sorted name order."""
    L, d, V = model["n_layers"], model["d_model"], model["vocab"]
    H, KV, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    leaves: List[Leaf] = [
        ("embed", (V, d), "normal", 0.02),
        ("final_norm", (d,), "ones", 1.0),
        ("blocks.attn_norm", (L, d), "ones", 1.0),
        ("blocks.mlp_norm", (L, d), "ones", 1.0),
        ("blocks.wq", (L, d, H * hd), "normal", None),
        ("blocks.wk", (L, d, KV * hd), "normal", None),
        ("blocks.wv", (L, d, KV * hd), "normal", None),
        ("blocks.wo", (L, H * hd, d), "normal", None),
    ]
    if model.get("qk_norm"):
        leaves += [("blocks.q_norm", (L, hd), "ones", 1.0), ("blocks.k_norm", (L, hd), "ones", 1.0)]
    moe = model.get("moe")
    if moe:
        E, f = moe["num_experts"], moe["d_ff_expert"]
        leaves += [
            ("blocks.router", (L, d, E), "normal", 0.02),
            ("blocks.we_gate", (L, E, d, f), "normal", None),
            ("blocks.we_up", (L, E, d, f), "normal", None),
            ("blocks.we_down", (L, E, f, d), "normal", None),
        ]
    else:
        Ff = model["d_ff"]
        leaves += [
            ("blocks.w_gate", (L, d, Ff), "normal", None),
            ("blocks.w_up", (L, d, Ff), "normal", None),
            ("blocks.w_down", (L, Ff, d), "normal", None),
        ]
    if not model.get("tie_embeddings"):
        leaves.append(("lm_head", (d, V), "normal", 0.02))
    return sorted(leaves)


def _scale(name: str, shape, scale) -> float:
    if scale is not None:
        return scale
    fan_in = shape[1] if name.startswith("blocks.") else shape[0]
    if name.startswith("blocks.we_"):  # (L, E, in, out)
        fan_in = shape[2]
    return 1.0 / math.sqrt(fan_in)


def param_bytes(model: dict, dtype=torch.bfloat16) -> int:
    es = torch.empty((), dtype=dtype).element_size()
    return sum(math.prod(shape) for _, shape, _, _ in layout(model)) * es


def draw(model: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The parameters for ``seed``: normal leaves N(0, 1) x scale from one
    draw on ``device``, norms one."""
    leaves = layout(model)
    normal = [(n, s, sc) for n, s, init, sc in leaves if init == "normal"]
    total = sum(math.prod(s) for _, s, _ in normal)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(total, generator=gen, dtype=dtype, device=device)
    params, at = {}, 0
    for name, shape, scale in normal:
        n = math.prod(shape)
        params[name] = buf[at:at + n].view(shape).mul_(_scale(name, shape, scale))
        at += n
    for name, shape, init, _ in leaves:
        if init == "ones":
            params[name] = torch.ones(shape, dtype=dtype, device=device)
    return {name: params[name] for name, _, _, _ in leaves}
