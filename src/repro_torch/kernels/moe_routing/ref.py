"""Plain PyTorch versions of the capacity MoE's routing glue: what the CPU
and the meta device run, what the card's kernels (``ops.py``) are held to,
and what their backward differentiates. ``models/layers.py`` documents
each function; the JAX package's counterpart is the body of
``repro/models/layers.py::moe_ffn``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def moe_route(m, xt: torch.Tensor, w_router: torch.Tensor):
    """(fp32 logits, probs, renormalised top-k gates, ids int64); ``m`` the
    layer's ``MoEConfig``."""
    return route(xt @ w_router, m.top_k)


def route(raw: torch.Tensor, k: int):
    """``moe_route`` after the router's matmul: ``raw`` its (T, E) logits."""
    logits = raw.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = gate_vals[:, :k], idx[:, :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    return logits, probs, gate_vals, idx


def moe_slots(idx: torch.Tensor, num_experts: int, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos (T, k) int64, keep (T, k) bool) by a cumsum down the one-hot."""
    T, k = idx.shape
    flat = F.one_hot(idx, num_experts).to(torch.int32).reshape(T * k, num_experts)
    pos = (torch.cumsum(flat, dim=0) * flat - 1).amax(dim=-1).reshape(T, k)
    return pos, (pos < cap) & (pos >= 0)


def moe_dispatch(xt: torch.Tensor, idx, pos, keep, num_experts: int, cap: int) -> torch.Tensor:
    """(E, cap, d) buffers by an index write onto zeros (a spare row for drops)."""
    d, k = xt.shape[1], idx.shape[1]
    dest = torch.where(keep, idx * cap + pos, num_experts * cap).reshape(-1)
    buf = torch.zeros((num_experts * cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf[dest] = xt[:, None].expand(-1, k, -1).reshape(-1, d)
    return buf[: num_experts * cap].view(num_experts, cap, d)


def swiglu_epilogue(h: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """silu(h) in fp32, rounded to ``h``'s dtype, times u."""
    return F.silu(h.float()).to(h.dtype) * u


def moe_experts(dispatch: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """Each expert's SwiGLU over its whole buffer, silu in fp32."""
    h = torch.bmm(dispatch, w_gate)
    u = torch.bmm(dispatch, w_up)
    return torch.bmm(swiglu_epilogue(h, u), w_down)


def moe_combine(eo: torch.Tensor, idx, pos, gate_vals, keep, cap: int) -> torch.Tensor:
    """(T, d): the gates times ``keep`` rounded to ``eo``'s dtype, then one einsum."""
    gathered = eo[idx, pos.clamp(0, cap - 1)]  # (T, k, d)
    return torch.einsum("tk,tkd->td", (gate_vals * keep).to(eo.dtype), gathered)
