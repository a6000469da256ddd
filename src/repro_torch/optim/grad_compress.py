"""int8 gradient compression with error feedback (port of
``repro/optim/grad_compress.py``): the quantization error is kept in a
residual and added to the next step's gradient instead of being lost, the
coalesce-before-writeback structure of the paper's SSD write log applied to
the optimizer path.

Per tensor: scale = max(max |x|, 1e-12) / 127, q = clip(round(x / scale),
-127, 127) with round half to even (as ``jnp.round``), x_hat = q * scale.
On a sharded leaf the max is the whole leaf's: the caller passes
``amax_reduce``, which takes this shard's max |x| to the max over every
shard (an all-reduce of max), so that every shard quantizes on one scale.

JAX compresses the gradient after GSPMD has reduced it over the data axes
(``repro/launch/steps.py:85-93``; its module docstring says "before the
all-reduce", its code does not), and so does the port's sharded step.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

Grads = Dict[str, torch.Tensor]


def quantize_int8(x: torch.Tensor, amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale), scaled by ``amax``: the max |x| of the whole tensor."""
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round trip through int8. Returns (g_hat, error) in fp32."""
    g32 = g.to(torch.float32)
    g_hat = dequantize_int8(*quantize_int8(g32, g32.abs().max()))
    return g_hat, g32 - g_hat


def error_feedback_leaf(
    g: torch.Tensor, residual: torch.Tensor, amax_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Compress ``g + residual``; the new residual (the compression error) is
    written into ``residual`` IN PLACE. Returns the compressed gradient.
    ``amax_reduce``: this shard's max |g + residual| -> the whole leaf's."""
    x = g.to(torch.float32) + residual
    amax = x.abs().max()
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    g_hat = dequantize_int8(*quantize_int8(x, amax))
    residual.copy_(x - g_hat)
    return g_hat


def error_feedback_update(grads: Grads, residual: Grads) -> Tuple[Grads, Grads]:
    """Error feedback over a gradient dict: returns (compressed grads, the
    residual dict, updated in place; JAX returns a new one)."""
    return {name: error_feedback_leaf(g, residual[name]) for name, g in grads.items()}, residual
