"""The data-parallel ranks that one MoE layer routes over together.

JAX computes a capacity-bounded MoE over the whole (global) batch: the
capacity, the slots claimed in token order, the drops and the load-balance
aux all see every row. When each data-parallel rank holds only its own rows,
``models/layers.py::moe_ffn`` gathers the router's choices and
probabilities over these ranks (small: T x k ints and T x E fp32 a layer)
and computes all of those over the global rows, in global row order; each
rank then dispatches only its own rows.

``DataParallelRows`` gathers over a process group, differentiably: the
gradient of the gathered rows is summed over the group and each rank takes
its own block (a reduce-scatter, as an all-reduce, which gloo and NCCL both
have). ``ShapeOnlyRows`` stands in for it on the meta device, where the dry
run counts the work of one rank among ``size``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size: int, index: int):
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.group, ctx.size, ctx.index = group, size, index
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad.chunk(ctx.size)[ctx.index], None, None, None


class DataParallelRows:
    """The ranks of process group ``group``; rank i holds block i of the
    global rows."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0 in rank order (the
        same row count on every rank)."""
        return _Gather.apply(x, self.group, self.size, self.index)


class ShapeOnlyRows:
    """``size`` ranks of which this is the first, for tensors on the meta
    device: ``gather`` gives the global shape, with no communication."""

    def __init__(self, size: int):
        self.size, self.index = size, 0

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "meta":
            raise ValueError(f"ShapeOnlyRows gathers meta tensors only, got one on {x.device}")
        return x.repeat(self.size, *([1] * (x.dim() - 1)))
