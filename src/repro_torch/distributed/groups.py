"""Process groups of a sharded train step and the differentiable
collectives the split compute is made of.

**Data-parallel rows.** JAX computes a capacity-bounded MoE over the whole
(global) batch: the capacity, the slots claimed in token order, the drops
and the load-balance aux all see every row. When each data-parallel rank
holds only its own rows, ``models/layers.py::moe_ffn`` gathers the router's
choices and probabilities over these ranks (small: T x k ints and T x E
fp32 a layer) and computes all of those over the global rows, in global row
order; each rank then dispatches only its own rows. ``DataParallelRows``
gathers over a process group, differentiably: the gradient of the gathered
rows is summed over the group and each rank takes its own block (a
reduce-scatter, as an all-reduce, which gloo and NCCL both have).
``ShapeOnlyRows`` stands in for it on the meta device, where the dry run
counts the work of one rank among ``size``.

**Split compute** (every family's sharded step, JAX's ``use_weight`` and
``shard_hint`` layout):

- ``DataParallelWeights.gather``: a weight's FSDP shards gathered over
  "data" at its use site, leaving its "model" shard; the backward sums the
  weight's gradient over every data-parallel rank ("pod" and "data") in the
  param dtype (bf16, as GSPMD reduces) and keeps this rank's block: a
  reduce-scatter into the rank's shard, as an all-reduce plus the own block.
  A weight used several times a microbatch (zamba2's shared block) is
  gathered at each use through an ``anchor``, so the sum of the uses'
  gradients is reduced once.
- ``ModelParallel``: Megatron's pair, ``copy`` (identity forward,
  all-reduce backward: where a replicated tensor enters model-parallel
  compute) and ``reduce`` (all-reduce forward, identity backward: where
  partial sums leave it); ``all_sum`` (all-reduce both ways: a sum over
  "model" that each rank's own columns use, Mamba2's gated norm);
  ``gather`` over "model" (a cut KV head's neighbours, or a projection
  computed replicated); the vocab-parallel fp32 cross entropy.

**Sharded serving** (the split prefill and decode steps, under no grad):
``ModelParallel.all_max`` and ``reduce`` (decode attention's combine over a
sequence-sharded cache), ``argmax`` (greedy over vocab-split logits, the
lowest global id among equal maxima) and ``gather_heads`` (every KV head
from the ranks' head ranges, each head from the first rank that holds it:
the prefill's K/V moved from heads to sequence, and the decode token's K/V
row). The heads move by an all-gather, which serves every head route (a
"kv_gather" rank's range overlaps its neighbour's, a "replicated" rank holds
every head) with the ops gloo and NCCL share.

Each op is an ``autograd.Function`` written here on ``all_reduce`` and
``all_gather`` alone: ``torch.distributed.nn.functional.all_gather``'s
backward scatters from a global rank and fails on a gloo subgroup, and
gloo has no reduce-scatter. A group of one rank makes every op the
identity, and no op is applied then. On the meta device (the dry run, with
``ShapeOnlyGroup``s) the collectives keep shapes only, an all-reduce the
identity and an all-gather the block repeated, and count the bytes sent.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


class ShapeOnlyGroup:
    """``size`` ranks on the meta device (the dry run): the collectives keep
    shapes only, and ``sent`` counts the bytes one rank would send (ring
    all-reduce: 2 (n - 1) / n of the tensor; ring all-gather: n - 1 of its
    block)."""

    def __init__(self, size: int):
        self.size, self.sent = size, 0.0


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of ``x`` over ``group`` (``x`` is left as it was)."""
    out = x.contiguous().clone()
    if out.device.type != "meta":
        dist.all_reduce(out, op=op, group=group)
    elif isinstance(group, ShapeOnlyGroup):
        group.sent += 2 * (group.size - 1) / group.size * out.numel() * out.element_size()
    return out


def _all_gather(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    if x.device.type == "meta":
        if isinstance(group, ShapeOnlyGroup):
            group.sent += (size - 1) * x.numel() * x.element_size()
        return torch.cat([x] * size, dim=dim)
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in fp32, or in its own dtype where that is wider."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _mm_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (``a`` (..., K), ``b`` (K, N)) with an fp32 (or wider)
    result: the products of the operands' own values summed in fp32. On the
    card a bf16 GEMM on the tensor cores that returns its fp32 accumulator;
    elsewhere an fp32 GEMM of the upcast operands (bf16 products are exact
    in fp32, so only the order of the sum differs)."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return _wide(a) @ _wide(b)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the backward sums the gradient over
    ``reduce_group`` (None: no sum, every rank holds the whole gradient)
    and keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, dim: int, group, size: int, index: int, reduce_group):
        ctx.dim, ctx.size, ctx.index, ctx.reduce_group = dim, size, index, reduce_group
        return _all_gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.reduce_group is not None:
            grad = _all_reduce(grad, ctx.reduce_group)
        return grad.chunk(ctx.size, dim=ctx.dim)[ctx.index], None, None, None, None, None


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _Reduce(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ColumnParallel(torch.autograd.Function):
    """``x @ w`` for each ``w`` of ``ws``, this rank's columns of each, on
    the replicated ``x``: the forward is the unsharded matmuls'; the
    backward's gradient of ``x`` sums each projection's part in fp32, over
    the projections and over the group, and is rounded to ``x``'s dtype
    once (autograd of the unsharded matmuls rounds each part to bf16)."""

    @staticmethod
    def forward(ctx, x, group, *ws):
        ctx.save_for_backward(x, *ws)
        ctx.group = group
        return tuple(x @ w for w in ws)

    @staticmethod
    def backward(ctx, *grads):
        x, *ws = ctx.saved_tensors
        rows = x.reshape(-1, x.shape[-1])
        grad_x = sum(_mm_wide(g, w.T) for g, w in zip(grads, ws))
        grad_ws = [rows.T @ g.reshape(-1, g.shape[-1]) for g in grads]
        return (_all_reduce(grad_x, ctx.group).to(x.dtype), None, *grad_ws)


class _AllSum(torch.autograd.Function):
    """All-reduce (sum) forward and backward: a sum over "model" whose
    result each rank uses in its own split compute (every rank's gradient
    of the sum is a part of the whole)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _Anchor(torch.autograd.Function):
    """A stride-0 stand-in of the whole (gathered) weight, made once a
    microbatch: each use's ``_GatherAt`` hands its gradient to it, autograd
    sums them, and its backward reduces the sum over ``reduce_group`` once
    and keeps this rank's block."""

    @staticmethod
    def forward(ctx, w, shape, dim, size: int, index: int, reduce_group):
        ctx.dim, ctx.size, ctx.index, ctx.reduce_group = dim, size, index, reduce_group
        return w.new_zeros(()).expand(shape)

    @staticmethod
    def backward(ctx, grad):
        if ctx.reduce_group is not None:
            grad = _all_reduce(grad, ctx.reduce_group)
        if ctx.dim is not None and ctx.size > 1:
            grad = grad.chunk(ctx.size, dim=ctx.dim)[ctx.index]
        return grad, None, None, None, None, None


class _GatherAt(torch.autograd.Function):
    """``w`` gathered along ``dim`` over ``group`` (a view where it is not
    split); the gradient goes to ``anchor`` unreduced."""

    @staticmethod
    def forward(ctx, w, anchor, dim, group, size: int):
        if dim is None or size == 1:
            return w.detach().clone()
        return _all_gather(w, group, size, dim)

    @staticmethod
    def backward(ctx, grad):
        return None, grad, None, None, None


class _RowParallel(torch.autograd.Function):
    """``x @ w`` for this rank's rows of ``w`` (and columns of ``x``): the
    partial product in fp32, summed over the group in fp32 and rounded to
    ``x``'s dtype once, as the unsharded matmul rounds its fp32 accumulator.
    The backward is the unsharded matmul's, in ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        return _all_reduce(_mm_wide(x, w), group).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        grad_w = x.reshape(-1, x.shape[-1]).T @ grad.reshape(-1, grad.shape[-1])
        return grad @ w.T, grad_w, None


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
        return _Gather.apply(x, 0, self.group, self.size, self.index, self.group)


class ShapeOnlyRows:
    """``size`` ranks of which this is the first, for tensors on the meta
    device: ``gather`` gives the global shape, with no communication."""

    def __init__(self, size: int):
        self.size, self.index = size, 0

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "meta":
            raise ValueError(f"ShapeOnlyRows gathers meta tensors only, got one on {x.device}")
        return x.repeat(self.size, *([1] * (x.dim() - 1)))


class DataParallelWeights:
    """FSDP over the "data" axis: ``gather(w, dim)`` is this rank's "model"
    shard of a weight whose shard ``w`` is split over "data" along ``dim``
    (None: not split over "data"). The backward sums the gradient over
    ``dp_group`` (every data-parallel rank: "pod" and "data") and keeps the
    block of ``w``."""

    def __init__(self, data_group, data_size: int, data_index: int, dp_group, dp_size: int):
        self.data_group, self.data_size, self.data_index = data_group, data_size, data_index
        self.dp_group, self.dp_size = dp_group, dp_size

    def gather(self, w: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        if dim is not None and self.data_size > 1:
            return _Gather.apply(w, dim, self.data_group, self.data_size, self.data_index, self.dp_group)
        return w.view_as(w) if self.dp_size == 1 else _Copy.apply(w, self.dp_group)

    def anchor(self, w: torch.Tensor, dim: Optional[int]) -> Optional[torch.Tensor]:
        """For a weight used several times a microbatch (zamba2's shared
        block): a stride-0 stand-in of its gathered shape, through which
        ``gather(w, dim, anchor)`` at each use sends its gradient, so that
        the sum over the uses is reduced into the shard once. None where no
        reduction happens (one data-parallel rank): the uses' gradients
        then sum into the leaf as the unsharded model's do."""
        if self.dp_size == 1:
            return None
        shape = list(w.shape)
        if dim is not None and self.data_size > 1:
            shape[dim] *= self.data_size
        return _Anchor.apply(w, shape, dim, self.data_size, self.data_index, self.dp_group)

    def gather_at(self, w: torch.Tensor, dim: Optional[int], anchor: Optional[torch.Tensor]) -> torch.Tensor:
        """``gather(w, dim)`` whose gradient goes to ``anchor`` (``anchor``'s
        backward reduces it); ``gather`` itself where ``anchor`` is None."""
        if anchor is None:
            return self.gather(w, dim)
        return _GatherAt.apply(w, anchor, dim if self.data_size > 1 else None, self.data_group, self.data_size)


class ModelParallel:
    """This rank's place on the "model" axis: ``group``, ``size`` ranks, this
    one ``index``."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward, all-reduce backward: a replicated tensor that
        enters compute split over "model" (its gradient from each rank is a
        part of the whole)."""
        return _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce forward, identity backward: partial sums leaving
        compute split over "model"."""
        return _Reduce.apply(x, self.group)

    def column_parallel(self, x: torch.Tensor, *ws: torch.Tensor):
        """The column-parallel matmuls that enter model-parallel compute:
        ``x @ w`` for each ``w`` (K, N_local), ``x`` replicated. The gradient
        of ``x`` is the sum over the projections and over "model", its parts
        kept in fp32 and the sum rounded once (``copy`` then the matmuls
        would round each part to bf16)."""
        return _ColumnParallel.apply(x, self.group, *ws)

    def row_parallel(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The row-parallel matmul that leaves model-parallel compute: ``x``
        (..., K_local) @ ``w`` (K_local, N), summed over "model". Each rank's
        partial product is kept in fp32 and the sum is rounded once (GSPMD
        rounds each part to bf16 first, which at reduced width trebles the
        gap of a step's gradients to the unsharded step's)."""
        return _RowParallel.apply(x, w, self.group)

    def gather(self, x: torch.Tensor, dim: int, *, partial_grad: bool) -> torch.Tensor:
        """The whole tensor of this rank's block ``x`` along ``dim``. With
        ``partial_grad`` each rank's gradient is a part of the whole (a cut KV
        head used by the q heads of two ranks): it is summed over "model"
        before the own block is kept. Without, every rank computes the same
        whole gradient (a projection computed replicated), and the own block
        is taken as it is."""
        return _Gather.apply(x, dim, self.group, self.size, self.index, self.group if partial_grad else None)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over "model", forward and backward: each rank's
        part (a sum of squares over its columns) summed, the whole used by
        each rank's own columns, so each rank's gradient of it is a part
        too."""
        return _AllSum.apply(x, self.group)

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``x`` over "model" (no gradient)."""
        return _all_reduce(x, self.group, dist.ReduceOp.MAX)

    def argmax(self, logits: torch.Tensor, vocab_start: int) -> torch.Tensor:
        """The global argmax of logits split over "model" by vocab:
        ``logits`` (..., V_local) holds columns [vocab_start, vocab_start +
        V_local). int64 ids (...), the lowest among equal maxima (JAX's
        ``argmax``, and each rank's ``torch.argmax``): the max is taken over
        "model", and of the ranks that hold it the lowest id wins, as the
        max of the negated ids (exact in fp32 below 2^24)."""
        z = logits.float()
        arg = torch.argmax(z, dim=-1)
        local_max = z.gather(-1, arg[..., None])[..., 0]
        at_max = local_max == self.all_max(local_max)
        neg_id = torch.where(at_max, -(arg + vocab_start).float(), torch.full_like(local_max, -float(2 ** 24)))
        return (-self.all_max(neg_id)).long()

    def gather_heads(self, x: torch.Tensor, ranges, dim: int) -> torch.Tensor:
        """Every head of a tensor whose heads lie along ``dim``: this rank's
        ``x`` holds heads ``ranges[index]`` ([start, stop)), and
        ``ranges`` lists each rank's, in rank order, covering the heads
        without a gap. Each head comes from the first rank that holds it.
        Ranks that all hold every head keep ``x``; otherwise each rank's
        block, padded to the widest, is all-gathered."""
        n = max(b for _, b in ranges)
        if all(tuple(r) == (0, n) for r in ranges):
            return x
        dim = dim % x.dim()
        width = max(b - a for a, b in ranges)
        if x.shape[dim] < width:
            pad = list(x.shape)
            pad[dim] = width - x.shape[dim]
            x = torch.cat([x, x.new_zeros(pad)], dim=dim)
        parts = _all_gather(x, self.group, self.size, dim).split(width, dim=dim)
        pieces, done = [], 0
        for (a, b), part in zip(ranges, parts):
            if a > done:
                raise ValueError(f"gather_heads: heads [{done}, {a}) are on no rank: {ranges}")
            if b > done:
                pieces.append(part.narrow(dim, done - a, b - done))
                done = b
        return torch.cat(pieces, dim=dim)

    def cross_entropy(self, logits: torch.Tensor, targets: torch.Tensor, vocab_start: int) -> torch.Tensor:
        """Per-row fp32 cross entropy of logits split over "model" by vocab:
        ``logits`` (..., V_local) holds columns [vocab_start, vocab_start +
        V_local) of the whole (..., V). The row max and the sum of exps are
        reduced over "model", and the target's logit comes from the rank
        whose range holds it; no rank holds the whole row. Equals
        ``-log_softmax(whole)[target]``."""
        z = logits.float()
        m = _all_reduce(z.amax(dim=-1, keepdim=True).detach(), self.group, dist.ReduceOp.MAX)
        sum_exp = self.reduce(torch.exp(z - m).sum(dim=-1))
        local = targets.long() - vocab_start
        inside = (local >= 0) & (local < z.shape[-1])
        z_t = z.gather(-1, local.clamp(0, z.shape[-1] - 1)[..., None])[..., 0]
        z_t = self.reduce(torch.where(inside, z_t, torch.zeros_like(z_t)))
        return torch.log(sum_exp) + m[..., 0] - z_t
