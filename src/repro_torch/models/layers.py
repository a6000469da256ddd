"""Shared transformer building blocks (port of ``repro/models/layers.py``).

Plain functions on tensors, following the JAX arithmetic recipes: rmsnorm in
fp32, rope in fp32, silu in fp32, decode attention's value contraction with
the softmax weights rounded to the cache dtype first, and the MoE layer's
capacity-bounded dispatch (same routing order, same drops).

Two traces of distribution, each set by the sharded train step for the
length of a step (module globals set by context managers: remat recomputes
a layer inside the backward, which on the card runs on autograd's own
thread):

- ``data_parallel_rows``: ``moe_ffn`` routes over the global microbatch
  (``repro_torch/distributed/groups.py``).
- ``split_compute``: JAX's compute layout. ``use_weight`` gathers a
  weight's FSDP shards over "data" where it is used, leaving its "model"
  shard; ``model_split`` says whether a weight's dim is split over
  "model", and the ops then take Megatron's pair (``ModelParallel.copy`` in,
  ``reduce`` out): swiglu and gelu_mlp column-parallel in and row-parallel
  out, the MoE's experts over "model" (EP), each rank combining its own.
  The sharded serving steps compute in it too (under no grad), and a
  decode step's cache layout rides along (``cache_split``): a cache whose
  sequence is split over "model" takes ``sharded_decode_attention``.

Outside them (no mesh, serving, the engine) ``use_weight`` returns the
weight and every op is the unsharded one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig, MoEConfig
from repro_torch.distributed.groups import DataParallelWeights, ModelParallel
from repro_torch.distributed.sharding import DATA_AXES, MODEL_AXIS, compute_spec, split_dim
from repro_torch.kernels.moe_routing import ops as moe_ops

NEG_INF = -1e30  # finite mask value: -inf - -inf would be NaN


# ---------------------------------------------------------------------------
# split compute (JAX's use_weight / shard_hint layout)
# ---------------------------------------------------------------------------


class Split:
    """The compute layout of one split step. ``specs``: each leaf's storage
    spec by dotted name, for one layer of a stacked leaf (the layers entry
    dropped); ``weights``: the FSDP gather over "data"; ``model``: the
    "model" axis (None with one rank: nothing is split over it); ``cache``:
    a decode step's cache entries' specs by name (the local layout of its
    cache, as ``cache_pspec`` places it)."""

    def __init__(self, specs, weights: DataParallelWeights, model: Optional[ModelParallel], cache=None):
        self.weights, self.model = weights, model
        self.rank = {n: len(s) for n, s in specs.items()}
        self.data_dim = {n: _data_dim(s) for n, s in specs.items()}
        self.model_dim = {n: split_dim(compute_spec(s), MODEL_AXIS) for n, s in specs.items()}
        self.cache_dim = {n: split_dim(s, MODEL_AXIS) for n, s in (cache or {}).items()}


def _data_dim(spec) -> Optional[int]:
    dims = {d for a in DATA_AXES for d in [split_dim(spec, a)] if d is not None}
    if len(dims) > 1:
        raise ValueError(f"spec {spec} splits two dims over the data axes")
    return dims.pop() if dims else None


_SPLIT: Optional[Split] = None


@contextlib.contextmanager
def split_compute(split: Optional[Split]):
    """Within the block, every family's layers compute in ``split``'s
    layout (None: unsharded)."""
    global _SPLIT
    before, _SPLIT = _SPLIT, split
    try:
        yield
    finally:
        _SPLIT = before


def use_weight(w: torch.Tensor, name: str) -> torch.Tensor:
    """JAX's ``use_weight``: the leaf ``name``'s (one layer's) shard ``w``
    gathered over "data" where it is used, split over "model" only; ``w``
    itself outside a split step."""
    return w if _SPLIT is None else _SPLIT.weights.gather(w, _SPLIT.data_dim[name])


def use_weights(p, stack: str, anchors=None):
    """``use_weight`` of each of one layer's leaves of ``<stack>.*``; with
    ``anchors`` (``weight_anchors``) each gradient goes to its anchor."""
    if _SPLIT is None:
        return p
    if anchors is None:
        return {k: use_weight(w, f"{stack}.{k}") for k, w in p.items()}
    return {k: _SPLIT.weights.gather_at(w, _SPLIT.data_dim[f"{stack}.{k}"], anchors[k]) for k, w in p.items()}


def weight_anchors(p, stack: str):
    """For leaves ``<stack>.*`` used several times a microbatch (zamba2's
    shared block): one ``DataParallelWeights.anchor`` each, so that each
    leaf's gradient, summed over the uses, is reduced into its shard once.
    None outside a split step or without a reduction."""
    if _SPLIT is None or _SPLIT.weights.dp_size == 1:
        return None
    return {k: _SPLIT.weights.anchor(w, _SPLIT.data_dim[f"{stack}.{k}"]) for k, w in p.items()}


def model_split(name: str, dim: int) -> Optional[ModelParallel]:
    """The "model" axis, where the leaf ``name``'s compute layout splits its
    (per-layer) dim ``dim`` (negative: from the end) over it; else None."""
    if _SPLIT is None or _SPLIT.model is None:
        return None
    got = _SPLIT.model_dim[name]
    return _SPLIT.model if got is not None and got == dim % _SPLIT.rank[name] else None


def split_model() -> Optional[ModelParallel]:
    """The "model" axis of the split step (None outside one, or with one
    rank)."""
    return None if _SPLIT is None else _SPLIT.model


def cache_split(name: str, dim: int) -> Optional[ModelParallel]:
    """The "model" axis, where a decode step's cache entry ``name`` is split
    over it along ``dim`` (the sequence of a K/V cache); else None (no
    split step, one rank, or a cache the axis does not divide: whole on
    every rank)."""
    if _SPLIT is None or _SPLIT.model is None:
        return None
    return _SPLIT.model if _SPLIT.cache_dim.get(name) == dim else None


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    ang = positions.float()[..., None] * freqs  # (..., S, hd/2)
    ang = ang[..., None, :]  # (..., S, 1, hd/2) — broadcast over heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
           tp: Optional[ModelParallel] = None) -> torch.Tensor:
    """With ``tp`` the weights are this rank's columns of ``w_gate`` and
    ``w_up`` and rows of ``w_down``: column-parallel in, row-parallel out."""
    g, u = (x @ w_gate, x @ w_up) if tp is None else tp.column_parallel(x, w_gate, w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down if tp is None else tp.row_parallel(h, w_down)


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
             tp: Optional[ModelParallel] = None) -> torch.Tensor:
    """GELU MLP without biases (the JAX callers pass none). ``jax.nn.gelu``
    defaults to the tanh approximation, so this takes it too (the erf form
    differs by ~1e-3). ``tp``: as ``swiglu``'s."""
    h = x @ w_in if tp is None else tp.column_parallel(x, w_in)[0]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ w_out if tp is None else tp.row_parallel(h, w_out)


@dataclasses.dataclass(frozen=True)
class AttnParams:
    """View over one layer's attention weights (already layer-sliced)."""

    wq: torch.Tensor  # (d, H*hd)
    wk: torch.Tensor  # (d, KV*hd)
    wv: torch.Tensor  # (d, KV*hd)
    wo: torch.Tensor  # (H*hd, d)
    bq: Optional[torch.Tensor] = None
    bk: Optional[torch.Tensor] = None
    bv: Optional[torch.Tensor] = None
    q_norm: Optional[torch.Tensor] = None  # (hd,) qk-norm gains
    k_norm: Optional[torch.Tensor] = None


def project_qkv(
    cfg: ModelConfig, p: AttnParams, x: torch.Tensor, positions: Optional[torch.Tensor],
    *, rope: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> q: (B, S, H, hd), k/v: (B, S, KV, hd). RoPE only
    with ``rope`` and ``positions`` (the encoder-decoder has neither)."""
    return qkv_epilogue(cfg, p, x @ p.wq, x @ p.wk, x @ p.wv, positions if rope else None)


def qkv_epilogue(
    cfg: ModelConfig, p: AttnParams, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    positions: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What ``project_qkv`` does after the three matmuls: bias, qk-norm and
    RoPE (none where ``positions`` is None). q: (B, S, H*hd), k/v:
    (B, S_kv, KV*hd) -> (B, S or S_kv, heads, hd) each."""
    hd = cfg.resolved_head_dim
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(*q.shape[:2], -1, hd)  # cfg.n_heads, or a split step's local heads
    k = k.reshape(*k.shape[:2], -1, hd)  # k and v may be longer (cross-attention)
    v = v.reshape(*v.shape[:2], -1, hd)
    if p.q_norm is not None:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, S_max, KV, hd)
    v_cache: torch.Tensor,
    length,  # int, or (B,) integer tensor: valid prefix length
) -> torch.Tensor:
    """Single-token attention against a dense KV cache."""
    B, _, H, hd = q.shape
    S_max, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    qg = q.reshape(B, KV, g, hd)
    # scores are formed in the cache dtype, then widened (JAX's recipe)
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k_cache).float()
    scores = scores / torch.tensor(math.sqrt(hd), dtype=torch.float32)
    pos = torch.arange(S_max, device=q.device)[None, :]
    valid = pos < (length if isinstance(length, int) else length.reshape(-1, 1))  # (1 or B, S)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    # the weights are rounded to the cache dtype before w·v: the tiered
    # engine's paged path shares this recipe so greedy tokens agree
    out = torch.einsum("bkgs,bskh->bkgh", w.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, hd)


def sharded_decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd): every q head
    k_cache: torch.Tensor,  # (B, S_local, KV, hd): this rank's chunk of the sequence
    v_cache: torch.Tensor,
    length: int,  # valid prefix length of the whole sequence
    seq: ModelParallel,  # the "model" axis the sequence is split over, in rank order
) -> torch.Tensor:
    """``decode_attention`` over a cache whose sequence is split over
    "model" (JAX's flash-decoding combine, which GSPMD derives from its
    softmax over the sharded axis). On each rank: fp32 scores of every q
    head over its chunk, divided by sqrt(hd), positions >= ``length``
    masked by the finite NEG_INF (a rank whose whole chunk is masked then
    adds exact zeros, where -inf would give NaN); the global max by an
    all-reduce MAX; the exps and their sum by an all-reduce SUM; the
    weights exp / sum rounded to the cache dtype (JAX's softmax, then its
    rounding before w·v); the partial w·v summed in fp32 over "model" and
    rounded once. Returns (B, 1, H, hd) on every rank."""
    B, _, H, hd = q.shape
    S_local, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    qg = q.reshape(B, KV, g, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k_cache).float()
    scores = scores / torch.tensor(math.sqrt(hd), dtype=torch.float32)
    pos = seq.index * S_local + torch.arange(S_local, device=q.device)
    scores = torch.where((pos < length)[None, None, None, :], scores, NEG_INF)
    e = torch.exp(scores - seq.all_max(scores.amax(dim=-1, keepdim=True)))
    w = (e / seq.reduce(e.sum(dim=-1, keepdim=True))).to(v_cache.dtype)
    out = seq.reduce(torch.einsum("bkgs,bskh->bkgh", w.float(), v_cache.float()))
    return out.to(v_cache.dtype).reshape(B, 1, H, hd)


# ---------------------------------------------------------------------------
# MoE (capacity-based dispatch)
# ---------------------------------------------------------------------------

# The data-parallel ranks ``moe_ffn`` routes over (``data_parallel_rows``).
# A plain global, not a context variable: remat recomputes a layer inside
# the backward, which on the card runs on autograd's own thread.
_DP_ROWS = None


@contextlib.contextmanager
def data_parallel_rows(rows):
    """Within the block, ``moe_ffn`` takes its capacity, slots, drops and
    load-balance aux over the rows of every rank of ``rows`` (a
    ``DataParallelRows``, or ``ShapeOnlyRows`` on the meta device; None:
    this rank's rows alone)."""
    global _DP_ROWS
    before, _DP_ROWS = _DP_ROWS, rows
    try:
        yield
    finally:
        _DP_ROWS = before


def moe_route(m: MoEConfig, xt: torch.Tensor, w_router: torch.Tensor):
    """Router: xt (T, d) -> (fp32 logits (T, E), probs, renormalised top-k
    gates (T, k), expert ids (T, k) int64). The top k in descending order,
    ties to the lower expert id (``lax.top_k``'s order: a stable descending
    sort). On the card: the matmul, then one kernel (``kernels/moe_routing``)."""
    return moe_ops.moe_route(m, xt, w_router)


def moe_slots(idx: torch.Tensor, num_experts: int, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slot of each (token, choice) in its expert's capacity buffer, claimed
    in token-major, choice-minor order: (pos (T, k) int64, keep (T, k) bool,
    False where the expert was full). On the card: one kernel, training too."""
    return moe_ops.moe_slots(idx, num_experts, cap)


def moe_dispatch(xt: torch.Tensor, idx, pos, keep, num_experts: int, cap: int) -> torch.Tensor:
    """The experts' (E, cap, d) input buffers, empty slots zero. Each kept
    slot receives exactly one row, so a plain write (no accumulation) gives
    the bits of JAX's add onto zeros. On the card: one kernel."""
    return moe_ops.moe_dispatch(xt, idx, pos, keep, num_experts, cap)


def moe_experts(dispatch: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """Each expert's SwiGLU over its whole buffer (silu in fp32): every
    expert's, or in a split step this rank's. On the card the epilogue
    between the GEMMs is one kernel."""
    return moe_ops.moe_experts(dispatch, w_gate, w_up, w_down)


def moe_combine(eo: torch.Tensor, idx, pos, gate_vals, keep, cap: int) -> torch.Tensor:
    """(T, d): each token's gated sum of its choices' expert outputs, the
    gates times ``keep`` (0 for a dropped pair) rounded to the activation
    dtype first; a dropped pair gathers slot clip(pos). On the card: one
    kernel."""
    return moe_ops.moe_combine(eo, idx, pos, gate_vals, keep, cap)


def moe_ffn(
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d)
    w_router: torch.Tensor,  # (d, E)
    w_gate: torch.Tensor,  # (E, d, f)
    w_up: torch.Tensor,  # (E, d, f)
    w_down: torch.Tensor,  # (E, f, d)
    shared: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    *,
    aux: bool = True,
    experts: Optional[torch.Tensor] = None,
    ep: Optional[ModelParallel] = None,
    shared_tp: Optional[ModelParallel] = None,
):
    """Top-k capacity-bounded MoE. Returns (out, aux_loss).

    Each expert takes ``cap = max(1, int(T * k * capacity_factor / E))``
    (token, choice) pairs, T counting every row given (padded rows too);
    pairs claim slots in token-major, choice-minor order, and a pair past
    its expert's capacity is dropped (gate 0). Every expert runs on its
    whole (cap, d) buffer, empty slots included, as in JAX. ``aux=False``
    (prefill and decode, whose callers drop the loss) skips the aux loss and
    returns 0.0 in its place. ``experts`` (T, k): the expert ids to use in
    place of the router's top k, in that order, with the router's
    probabilities at them renormalised as gates — a replay forced to the
    routing a run recorded (``launch/serve.py::replay_dense``).

    Under ``data_parallel_rows`` each rank's ``x`` is its block of the
    global microbatch: the router's choices and probabilities are gathered
    over the ranks, T counts the global rows, slots are claimed in global
    row order and the load-balance aux is the global one (the router z-loss
    is a mean over rows, and stays this rank's: the step averages the ranks'
    losses). Each rank dispatches, runs and combines only its own rows.

    With ``ep`` (the experts split over "model", JAX's
    ``shard_hint(dispatch, "model", None, None)``) the expert weights are
    this rank's E / m experts: the routing, capacity, slots and drops are
    the whole layer's, computed alike on every rank; each rank dispatches
    the (token, choice) pairs of its own experts, runs them, and combines
    their outputs with the gates, and the partial outputs are summed over
    "model". ``shared_tp``: the shared expert's ``swiglu`` ``tp``."""
    m: MoEConfig = cfg.moe
    B, S, d = x.shape
    T = B * S
    E = m.num_experts
    rows = _DP_ROWS
    if rows is not None and experts is not None:
        raise ValueError("moe_ffn: forced experts are a single-rank replay, not a data-parallel step")
    T_all = T * (rows.size if rows is not None else 1)
    cap = max(1, int(T_all * m.top_k * m.capacity_factor / E))
    xt = x.reshape(T, d)

    logits, probs, gate_vals, idx = moe_route(m, xt, w_router)
    if experts is not None:
        idx = experts
        gate_vals = probs.gather(-1, idx)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    idx_all, probs_all = idx, probs
    if rows is not None:
        idx_all, probs_all = rows.gather(idx), rows.gather(probs)
    pos, keep = moe_slots(idx_all, E, cap)
    if rows is not None:
        own = slice(rows.index * T, (rows.index + 1) * T)
        pos, keep = pos[own], keep[own]
    if ep is None:
        eo = moe_experts(moe_dispatch(xt, idx, pos, keep, E, cap), w_gate, w_up, w_down)
        out = moe_combine(eo, idx, pos, gate_vals, keep, cap)
    else:
        n_local = w_gate.shape[0]
        first = ep.index * n_local
        own = (idx >= first) & (idx < first + n_local)
        local_idx = (idx - first).clamp(0, n_local - 1)
        eo = moe_experts(moe_dispatch(ep.copy(xt), local_idx, pos, keep & own, n_local, cap), w_gate, w_up, w_down)
        gathered = eo[local_idx, pos.clamp(0, cap - 1)]  # moe_combine's rows, summed in fp32 over "model"
        gates = (ep.copy(gate_vals * keep) * own).to(eo.dtype)
        out = ep.reduce(torch.einsum("tk,tkd->td", gates.float(), gathered.float())).to(eo.dtype)
    if shared is not None:
        out = out + swiglu(xt, *shared, tp=shared_tp)
    if not aux:
        return out.reshape(B, S, d), 0.0

    # aux losses (load balance + router z)
    me = probs_all.mean(0)  # (E,)
    ce = (F.one_hot(idx_all, E).sum(1) > 0).float().mean(0)
    lb = E * torch.sum(me * ce) * m.load_balance_loss
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * m.router_z_loss
    return out.reshape(B, S, d), lb + z
