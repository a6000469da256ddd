"""SkyByte tiering runtime for serving (port of ``repro/core/tiering.py``).

The paper's memory system, re-expressed for an LLM serving engine:

  flash chips            -> host-tier page pool (big, slow to reach)
  SSD DRAM data cache    -> fast page pool on the card (small)
  cacheline write log    -> token-granular KV write-log ring
  log compaction         -> kernels/log_compact: newest-wins coalescing of
                            log tokens into page-granular pool writes
  page-granular flash IO -> page-granular host <-> fast-pool copies
  adaptive migration     -> hot-page promotion into the fast pool (engine
                            policy; LRU eviction under pressure)
  coordinated ctx switch -> the serving scheduler parks requests whose
                            pages are not resident and runs others

Device state is a dict of fixed-shape tensors, updated IN PLACE where JAX
returns new arrays (it saves copying the pools every step). ``log_tail`` is
a host integer: the engine's policy needs it every step, and the append
kernel takes it as an argument, so it never has to be read back from the
card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import torch

from repro_torch.configs import ModelConfig
from repro_torch.kernels.kv_log_append.ops import qkv_log_append
from repro_torch.kernels.log_compact.ops import log_compact_tiers
from repro_torch.kernels.mamba_step.ops import rms_norm_rows
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.models import zamba2
from repro_torch.models.api import ModelSpec
from repro_torch.models.common import layer_stack
from repro_torch.models.dense import _attn_params, _ffn, unembed
from repro_torch.models.layers import AttnParams, rmsnorm

State = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TieredKVConfig:
    page_size: int = 16
    n_hbm_pages: int = 32  # fast pool slots (the "SSD DRAM cache")
    max_requests: int = 8
    max_pages_per_req: int = 8
    log_slots: int = 64
    batch: int = 4  # decode batch width (scheduled requests per step)
    promote_pages_per_step: int = 4  # host->fast copy budget per step
    fetch_page_us: float = 50.0  # per-page host->fast latency estimate
    park_threshold_us: float = 50.0  # Algorithm-1-style switch threshold

    @property
    def n_host_pages(self) -> int:
        return self.max_requests * self.max_pages_per_req


def attention_calls(cfg: ModelConfig) -> int:
    """The K/V caches a token writes: one a layer for the decoder families,
    one a shared-block invocation for "zamba2". Pools and log are stacked
    over them."""
    return zamba2.attention_calls(cfg) if cfg.family == "zamba2" else cfg.n_layers


def init_state(kv_cfg: TieredKVConfig, cfg: ModelConfig, dtype=torch.float32, device="cuda") -> State:
    """The tiers, the log and the page metadata; for "zamba2" also each
    request's recurrent state, ``conv`` (L, slots, W-1, C) in ``dtype`` and
    ``ssm`` (L, slots, H, P, N) fp32, one slot a request (by id) and a last,
    scratch slot for padded rows: byte-granular hot data that stays resident
    for the request's life, beside the page policy."""
    L, KV, hd = attention_calls(cfg), cfg.n_kv_heads, cfg.resolved_head_dim
    c = kv_cfg
    shape_pool = (L, c.n_hbm_pages, c.page_size, KV, hd)
    shape_host = (L, c.n_host_pages, c.page_size, KV, hd)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    state = {
        "hbm_k": zeros(shape_pool),
        "hbm_v": zeros(shape_pool),
        "host_k": zeros(shape_host),
        "host_v": zeros(shape_host),
        "page_table": torch.full((c.max_requests, c.max_pages_per_req), -1, dtype=torch.int32, device=device),
        "log_k": zeros((L, c.log_slots, KV, hd)),
        "log_v": zeros((L, c.log_slots, KV, hd)),
        "log_meta": torch.full((c.log_slots, 2), -1, dtype=torch.int32, device=device),
        "log_tail": 0,
        "lengths": zeros((c.max_requests,), torch.int32),
        # compaction watermark: positions < compacted live in pages;
        # positions >= compacted live in the write log (disjointness)
        "compacted": zeros((c.max_requests,), torch.int32),
    }
    if cfg.family == "zamba2":
        H, P, N, _, W, _, C = zamba2.widths(cfg)
        slots = c.max_requests + 1
        state["conv"] = zeros((cfg.n_layers, slots, W - 1, C))
        state["ssm"] = zeros((cfg.n_layers, slots, H, P, N), torch.float32)
    return state


def state_slot_bytes(state: State) -> int:
    """One slot's recurrent state over every layer (0 without one)."""
    if "ssm" not in state:
        return 0
    return sum(state[k][:, 0].numel() * state[k].element_size() for k in ("conv", "ssm"))


def write_prefill_states(state: State, req: int, conv, ssm) -> State:
    """A prefill's conv windows (L, W-1, C) and SSM states (L, H, P, N) into
    the request's slot."""
    state["conv"][:, req] = conv.to(state["conv"].dtype)
    state["ssm"][:, req] = ssm
    return state


def host_slot(kv_cfg: TieredKVConfig, req: int, logical: int) -> int:
    """Backing-store slot for a request's logical page (direct-mapped)."""
    return req * kv_cfg.max_pages_per_req + logical


# ---------------------------------------------------------------------------
# device ops
# ---------------------------------------------------------------------------


def copy_pages(dst_k, dst_v, src_k, src_v, pairs: Sequence[Sequence[int]]) -> None:
    """Copy pages src -> dst pool, in place. pairs: host (src_slot, dst_slot)
    rows; rows with a negative entry are ignored. Models the page-granular
    host <-> fast-pool DMA. Host-integer indices: nothing is uploaded."""
    for s, d in pairs:
        if s >= 0 and d >= 0:
            dst_k[:, d] = src_k[:, s]
            dst_v[:, d] = src_v[:, s]


def write_prefill_pages(kv_cfg: TieredKVConfig, state: State, req: int, k, v) -> State:
    """Scatter a dense prefill cache (L, S, KV, hd) into the request's
    host-tier pages (the paper's initial placement: data starts in the slow
    tier)."""
    L, S, KV, hd = k.shape
    p = kv_cfg.page_size
    n = (S + p - 1) // p
    base = host_slot(kv_cfg, req, 0)
    for name, x in (("host_k", k), ("host_v", v)):
        pages = state[name][:, base:base + n].view(L, n * p, KV, hd)  # in place
        pages[:, :S] = x.to(pages.dtype)
        pages[:, S:] = 0
    state["lengths"][req] = S
    state["compacted"][req] = S
    return state


def build_paged_decode_step(spec: ModelSpec, kv_cfg: TieredKVConfig):
    """Decode step over the tiered KV state, chosen once by family: "zamba2"
    takes ``build_zamba2_decode_step``; the decoder families (dense, moe,
    vlm: GQA attention, then SwiGLU or the MoE layer, whose aux loss is
    dropped as in JAX) the step below. Returns
    step(params, state, tokens, req_ids) -> (next_tokens, state).

    The current token's K/V is appended to the write log, layer by layer
    (token-granular, no page read-modify-write: the paper's write path) by
    qkv_log_append, which also does the projections' bias, qk-norm and
    RoPE: one kernel launch a layer from the q/k/v matmuls to the log.
    Attention reads pages + log in parallel (the paper's read path).
    ``state`` is updated in place.
    """
    if spec.cfg.family == "zamba2":
        return build_zamba2_decode_step(spec, kv_cfg)
    cfg = spec.cfg

    def step(params, state: State, tokens: torch.Tensor, req_ids: torch.Tensor):
        B = tokens.shape[0]
        live = req_ids >= 0
        safe_req = req_ids.clamp(min=0).long()
        lengths = torch.where(live, state["lengths"][safe_req], 0)  # (B,)
        compacted = torch.where(live, state["compacted"][safe_req], 0)
        page_table = state["page_table"][safe_req]  # (B, N)

        x = params["embed"][tokens]  # (B, 1, d)
        tail = state["log_tail"]
        meta_pos = torch.where(live, lengths, -1)
        lengths1 = lengths + 1  # attention covers the just-appended token
        for layer, p_l in enumerate(layer_stack(params)):
            ap = _attn_params(cfg, p_l)
            h = rmsnorm(x, p_l["attn_norm"], cfg.norm_eps)
            # write path: this token's K/V, finished, appended to the log
            q, _ = qkv_log_append(
                cfg, ap, h @ ap.wq, h @ ap.wk, h @ ap.wv, lengths, state["log_k"][layer],
                state["log_v"][layer], state["log_meta"], tail, req_ids, meta_pos,
            )
            # read path: pages + log in parallel
            o = paged_decode_attention(
                q, state["hbm_k"][layer], state["hbm_v"][layer],
                page_table, lengths1, state["log_k"][layer], state["log_v"][layer], state["log_meta"],
                page_lengths=compacted, req_ids=req_ids,
            )
            x = x + (o.reshape(B, -1) @ p_l["wo"])[:, None]
            h2 = rmsnorm(x, p_l["mlp_norm"], cfg.norm_eps)
            x = x + _ffn(cfg, p_l, h2)[0]
        logits = unembed(cfg, params, x)[:, 0]
        # first index among exact ties, as jnp.argmax
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]

        state["log_tail"] = tail + B
        state["lengths"].index_add_(0, safe_req, live.to(torch.int32))
        return next_tok, state

    return step


def build_zamba2_decode_step(spec: ModelSpec, kv_cfg: TieredKVConfig):
    """Decode step of the "zamba2" family over the tiered KV of the shared
    blocks' invocations and the per-request state slots. Per Mamba layer i:
    at a hybrid site j, ``qkv_log_append`` into call j's log (RoPE; the
    score scale folded into q after it), ``paged_decode_attention`` over
    pages and log, the block's FFN with site j's adapter, ``Wlin_j``, and
    m = x + t; then x += the layer's ``mamba_step`` over m, each row
    reading and writing its request's slot (a padded row the scratch slot).
    Returns step(params, state, tokens, req_ids) -> (next_tokens, state)."""
    cfg = spec.cfg
    site_of = {layer: j for j, layer in enumerate(cfg.hybrid_layer_ids)}
    stacks = [None, None]  # (params, their per-layer views): the views made once, not every step

    def step(params, state: State, tokens: torch.Tensor, req_ids: torch.Tensor):
        if stacks[0] is not params:
            stacks[:] = params, tuple(layer_stack(params, k) for k in ("mamba", "shared", "sites"))
        mamba, shared, sites = stacks[1]
        on = torch.autograd._profiler_enabled()
        B = tokens.shape[0]
        live = req_ids >= 0
        safe_req = req_ids.clamp(min=0).long()
        lengths = torch.where(live, state["lengths"][safe_req], 0)
        compacted = torch.where(live, state["compacted"][safe_req], 0)
        page_table = state["page_table"][safe_req]
        x0 = params["embed"][tokens[:, 0]]  # (B, d)
        tail = state["log_tail"]
        meta_pos = torch.where(live, lengths, -1)
        lengths1 = lengths + 1
        x = x0
        for i, p in enumerate(mamba):
            m = x
            if i in site_of:
                j = site_of[i]
                sp = shared[j % cfg.num_mem_blocks]
                with zamba2.span(on, "model.shared_attn", f"site={j}" if on else ""):
                    u = rms_norm_rows(torch.cat([x, x0], dim=-1), sp["attn_norm"], cfg.norm_eps)[:, None]
                    ap = AttnParams(wq=sp["wq"], wk=sp["wk"], wv=sp["wv"], wo=sp["wo"])
                    q, _ = qkv_log_append(
                        cfg, ap, u @ ap.wq, u @ ap.wk, u @ ap.wv, lengths, state["log_k"][j], state["log_v"][j],
                        state["log_meta"], tail, req_ids, meta_pos,
                    )
                    o = paged_decode_attention(
                        zamba2.scale_q(q), state["hbm_k"][j], state["hbm_v"][j], page_table, lengths1,
                        state["log_k"][j], state["log_v"][j], state["log_meta"], page_lengths=compacted,
                        req_ids=req_ids,
                    )
                    m = zamba2.block_ffn(cfg, sp, sites[j], o.reshape(B, -1) @ sp["wo"], x)
            with zamba2.span(on, "model.mamba"):
                x = zamba2.decode_mamba(cfg, p, x, m, state["conv"][i], state["ssm"][i], req_ids)
        logits = unembed(cfg, params, x)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        state["log_tail"] = tail + B
        state["lengths"].index_add_(0, safe_req, live.to(torch.int32))
        return next_tok, state

    return step


def joint_targets(flush_hbm, flush_host) -> List[List[int]]:
    """One (request, logical page, fast slot or -1, host slot or -1) row per
    dirty page from the two tiers' (request, logical page, slot) lists
    (rows with a negative request or slot are dropped)."""
    def rows(t):
        return t.tolist() if hasattr(t, "tolist") else list(t)

    fast = {(r, lp): s for r, lp, s in rows(flush_hbm) if r >= 0 and s >= 0}
    joint = [[r, lp, fast.pop((r, lp), -1), s] for r, lp, s in rows(flush_host) if r >= 0 and s >= 0]
    return joint + [[r, lp, s, -1] for (r, lp), s in fast.items()]


def compact_log(kv_cfg: TieredKVConfig, state: State, flush_hbm, flush_host) -> State:
    """Run log compaction into both pools and clear the log.

    flush_hbm / flush_host: (F, 3) int32 (request, logical_page, pool_slot)
    rows, host-side (arrays, lists or CPU tensors), built by the engine from
    the log's meta rows (unique dirty pages — the paper's first-level
    hash-table scan). They are joined on the host into one table, uploaded
    once, and both tiers are written in one pass over the log."""
    joint = joint_targets(flush_hbm, flush_host)
    if joint:
        targets = torch.tensor(joint, dtype=torch.int32)
        device = state["log_meta"].device
        if device.type == "cuda":  # a pinned copy sent without stalling the host
            targets = targets.pin_memory().to(device, non_blocking=True)
        log_compact_tiers(
            state["hbm_k"], state["hbm_v"], state["host_k"], state["host_v"],
            state["log_k"], state["log_v"], state["log_meta"], targets,
        )
    state["log_meta"].fill_(-1)
    state["log_tail"] = 0
    # everything logged so far is now in pages
    state["compacted"].copy_(state["lengths"])
    return state
