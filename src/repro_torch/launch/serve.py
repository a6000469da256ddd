"""Serving launcher — the SkyByte tiered-KV engine end to end, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --requests 6 \\
      --tiering skybyte
  PYTHONPATH=src python -m repro_torch.launch.serve --tiering baseline   # dense KV
  PYTHONPATH=src python -m repro_torch.launch.serve --full ...           # full width
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b --full ...  # MoE
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu ...     # plain versions

The GQA decoder families only (dense, moe, vlm), as in JAX: the
encoder-decoder, RWKV6 and Mamba2/Zamba2 families are served through
``repro_torch.launch.steps``.

Reports the paper's metrics for the serving analogue: parks (coordinated
context switches), promoted/evicted pages (adaptive migration), compactions
and the coalescing ratio (write-log), plus tokens/s. Weights are random,
drawn from --seed.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core.tiering import TieredKVConfig
from repro_torch.models import dense
from repro_torch.models.api import ModelSpec
from repro_torch.models.common import layer_stack
from repro_torch.models.layers import decode_attention, project_qkv, rmsnorm
from repro_torch.serving.engine import Request, TieredEngine


def dense_decode(
    spec: ModelSpec, params, prompt: Sequence[int], n_new: int, *,
    forced: Optional[Sequence[int]] = None, device="cuda",
) -> Tuple[List[int], List[float]]:
    """Greedy dense decode of one request: prefill, then ``decode_step`` over
    a dense KV cache. With ``forced`` the tokens fed back are ``forced``
    (teacher forcing) and the second list holds, per emitted position, how
    far the forced token's logit lies below the maximum logit."""
    device = resolve_device(device)
    toks = torch.tensor(list(prompt), dtype=torch.long, device=device)[None]
    logits, cache = spec.prefill(params, toks)
    out, gaps = [], []

    def emit(lg: torch.Tensor) -> None:
        if forced is None:
            out.append(int(torch.argmax(lg)))
        else:
            out.append(int(forced[len(out)]))
            gaps.append(float(lg.max().float() - lg[out[-1]].float()))

    emit(logits[0])
    S = len(prompt)
    maxlen = S + n_new + 4
    dc = spec.init_cache(1, maxlen, device=device)
    dc["k"][:, :, :S] = cache["k"]
    dc["v"][:, :, :S] = cache["v"]
    for pos in range(S, S + n_new - 1):
        logits, dc = spec.decode_step(params, dc, torch.tensor([[out[-1]]], device=device), pos)
        emit(logits[0])
    return out, gaps


def replay_dense(
    spec: ModelSpec, params, prompts: Dict[int, Sequence[int]],
    batches: Sequence[Tuple[torch.Tensor, torch.Tensor]], forced: Dict[int, Sequence[int]], device="cuda",
    routes: Optional[Sequence[torch.Tensor]] = None,
) -> Dict[int, List[float]]:
    """The engine's decode steps again, over dense KV caches: the reference
    of a batch-dependent model (a capacity-bounded MoE routes each row
    according to the rows beside it, so a batch-1 decode is no reference).

    ``batches``: the engine's steps in order, each its (tokens (B, 1),
    req_ids (B,)) as given to ``TieredEngine.step_fn`` (padded rows, with
    request -1, kept: they count in the MoE's capacity). Each request is
    prefilled alone, as the engine does. Returns, per request, how far each
    token of ``forced[rid]`` lies below the maximum logit of the step that
    emitted it (the first from the prefill).

    ``routes``: the (B, k) expert ids the engine's MoE chose, per step and
    layer in order; given, the replay takes those experts (forced routing,
    as the tokens are forced). A router's k-th and (k+1)-th logits can lie
    within the rounding that separates two attention recipes, and one
    changed choice changes the rows after it (capacity) and every later
    layer, so a replay of the tokens alone can part from the run for good;
    forcing keeps the comparison on the arithmetic, and the caller checks
    that each forced choice is a near tie of the replay's own router."""
    device = resolve_device(device)
    cfg = spec.cfg
    rids = sorted(prompts)
    slot = {rid: i for i, rid in enumerate(rids)}  # cache row; the last row takes padded rows
    s_max = max(len(prompts[r]) + len(forced[r]) for r in rids) + 1
    shape = (cfg.n_layers, len(rids) + 1, s_max, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache_k = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    cache_v = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    lengths = {}
    gaps: Dict[int, List[float]] = {rid: [] for rid in rids}

    def gap(rid: int, lg: torch.Tensor) -> None:
        tok = forced[rid][len(gaps[rid])]
        gaps[rid].append(float(lg.max().float() - lg[tok].float()))

    for rid in rids:
        toks = torch.tensor(list(prompts[rid]), dtype=torch.long, device=device)[None]
        logits, cache = spec.prefill(params, toks)
        S = len(prompts[rid])
        cache_k[:, slot[rid], :S] = cache["k"][:, 0]
        cache_v[:, slot[rid], :S] = cache["v"][:, 0]
        lengths[rid] = S
        gap(rid, logits[0])
    route_iter = iter(routes) if routes is not None else None
    for tokens, req_ids in batches:
        req = [int(r) for r in req_ids.tolist()]
        rows = torch.tensor([slot[r] if r >= 0 else len(rids) for r in req], device=device)
        pos = torch.tensor([lengths[r] if r >= 0 else 0 for r in req], device=device)
        x = params["embed"][tokens.to(device).long()]  # (B, 1, d)
        for layer, p_l in enumerate(layer_stack(params)):
            h = rmsnorm(x, p_l["attn_norm"], cfg.norm_eps)
            q, k, v = project_qkv(cfg, dense._attn_params(cfg, p_l), h, pos[:, None])
            cache_k[layer, rows, pos] = k[:, 0]
            cache_v[layer, rows, pos] = v[:, 0]
            o = decode_attention(q, cache_k[layer, rows], cache_v[layer, rows], pos + 1)
            x = x + o.reshape(len(req), 1, -1) @ p_l["wo"]
            experts = None if route_iter is None else next(route_iter)
            x = x + dense._ffn(cfg, p_l, rmsnorm(x, p_l["mlp_norm"], cfg.norm_eps), experts=experts)[0]
        logits = dense.unembed(cfg, params, x)[:, 0]
        for i, r in enumerate(req):
            if r >= 0:
                gap(r, logits[i])
                lengths[r] += 1
    return gaps


def baseline_serve(spec, params, prompts: Dict[int, List[int]], n_new: int, device="cuda"):
    """Dense (non-tiered) reference serving loop: full KV per request. Also
    the port's dense reference for the engine's tokens."""
    outs = {}
    t0 = time.time()
    for rid, p in prompts.items():
        outs[rid], _ = dense_decode(spec, params, p, n_new, device=device)
    dt = time.time() - t0
    return outs, dt


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="qwen3-1.7b")
    ap.add_argument("--full", action="store_true", help="full-width config (default: reduced)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--tiering", choices=["skybyte", "baseline"], default="skybyte")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--hbm-pages", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (kernels) or cpu (plain versions)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    if cfg.family not in ("dense", "moe", "vlm"):
        raise SystemExit(
            "tiered serving demo targets GQA decoder families; "
            f"{cfg.family} decode runs via repro_torch.launch.steps.build_serve_step"
        )
    spec = ModelSpec(cfg)
    params = spec.init(torch.Generator(device=device).manual_seed(args.seed), device=device)
    rng = np.random.default_rng(args.seed)
    prompts = {
        rid: [int(x) for x in rng.integers(1, cfg.vocab - 1, size=args.prompt_len)]
        for rid in range(args.requests)
    }

    if args.tiering == "baseline":
        outs, dt = baseline_serve(spec, params, prompts, args.new_tokens, device=device)
        total = sum(len(o) for o in outs.values())
        print(f"[serve/baseline] {total} tokens in {dt:.1f}s "
              f"({total/dt:.1f} tok/s)")
        return

    kv = TieredKVConfig(
        page_size=args.page_size,
        n_hbm_pages=args.hbm_pages,
        max_requests=max(args.requests, 2),
        max_pages_per_req=(args.prompt_len + args.new_tokens) // args.page_size + 2,
        log_slots=64,
        batch=min(4, args.requests),
        promote_pages_per_step=4,
    )
    eng = TieredEngine(spec, params, kv, device=device)
    t0 = time.time()
    for rid, p in prompts.items():
        eng.add_request(Request(rid=rid, prompt=p, max_new_tokens=args.new_tokens))
    stats = eng.run(max_steps=5000)
    dt = time.time() - t0
    print(f"[serve/skybyte] {stats.decoded_tokens} tokens in {dt:.1f}s "
          f"({stats.decoded_tokens/dt:.1f} tok/s)")
    print(f"  parks (ctx switches)      : {stats.parks}")
    print(f"  promoted / evicted pages  : {stats.promoted_pages} / {stats.evicted_pages}")
    print(f"  compactions               : {stats.compactions}")
    print(f"  coalesce ratio (tok/page) : {stats.coalesce_ratio:.2f}")
    done = sum(r.done for r in eng.requests.values())
    print(f"  completed requests        : {done}/{len(eng.requests)}")


if __name__ == "__main__":
    main()
