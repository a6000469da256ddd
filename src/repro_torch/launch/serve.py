"""Serving launcher — the SkyByte tiered-KV engine end to end, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --requests 6 \\
      --tiering skybyte
  PYTHONPATH=src python -m repro_torch.launch.serve --tiering baseline   # dense KV
  PYTHONPATH=src python -m repro_torch.launch.serve --full ...           # full width
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu ...     # plain versions

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
from repro_torch.models.api import ModelSpec
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
