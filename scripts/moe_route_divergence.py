#!/usr/bin/env python3
"""Where does a served MoE's routing part from its dense replay, and why?

    python3 scripts/moe_route_divergence.py                 (on a CUDA card)
    python3 scripts/moe_route_divergence.py --arch llama4-scout-17b-a16e --reduced

Serves the arch (default: full-width olmoe-1b-7b, random weights from the
seed) through the port's TieredEngine with ``chip_smoke.py``'s prompts and
KV config, twice: with the paged-attention kernels, and with paged
attention replaced by its plain version (the dense decode's arithmetic:
softmax weights rounded to bf16 before w.v, where the kernel keeps them in
fp32). After each run it replays the engine's batches over dense caches
(``launch/serve.py::replay_dense``) with the tokens forced, and prints how
many live (step, layer, row) top-k sets differ from the run's, where the
first one does, and the worst gap of an emitted token to the replay's max
logit; then the same with the routing forced too, and how far below the
replay router's own k-th logit the run's choices lie.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (NEW_TOKENS, PROMPT_LENS, SEED, card_line, patched,  # noqa: E402
                        routing_disagreement, routing_recorder)
from repro_torch.core import tiering  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core.tiering import TieredKVConfig  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref  # noqa: E402
from repro_torch.launch.serve import replay_dense  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.api import ModelSpec  # noqa: E402
from repro_torch.serving.engine import Request, TieredEngine  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--reduced", action="store_true", help="the reduced config (default: full width)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = (get_reduced if args.reduced else get_config)(args.arch)
    spec = ModelSpec(cfg)
    params = spec.init(torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    kv = TieredKVConfig(page_size=16, n_hbm_pages=96, max_requests=8, max_pages_per_req=40,
                        log_slots=64, batch=4, promote_pages_per_step=8)
    rng = np.random.default_rng(SEED)
    prompts = {rid: [int(t) % cfg.vocab for t in rng.integers(1, 151_935, size=n)]
               for rid, n in enumerate(PROMPT_LENS)}
    print(f"{cfg.name} on {card_line()}; prompts {PROMPT_LENS} x {NEW_TOKENS} new tokens")

    def plain_paged(q, k_pages, v_pages, page_table, lengths, log_k, log_v, log_meta, page_lengths, req_ids):
        return paged_decode_attention_ref(q, k_pages, v_pages, page_table, lengths, log_k, log_v, log_meta,
                                          page_lengths=page_lengths, req_ids=req_ids)

    for variant in ("paged-attention kernels", "paged attention's plain version"):
        with patched(tiering, "paged_decode_attention",
                     (lambda f: f) if variant.endswith("kernels") else (lambda f: plain_paged)):
            eng = TieredEngine(spec, params, kv, device="cuda")
            batches, inner, run_routes = [], eng.step_fn, []

            def step(params_, state, tokens, req_ids, inner=inner, batches=batches):
                batches.append((tokens, req_ids))
                return inner(params_, state, tokens, req_ids)

            eng.step_fn = step
            with patched(layers, "moe_route", routing_recorder(kv.batch, run_routes)):
                for rid, p in prompts.items():
                    eng.add_request(Request(rid=rid, prompt=p, max_new_tokens=NEW_TOKENS))
                eng.run(max_steps=5000)
        outs = {rid: eng.requests[rid].out for rid in prompts}
        n_sets = sum(int((r >= 0).sum()) for _, r in batches) * cfg.n_layers
        for forced in (False, True):
            replay_routes = []
            with patched(layers, "moe_route", routing_recorder(kv.batch, replay_routes)):
                gaps = replay_dense(spec, params, prompts, batches, outs, device="cuda",
                                    routes=[idx for _, idx in run_routes] if forced else None)
            differ, first, deficit = routing_disagreement(run_routes, replay_routes, batches, cfg.n_layers)
            what = "tokens and routes" if forced else "tokens"
            print(f"  {variant}, replay of the {what}: {differ} of {n_sets} top-k sets differ "
                  f"(first at step, layer {first}); farthest run choice {deficit:.4f} below the replay's "
                  f"k-th logit; worst token gap {max(max(g) for g in gaps.values()):.4f}", flush=True)


if __name__ == "__main__":
    main()
