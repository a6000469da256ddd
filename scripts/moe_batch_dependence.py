#!/usr/bin/env python3
"""Is the JAX reference's capacity-bounded MoE batch dependent?

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/moe_batch_dependence.py

Runs the JAX package (the reference; this script does not touch the port)
on the CPU: the tiered engine (``repro.serving.engine.TieredEngine``,
reduced configs, 4 prompts of 12 new tokens, a decode batch of 4) and, per
request, the batch-1 dense decode (prefill, then ``decode_step`` over a
dense cache). It prints how many of the engine's tokens equal the dense
decode's, and the engine's ServeStats, for reduced olmoe-1b-7b and reduced
llama4-scout at their capacity factor and at 64 (no drops). A dense arch
(qwen3-1.7b) is the control: the paper's invariant ("tiering changes speed,
never tokens") holds there.

``moe_ffn`` gives each expert ``max(1, int(T * k * capacity_factor / E))``
slots, T the rows of the call: at a decode step the batch (padded rows
included), in a batch-1 decode one token. So the batch decides which
(token, choice) pairs are dropped.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro.configs import get_reduced  # noqa: E402
from repro.core.tiering import TieredKVConfig  # noqa: E402
from repro.models.api import ModelSpec  # noqa: E402
from repro.serving.engine import Request, TieredEngine  # noqa: E402

N_NEW = 12
KV = TieredKVConfig(page_size=8, n_hbm_pages=32, max_requests=4, max_pages_per_req=12, log_slots=16, batch=4,
                    promote_pages_per_step=8)


def dense_decode(spec, params, prompt, n_new):
    logits, cache = spec.prefill(params, jnp.asarray(prompt, jnp.int32)[None])
    out = [int(jnp.argmax(logits[0]))]
    S = len(prompt)
    dc = spec.init_cache(1, S + n_new + 4)
    for kk in ("k", "v"):
        dc[kk] = jnp.pad(cache[kk], [(0, 0), (0, 0), (0, n_new + 4), (0, 0), (0, 0)])
    step = jax.jit(spec.decode_step)
    for i in range(n_new - 1):
        logits, dc = step(params, dc, jnp.asarray([[out[-1]]], jnp.int32), jnp.int32(S + i))
        out.append(int(jnp.argmax(logits[0])))
    return out


def main() -> None:
    rng = np.random.default_rng(0)
    prompts = {rid: [int(t) for t in rng.integers(1, 127, size=n)] for rid, n in enumerate((20, 35, 13, 27))}
    print(f"prompts {[len(p) for p in prompts.values()]} x {N_NEW} new tokens; {KV}")
    for arch, factor in (("qwen3-1.7b", None), ("olmoe-1b-7b", None), ("llama4-scout-17b-a16e", None),
                         ("olmoe-1b-7b", 64.0), ("llama4-scout-17b-a16e", 64.0)):
        cfg = get_reduced(arch)
        if factor is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))
        spec = ModelSpec(cfg)
        params = spec.init(jax.random.PRNGKey(0))
        eng = TieredEngine(spec, params, KV)
        for rid, p in prompts.items():
            eng.add_request(Request(rid=rid, prompt=p, max_new_tokens=N_NEW))
        stats = eng.run(max_steps=2000)
        same = sum(a == b for rid, p in prompts.items()
                   for a, b in zip(eng.requests[rid].out, dense_decode(spec, params, p, N_NEW)))
        cf = "" if cfg.moe is None else f", capacity_factor {cfg.moe.capacity_factor}"
        print(f"{cfg.name}{cf}: {same}/{len(prompts) * N_NEW} tokens equal the batch-1 dense decode; "
              f"stats {vars(stats)}", flush=True)


if __name__ == "__main__":
    main()
