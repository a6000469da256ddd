"""Shared harness of the port-vs-JAX serving-engine tests
(tests/test_torch_engine_*.py; this module holds no tests itself): the same
weights (through the bridge) and prompts go to the JAX TieredEngine and to
the port's, on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core.tiering import TieredKVConfig as JaxKV
from repro.models.api import ModelSpec as JaxSpec
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import TieredEngine as JaxEngine
from repro_torch import bridge, configs
from repro_torch.core.tiering import TieredKVConfig
from repro_torch.launch.serve import baseline_serve
from repro_torch.models.api import ModelSpec
from repro_torch.serving.engine import Request, TieredEngine

torch.set_num_threads(2)

# tests/test_tiering.py's cases and prompts
CASES = {
    "compaction": dict(page_size=8, n_hbm_pages=32, max_requests=4, max_pages_per_req=12,
                       log_slots=8, batch=2, promote_pages_per_step=8),
    "pool_pressure": dict(page_size=8, n_hbm_pages=16, max_requests=4, max_pages_per_req=12,
                          log_slots=32, batch=2, promote_pages_per_step=2),
    "coalescing": dict(page_size=8, n_hbm_pages=32, max_requests=2, max_pages_per_req=12,
                       log_slots=16, batch=1, promote_pages_per_step=8),
}
PROMPTS = {0: list(range(7, 27)), 1: list(range(40, 75)), 2: list(range(5, 18))}
N_NEW = 20
# A port token that differs from JAX's must still be within this much of the
# maximum of JAX's teacher-forced logits: the two prefills differ by bf16
# rounding (flash attention's fp32 weights vs chunked_attention's bf16
# weights), which moves logits of size ~0.3 by a few bf16 ulps.
NEAR_TIE = 1e-2


def models():
    jspec = JaxSpec(jax_get_reduced("qwen3-1.7b"))
    jparams = jspec.init(jax.random.PRNGKey(0))
    params = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return jspec, jparams, ModelSpec(configs.get_reduced("qwen3-1.7b")), params


def run_both(case, prompts, n_new):
    jspec, jparams, spec, params = models()
    jeng = JaxEngine(jspec, jparams, JaxKV(**CASES[case]))
    eng = TieredEngine(spec, params, TieredKVConfig(**CASES[case]), device="cpu")
    for rid, p in prompts.items():
        jeng.add_request(JaxRequest(rid=rid, prompt=p, max_new_tokens=n_new))
        eng.add_request(Request(rid=rid, prompt=p, max_new_tokens=n_new))
    jstats = jeng.run(max_steps=2000)
    stats = eng.run(max_steps=2000)
    return (jspec, jparams, jeng, jstats), (spec, params, eng, stats)


def jax_forced_gaps(jspec, jparams, prompt, forced):
    """max(logit) - logit[forced token] of JAX's dense decode, teacher-forced."""
    logits, cache = jspec.prefill(jparams, jnp.asarray(prompt, jnp.int32)[None])
    S, n = len(prompt), len(forced)
    dc = jspec.init_cache(1, S + n + 4)
    for kk in ("k", "v"):
        dc[kk] = jnp.pad(cache[kk], [(0, 0), (0, 0), (0, n + 4), (0, 0), (0, 0)])
    step = jax.jit(jspec.decode_step)
    gaps = []
    for i, tok in enumerate(forced):
        lg = np.asarray(logits[0], np.float32)
        gaps.append(float(lg.max() - lg[tok]))
        if i + 1 < n:
            logits, dc = step(jparams, dc, jnp.asarray([[tok]], jnp.int32), jnp.int32(S + i))
    return gaps


def check_case(case, prompts=PROMPTS, n_new=N_NEW):
    (jspec, jparams, jeng, jstats), (spec, params, eng, stats) = run_both(case, prompts, n_new)
    # the policy depends on lengths only: every counter equals JAX's
    assert vars(stats) == vars(jstats), (case, vars(stats), vars(jstats))
    # the paper's invariant: tiering changes speed, never tokens
    dense, _ = baseline_serve(spec, params, prompts, n_new, device="cpu")
    for rid in prompts:
        assert eng.requests[rid].out == dense[rid], f"{case}: request {rid} differs from dense decode"
        ours, theirs = eng.requests[rid].out, jeng.requests[rid].out
        if ours != theirs:
            gaps = jax_forced_gaps(jspec, jparams, prompts[rid], ours)
            assert max(gaps) <= NEAR_TIE, (case, rid, gaps)
    return stats
