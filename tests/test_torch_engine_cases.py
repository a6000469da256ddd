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
from repro.models import dense as jax_dense
from repro.models import layers as jax_layers
from repro.models.api import ModelSpec as JaxSpec
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import TieredEngine as JaxEngine
from repro_torch import bridge, configs
from repro_torch.core.tiering import TieredKVConfig
from repro_torch.launch.serve import baseline_serve, replay_dense
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


def jax_exact(fn, *args):
    """``fn`` compiled for ``args``' shapes with every bf16 rounding kept (no
    excess precision in XLA's fusions): the bits of running ``fn`` op by op
    under ``jax.disable_jit()``, at compiled speed."""
    return jax.jit(fn).lower(*args).compile({"xla_allow_excess_precision": False})


def models(arch="qwen3-1.7b"):
    jspec = JaxSpec(jax_get_reduced(arch))
    jparams = jspec.init(jax.random.PRNGKey(0))
    params = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return jspec, jparams, ModelSpec(configs.get_reduced(arch)), params


def record_batches(eng):
    """Wrap ``eng.step_fn`` so that each step's (tokens, req_ids), as the
    engine hands them to the device, is kept in order."""
    batches, inner = [], eng.step_fn

    def step(params, state, tokens, req_ids):
        batches.append((tokens, req_ids))
        return inner(params, state, tokens, req_ids)

    eng.step_fn = step
    return batches


def run_both(case, prompts, n_new, arch="qwen3-1.7b"):
    jspec, jparams, spec, params = models(arch)
    jeng = JaxEngine(jspec, jparams, JaxKV(**CASES[case]))
    eng = TieredEngine(spec, params, TieredKVConfig(**CASES[case]), device="cpu")
    eng.batches = record_batches(eng)
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


def jax_replay_gaps(jspec, jparams, prompts, batches, forced):
    """The JAX counterpart of ``replay_dense``, built from the JAX package's
    model functions: each request prefilled alone, then the recorded steps
    (padded rows kept) over per-request dense caches. Returns, per request,
    max(logit) - logit[forced token] at each emitted position."""
    cfg = jspec.cfg
    rids = sorted(prompts)
    slot = {rid: i for i, rid in enumerate(rids)}
    s_max = max(len(prompts[r]) + len(forced[r]) for r in rids) + 1
    shape = (cfg.n_layers, len(rids) + 1, s_max, cfg.n_kv_heads, cfg.resolved_head_dim)
    ck, cv = jnp.zeros(shape, jnp.bfloat16), jnp.zeros(shape, jnp.bfloat16)
    gaps = {rid: [] for rid in rids}

    def gap(rid, lg):
        lg = np.asarray(lg, np.float32)
        gaps[rid].append(float(lg.max() - lg[forced[rid][len(gaps[rid])]]))

    lengths = {}
    for rid in rids:
        logits, cache = jspec.prefill(jparams, jnp.asarray(prompts[rid], jnp.int32)[None])
        S = len(prompts[rid])
        ck = ck.at[:, slot[rid], :S].set(cache["k"][:, 0])
        cv = cv.at[:, slot[rid], :S].set(cache["v"][:, 0])
        lengths[rid] = S
        gap(rid, logits[0])

    def step(ck, cv, tokens, rows, pos):
        x = jnp.take(jparams["embed"], tokens, axis=0)
        B = tokens.shape[0]
        for layer in range(cfg.n_layers):
            p_l = {k: v[layer] for k, v in jparams["blocks"].items()}
            h = jax_layers.rmsnorm(x, p_l["attn_norm"], cfg.norm_eps)
            q, k, v = jax_layers.project_qkv(cfg, jax_dense._attn_params(cfg, p_l), h, pos[:, None])
            ck = ck.at[layer, rows, pos].set(k[:, 0])
            cv = cv.at[layer, rows, pos].set(v[:, 0])
            o = jax_layers.decode_attention(q, ck[layer, rows], cv[layer, rows], pos + 1)
            x = x + jnp.einsum("bsh,hd->bsd", o.reshape(B, 1, -1), p_l["wo"])
            f, _ = jax_dense._ffn(cfg, p_l, jax_layers.rmsnorm(x, p_l["mlp_norm"], cfg.norm_eps))
            x = x + f
        return jax_dense.unembed(cfg, jparams, x)[:, 0], ck, cv

    compiled = None
    for tokens, req_ids in batches:
        req = [int(r) for r in np.asarray(req_ids)]
        rows = jnp.asarray([slot[r] if r >= 0 else len(rids) for r in req], jnp.int32)
        pos = jnp.asarray([lengths[r] if r >= 0 else 0 for r in req], jnp.int32)
        args = (ck, cv, jnp.asarray(np.asarray(tokens), jnp.int32), rows, pos)
        compiled = compiled or jax_exact(step, *args)
        logits, ck, cv = compiled(*args)
        for i, r in enumerate(req):
            if r >= 0:
                gap(r, logits[i])
                lengths[r] += 1
    return gaps


def check_moe_case(case, arch, prompts=PROMPTS, n_new=N_NEW):
    """A capacity-bounded MoE routes each row by the rows beside it, so its
    tokens are held against a replay of the engine's own batches over dense
    caches (``replay_dense``), not against a batch-1 dense decode."""
    (jspec, jparams, jeng, jstats), (spec, params, eng, stats) = run_both(case, prompts, n_new, arch)
    assert vars(stats) == vars(jstats), (case, arch, vars(stats), vars(jstats))
    forced = {rid: eng.requests[rid].out for rid in prompts}
    assert all(len(out) == n_new for out in forced.values())
    gaps = replay_dense(spec, params, prompts, eng.batches, forced, device="cpu")
    assert max(max(g) for g in gaps.values()) <= NEAR_TIE, (case, arch, gaps)
    differ = [rid for rid in prompts if forced[rid] != jeng.requests[rid].out]
    if differ:
        jgaps = jax_replay_gaps(jspec, jparams, prompts, eng.batches, forced)
        for rid in differ:
            assert max(jgaps[rid]) <= NEAR_TIE, (case, arch, rid, jgaps[rid])
    return stats, differ
