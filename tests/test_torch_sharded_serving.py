"""The port's sharded prefill and decode steps (``launch/steps.py::
build_prefill_step(mesh=)`` / ``build_serve_step(mesh=)`` with
``decode_cache(mesh=)``, the dense, moe and vlm families) in gloo processes
on CPU meshes (``torch_dist_worker.py``'s serve case), against JAX's
single-device ``prefill`` and ``decode_step`` on the same bridged weights
(``jax_exact``, JAX's prefill attention its flash oracle, as in
tests/test_torch_models.py) and against the port's unsharded steps.

Each case serves a prompt of 4 rows (prefill, then NEW greedy decode steps
whose positions cross a chunk boundary of the sequence-sharded cache) and
checks:

- every step's logits (whole vocab, every row) within LOGIT_TOL of JAX's,
  teacher-forced on the sharded run's tokens;
- the cache, gathered whole, within CACHE_TOL of JAX's;
- the tokens equal the unsharded steps' greedy tokens; where they differ,
  the sharded token lies within NEAR_TIE of the unsharded step's max logit
  on the same prefix (a bf16 near tie), and the count is printed;
- each rank's cache is ``cache_pspec``'s local shape (the sequence split
  over "model", the batch over "data"), and no rank gathers the whole
  model: the most weight bytes gathered over "data" alive at once (the dry
  run's ``CountingWeights``) stay within ``split_gathered_bytes``, and are
  0 where no axis splits "data".

Cases: reduced qwen3-1.7b on (1, 2), (2, 2), (1, 4) (JAX's flattened split
cuts each KV head: the "kv_gather" route), and on (1, 2) with a ``max_len``
"model" does not divide (the cache replicated, still correct); on (2, 2)
in JAX's "tp_only" serving layout (no FSDP: nothing gathered); smollm-135m
on (1, 2) (the "replicated" route, tied embeddings); qwen2.5-32b on (2, 2)
(QKV bias); llava-next-34b on (1, 2) (16 frontend rows); olmoe-1b-7b on
(1, 2) and (2, 2) (EP; JAX's ``lax.top_k`` takes the run's recorded expert
ids, ``forced_top_k``, and the drops equal the unsharded steps').
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.distributed.sharding import filter_spec_for_mesh, layout_cache_pspec, local_shape
from repro_torch.launch.dryrun import split_gathered_bytes
from repro_torch.launch.steps import decode_cache
from repro_torch.models import layers
from test_torch_distributed import forced_top_k, frontend_rows
from test_torch_engine_cases import jax_exact
from test_torch_train_cases import jax_flash_attention, train_pair  # noqa: F401
from torch_dist_worker import bits
from torch_step_rules import run_ranks

B, NEW = 4, 6
LOGIT_TOL = 2e-2  # tests/test_torch_models.py's: logits of ~0.1-1, bf16 noise
CACHE_TOL = 3e-2  # its V cache tolerance
NEAR_TIE = 2e-2


def serve_sharded(tmp: Path, arch: str, mesh, prompt: int, max_len: int, **extra):
    """The sharded steps' run on ``mesh``: (pair, tokens, frontend (fp32 of
    bf16, or None), the run's metrics.json, its logits (1 + NEW, B, V), its
    cache gathered {k, v} as bf16)."""
    pair = train_pair(arch)
    np.savez(tmp / "params.npz", **{n: bits(t) for n, t in pair.params.items()})
    tokens = np.random.default_rng(7).integers(0, pair.cfg.vocab, (B, prompt)).astype(np.int32)
    np.save(tmp / "tokens.npy", tokens)
    fe = frontend_rows(pair.cfg, B, prompt)
    if fe is not None:
        np.save(tmp / "frontend.npy", fe)
        extra["frontend"] = str(tmp / "frontend.npy")
    out = run_ranks(tmp, "serve", int(np.prod(mesh)), arch=arch, mesh=list(mesh), axes=["data", "model"], serve=True,
                    params=str(tmp / "params.npz"), tokens=str(tmp / "tokens.npy"), max_len=max_len, new=NEW, **extra)
    saved = np.load(tmp / "serve" / "cache.npz")
    cache = {k: torch.from_numpy(saved[k]).view(torch.bfloat16) for k in ("k", "v")}
    return pair, tokens, fe, out, np.load(tmp / "serve" / "logits.npy"), cache


def jax_steps(pair, tokens, fe, served: np.ndarray, max_len: int, table=None):
    """JAX's prefill and decode steps teacher-forced on ``served``: (each
    step's logits (1 + NEW, B, V) fp32, the final cache {k, v} fp32).
    ``table``: the olmoe run's routing, JAX's top-k forced to it, the prefill's
    calls, then the decode's."""
    jspec, jparams = pair.jspec, pair.jparams
    args = (jnp.asarray(tokens),) + (() if fe is None else (jnp.asarray(fe, jnp.bfloat16),))
    with pytest.MonkeyPatch.context() as mp:
        if table is not None:
            mp.setattr(jax.lax, "top_k", forced_top_k(table))
            table.update(probs=table["prefill_probs"], ids=table["prefill_ids"])
        jl, jc = jax_exact(jspec.prefill, jparams, *args)(jparams, *args)
        n = jc["k"].shape[2]
        jdc = jspec.init_cache(B, max_len)
        for key in ("k", "v"):
            jdc[key] = jnp.pad(jc[key], [(0, 0), (0, 0), (0, max_len - n), (0, 0), (0, 0)])
        step = jax_exact(jspec.decode_step, jparams, jdc, jnp.zeros((B, 1), jnp.int32), jnp.int32(n))
    if table is not None:
        table.update(probs=table["decode_probs"], ids=table["decode_ids"])
    logits = [np.asarray(jnp.asarray(jl, jnp.float32))]
    for i in range(NEW):
        jl, jdc = step(jparams, jdc, jnp.asarray(served[:, i:i + 1]), jnp.int32(n + i))
        logits.append(np.asarray(jnp.asarray(jl, jnp.float32)))
    return np.stack(logits), {k: np.asarray(jnp.asarray(jdc[k], jnp.float32)) for k in ("k", "v")}


def unsharded_steps(pair, tokens, fe, served: np.ndarray, max_len: int):
    """The port's unsharded prefill and decode teacher-forced on ``served``:
    (each step's logits (1 + NEW, B, V) fp32, each call's drops)."""
    spec, params = pair.spec, pair.params
    drops, inner = [], layers.moe_slots

    def counting(idx, num_experts, cap):
        pos, keep = inner(idx, num_experts, cap)
        drops.append(int((~keep).sum()))
        return pos, keep

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(layers, "moe_slots", counting)
        logits, cache = spec.prefill(params, torch.from_numpy(tokens),
                                     None if fe is None else torch.from_numpy(fe).to(torch.bfloat16))
        n = cache["k"].shape[2]
        dc, out = decode_cache(spec, cache, B, max_len, device="cpu"), [logits]
        for i in range(NEW):
            logits, dc = spec.decode_step(params, dc, torch.from_numpy(served[:, i:i + 1]), n + i)
            out.append(logits)
    return torch.stack(out).float().numpy(), drops


def check(tmp: Path, arch: str, mesh, prompt: int, max_len: int, rules: str = "default"):
    moe = arch == "olmoe-1b-7b"
    pair, tokens, fe, out, logits, cache = serve_sharded(tmp, arch, mesh, prompt, max_len, rules=rules, routing=moe)
    cfg = pair.cfg
    served = np.asarray(out["tokens"], np.int32)  # (B, 1 + NEW): the prefill's token, then each decode step's
    n = prompt + (cfg.n_frontend_tokens if fe is not None else 0)
    chunk = max_len // mesh[1] if max_len % mesh[1] == 0 and rules != "dp" else max_len  # "dp": the sequence whole
    assert n // chunk != (n + NEW - 1) // chunk or mesh[1] == 1 or chunk == max_len, "decode crosses no chunk boundary"
    assert served.shape == (B, 1 + NEW) and logits.shape == (1 + NEW, B, cfg.vocab)
    assert np.array_equal(served, logits.argmax(-1).T), "the tokens are not the greedy tokens of the logits"
    table = dict(np.load(tmp / "serve" / "routing.npz")) if moe else None
    want, want_cache = jax_steps(pair, tokens, fe, served, max_len, table)
    gap = float(np.abs(logits - want).max())
    cache_gap = max(float(np.abs(cache[k].float().numpy() - want_cache[k]).max()) for k in ("k", "v"))
    plain, drops = unsharded_steps(pair, tokens, fe, served, max_len)
    differ = plain.argmax(-1).T != served
    ties = plain.max(-1).T - np.take_along_axis(plain.transpose(1, 0, 2), served[..., None], -1)[..., 0]
    print(f"{arch} {mesh} max_len {max_len} ({rules}): logits {gap:.4g} from JAX's, cache {cache_gap:.4g}; "
          f"{int(differ.sum())} of {differ.size} tokens differ from the unsharded steps' "
          f"(largest gap to its max {float(ties.max()):.4g}); {float(np.abs(logits - plain).max()):.4g} from its logits")
    assert gap <= LOGIT_TOL, gap
    assert cache_gap <= CACHE_TOL, cache_gap
    assert float(ties.max()) <= NEAR_TIE, ties
    if moe:
        assert out["drops"]["prefill"] + out["drops"]["decode"] == drops and sum(drops) > 0, (out["drops"], drops)
    # each rank's cache is cache_pspec's local shape on the mesh (the layout's: under "dp" the rows over
    # ("data", "model"), the sequence whole)
    axes = dict(zip(("data", "model"), mesh))
    shape = (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    cspec = layout_cache_pspec(rules, pair.spec.cache_pspec())["k"]
    want_shape = local_shape(shape, filter_spec_for_mesh(cspec, axes, shape), axes)
    assert [tuple(s["k"]) for s in out["local_cache_shapes"]] == [want_shape] * int(np.prod(mesh)), \
        out["local_cache_shapes"]
    # no rank gathers the whole model
    bound = split_gathered_bytes(cfg, axes, rules)
    fsdp = mesh[0] > 1 and rules == "default"
    assert out["gathered_peak"] <= bound and (out["gathered_peak"] > 0) == fsdp, (out["gathered_peak"], bound)


@pytest.mark.parametrize("arch,mesh,prompt,max_len", [
    ("qwen3-1.7b", (1, 2), 14, 32), ("qwen3-1.7b", (2, 2), 14, 32), ("qwen3-1.7b", (1, 4), 14, 32),
    ("smollm-135m", (1, 2), 14, 32), ("qwen2.5-32b", (2, 2), 14, 32), ("llava-next-34b", (1, 2), 6, 48),
    ("olmoe-1b-7b", (1, 2), 14, 32), ("olmoe-1b-7b", (2, 2), 14, 32),
])
def test_sharded_serving_matches_jax_and_the_unsharded_steps(tmp_path, arch, mesh, prompt, max_len):
    check(tmp_path, arch, mesh, prompt, max_len)


def test_a_max_len_model_does_not_divide_replicates_the_cache(tmp_path):
    """``max_len`` 33 on (1, 2): ``filter_spec_for_mesh`` drops "model" from
    the sequence (JAX's rule), so each rank holds the whole sequence, writes
    every new row and attends over the whole cache; still correct."""
    check(tmp_path, "qwen3-1.7b", (1, 2), 14, 33)


def test_tp_only_layout_gathers_nothing(tmp_path):
    """JAX's "tp_only" serving layout (the default rules with ``embed``
    unsplit) on (2, 2): the steps read the layout from the params'
    placements, so the same steps serve it, with no FSDP gather."""
    check(tmp_path, "qwen3-1.7b", (2, 2), 14, 32, rules="tp_only")
