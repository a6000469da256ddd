"""The sharded prefill and decode steps of the encoder-decoder, RWKV6 and
Mamba2/Zamba2 families (``launch/steps.py::build_prefill_step(mesh=)`` /
``build_serve_step(mesh=)`` with ``decode_cache(mesh=)``) in gloo
processes on CPU meshes (``torch_dist_worker.py``'s serve case), against
JAX's single-device ``prefill`` and ``decode_step`` on the same bridged
weights (``jax_exact``, JAX's prefill attention its flash oracle) and
against the port's unsharded steps.

Each case serves a prompt of 4 rows of 14 tokens (whisper: 3 frames, so
the cross cache's 8 rows at ``max_len`` 32 hold 5 padded rows, which decode
attends, as JAX does; on (1, 2) the second rank's chunk is padding only),
then NEW greedy decode steps whose positions cross the self cache's chunk
boundary, and checks:

- every step's logits (whole vocab, every row) within LOGIT_TOL of JAX's,
  teacher-forced on the sharded run's tokens;
- every cache entry, gathered whole, against JAX's: bf16 entries within
  CACHE_TOL, fp32 states (rwkv6's WKV, Mamba2's SSM) within STATE_RTOL of
  the entry's largest |value|;
- the tokens are the unsharded steps' greedy tokens, or lie within
  NEAR_TIE of the unsharded step's max logit on the same prefix;
- each rank's cache entries are ``cache_pspec``'s local shapes (sequences
  split over "model", rwkv6's WKV heads over "model" where they divide,
  the token shifts and Mamba2's states whole), and no rank gathers the
  whole model (``split_gathered_bytes``; nothing on a "data" axis of one).

Cases: whisper-base on (1, 2), and with vocab 129 (replicated on "model":
the whole-vocab logits and greedy) on (2, 2); rwkv6-3b on (2, 2), and with
3 heads on (1, 2) (cut heads: every rank computes every head, the WKV
cache whole); zamba2-7b on (1, 2) and (2, 2). A 1 x 1 mesh, bit for bit:
tests/test_torch_distributed.py.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.distributed.sharding import filter_spec_for_mesh, local_shape
from repro_torch.launch.dryrun import split_gathered_bytes
from repro_torch.launch.steps import decode_cache
from test_torch_distributed import frontend_rows
from test_torch_engine_cases import jax_exact
from test_torch_family_cases import jax_into_cache
from test_torch_split_families import family_pair
from test_torch_train_cases import jax_flash_attention  # noqa: F401
from torch_dist_worker import bits, reduced_config
from torch_step_rules import run_ranks

B, PROMPT, NEW, MAX_LEN = 4, 14, 6, 32
LOGIT_TOL = 2e-2  # tests/test_torch_models.py's: logits of ~0.1-1, bf16 noise
CACHE_TOL = 3e-2  # its V cache tolerance
# fp32 recurrent states against JAX's, of the entry's largest |value|: the
# unsharded steps' own states lie this far from JAX's by bf16 noise in the
# projections (zamba2's after its first shared block: ROADMAP.md §3, held
# to 2e-2 by tests/test_torch_mamba2.py)
STATE_RTOL = 2e-2
NEAR_TIE = 2e-2
CASES = [
    ("whisper-base", (1, 2), {}), ("whisper-base", (2, 2), {"vocab": 129}),
    ("rwkv6-3b", (2, 2), {}), ("rwkv6-3b", (1, 2), {"ssm_heads": 3}),
    ("zamba2-7b", (1, 2), {}), ("zamba2-7b", (2, 2), {}),
]


def from_bits(a: np.ndarray, like) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if like.dtype == torch.bfloat16 else t


def jax_steps(pair, tokens, fe, served: np.ndarray):
    """JAX's prefill and decode steps teacher-forced on ``served``: (each
    step's logits (1 + NEW, B, V) fp32, the final cache's entries fp32)."""
    jspec, jparams = pair.jspec, pair.jparams
    args = (jnp.asarray(tokens),) + (() if fe is None else (jnp.asarray(fe, jnp.bfloat16),))
    jl, jc = jax_exact(jspec.prefill, jparams, *args)(jparams, *args)
    jdc = jax_into_cache(jspec.init_cache(B, MAX_LEN), jc)
    step = jax_exact(jspec.decode_step, jparams, jdc, jnp.zeros((B, 1), jnp.int32), jnp.int32(PROMPT))
    logits = [np.asarray(jnp.asarray(jl, jnp.float32))]
    for i in range(NEW):
        jl, jdc = step(jparams, jdc, jnp.asarray(served[:, i:i + 1]), jnp.int32(PROMPT + i))
        logits.append(np.asarray(jnp.asarray(jl, jnp.float32)))
    return np.stack(logits), {k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in jdc.items() if k != "length"}


def unsharded_steps(pair, tokens, fe, served: np.ndarray):
    """The port's unsharded prefill and decode teacher-forced on ``served``:
    each step's logits (1 + NEW, B, V) fp32."""
    spec, params = pair.spec, pair.params
    with torch.no_grad():
        logits, cache = spec.prefill(params, torch.from_numpy(tokens),
                                     None if fe is None else torch.from_numpy(fe).to(torch.bfloat16))
        dc, out = decode_cache(spec, cache, B, MAX_LEN, device="cpu"), [logits]
        for i in range(NEW):
            logits, dc = spec.decode_step(params, dc, torch.from_numpy(served[:, i:i + 1]), PROMPT + i)
            out.append(logits)
    return torch.stack(out).float().numpy()


def check(tmp: Path, arch: str, mesh, replace: dict):
    pair = family_pair(arch, replace)
    cfg = pair.cfg
    np.savez(tmp / "params.npz", **{n: bits(t) for n, t in pair.params.items()})
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    np.save(tmp / "tokens.npy", tokens)
    extra = {}
    fe = frontend_rows(cfg, B, PROMPT)
    if fe is not None:
        np.save(tmp / "frontend.npy", fe)
        extra["frontend"] = str(tmp / "frontend.npy")
    out = run_ranks(tmp, "serve", int(np.prod(mesh)), arch=arch, replace=replace, mesh=list(mesh),
                    axes=["data", "model"], serve=True, params=str(tmp / "params.npz"), tokens=str(tmp / "tokens.npy"),
                    max_len=MAX_LEN, new=NEW, **extra)
    logits = np.load(tmp / "serve" / "logits.npy")
    saved = np.load(tmp / "serve" / "cache.npz")
    served = np.asarray(out["tokens"], np.int32)  # (B, 1 + NEW): the prefill's token, then each decode step's
    assert served.shape == (B, 1 + NEW) and logits.shape == (1 + NEW, B, cfg.vocab)
    assert np.array_equal(served, logits.argmax(-1).T), "the tokens are not the greedy tokens of the logits"
    want, want_cache = jax_steps(pair, tokens, fe, served)
    like = pair.spec.cache_specs(B, MAX_LEN)
    assert sorted(saved.files) == sorted(want_cache), (saved.files, sorted(want_cache))
    gaps = {}
    for k in saved.files:
        got = from_bits(saved[k], like[k]).float().numpy()
        scale = 1.0 if like[k].dtype == torch.bfloat16 else max(float(np.abs(want_cache[k]).max()), 1e-30)
        gaps[k] = float(np.abs(got - want_cache[k]).max()) / scale
    gap = float(np.abs(logits - want).max())
    plain = unsharded_steps(pair, tokens, fe, served)
    differ = plain.argmax(-1).T != served
    ties = plain.max(-1).T - np.take_along_axis(plain.transpose(1, 0, 2), served[..., None], -1)[..., 0]
    print(f"{arch} {mesh} {replace}: logits {gap:.4g} from JAX's, cache {gaps}; {int(differ.sum())} of {differ.size} "
          f"tokens differ from the unsharded steps' (largest gap to its max {float(ties.max()):.4g}); "
          f"{float(np.abs(logits - plain).max()):.4g} from its logits")
    assert gap <= LOGIT_TOL, gap
    for k, g in gaps.items():
        assert g <= (CACHE_TOL if like[k].dtype == torch.bfloat16 else STATE_RTOL), (k, g)
    assert float(ties.max()) <= NEAR_TIE, ties
    # each rank's cache entries are cache_pspec's local shapes on the mesh
    axes, pspec = dict(zip(("data", "model"), mesh)), pair.spec.cache_pspec()
    want_shapes = {k: list(local_shape(t.shape, filter_spec_for_mesh(pspec[k], axes, t.shape), axes))
                   for k, t in like.items() if t.dim()}
    assert out["local_cache_shapes"] == [want_shapes] * int(np.prod(mesh)), out["local_cache_shapes"]
    bound = split_gathered_bytes(cfg, axes)
    assert out["gathered_peak"] <= bound and (out["gathered_peak"] > 0) == (mesh[0] > 1), (out["gathered_peak"], bound)
    return want_shapes


@pytest.mark.parametrize("arch,mesh,replace", CASES)
def test_sharded_family_serving_matches_jax_and_the_unsharded_steps(tmp_path, arch, mesh, replace):
    shapes = check(tmp_path, arch, mesh, replace)
    if arch == "rwkv6-3b":  # the WKV state's heads over "model" where they divide, whole where the split cuts one
        heads = reduced_config({"arch": arch, "replace": replace}).ssm.heads
        assert shapes["wkv"][2] == (heads if heads % mesh[1] else heads // mesh[1])
        assert shapes["tm_prev"][1] == B // mesh[0]
