"""Tiered KV runtime (core/tiering.py): port vs JAX on the same state and
weights (CPU, reduced qwen3-1.7b and reduced olmoe-1b-7b — the MoE layer at
a decode batch of 4, whose capacity of one slot an expert drops choices —
bf16 state as the engine keeps it)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core import tiering as jt
from repro.models.api import ModelSpec as JaxSpec
from repro_torch import bridge, configs
from repro_torch.core import tiering as pt
from repro_torch.models.api import ModelSpec
from test_torch_engine_cases import jax_exact

torch.set_num_threads(2)

KV_CFG = dict(page_size=8, n_hbm_pages=12, max_requests=3, max_pages_per_req=6, log_slots=16, batch=4)


def _torch(x):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _bits(x):
    """Raw bits of a tensor or array, for bit-for-bit comparison."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


@pytest.fixture(scope="module", params=["qwen3-1.7b", "olmoe-1b-7b"])
def setup(request):
    """Both runtimes in the same mid-serving state: two requests prefilled
    into the host tier, some of their pages promoted, a few tokens logged."""
    jspec = JaxSpec(jax_get_reduced(request.param))
    jparams = jspec.init(jax.random.PRNGKey(1))
    spec = ModelSpec(configs.get_reduced(request.param))
    params = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    jkv, kv = jt.TieredKVConfig(**KV_CFG), pt.TieredKVConfig(**KV_CFG)
    jstate = jt.init_state(jkv, jspec.cfg, dtype=jnp.bfloat16)
    state = pt.init_state(kv, spec.cfg, dtype=torch.bfloat16, device="cpu")
    rng = np.random.default_rng(0)
    for rid, S in ((0, 19), (2, 13)):
        prompt = rng.integers(0, 128, size=(1, S)).astype(np.int32)
        _, cache = jspec.prefill(jparams, jnp.asarray(prompt))
        k, v = cache["k"][:, 0], cache["v"][:, 0]
        jstate = jt.write_prefill_pages(jkv, jstate, rid, k, v)
        pt.write_prefill_pages(kv, state, rid, _torch(k), _torch(v))
    pairs = [[jt.host_slot(jkv, 0, 0), 3], [jt.host_slot(jkv, 0, 1), 0],
             [jt.host_slot(jkv, 0, 2), 7], [jt.host_slot(jkv, 2, 0), 5],
             [jt.host_slot(jkv, 2, 1), 9], [-1, 2]]
    jstate["hbm_k"], jstate["hbm_v"] = jt.copy_pages(
        jstate["hbm_k"], jstate["hbm_v"], jstate["host_k"], jstate["host_v"], jnp.asarray(pairs, jnp.int32))
    pt.copy_pages(state["hbm_k"], state["hbm_v"], state["host_k"], state["host_v"], pairs)
    table = -np.ones((3, 6), np.int32)
    table[0, :3] = (3, 0, 7)
    table[2, :2] = (5, 9)
    jstate["page_table"] = jnp.asarray(table)
    state["page_table"] = torch.from_numpy(table.copy())
    return jspec, jparams, spec, params, jkv, kv, jstate, state


def _same_state(jstate, state, keys):
    for key in keys:
        if key == "log_tail":
            assert int(jstate[key]) == state[key]
        else:
            np.testing.assert_array_equal(_bits(state[key]), _bits(jstate[key]), err_msg=key)


def test_prefill_placement_and_copy_match(setup):
    *_, jstate, state = setup
    _same_state(jstate, state, ["host_k", "host_v", "hbm_k", "hbm_v", "lengths", "compacted"])


def _jax_step(jspec, jkv):
    """JAX's decode step with every bf16 rounding kept. Under a plain jit,
    XLA may fuse elementwise ops and skip their intermediate bf16 roundings
    (excess precision), which moves later layers by an ulp; compiled
    without it (``jax_exact``, the bits of running it op by op), every op
    rounds as the port's eager ops do, and the two agree bit for bit."""
    step = jt.build_paged_decode_step(jspec, jkv)
    compiled = []

    def run(*args):
        if not compiled:
            compiled.append(jax_exact(step, *args))
        return compiled[0](*args)

    return run


def test_decode_steps_state_bit_exact(setup):
    """Three decode steps (one with a padded row) through the port's step
    (kv_log_append per layer) and JAX's (inline log writes): the write log,
    its meta rows, the tail and the lengths agree bit for bit."""
    jspec, jparams, spec, params, jkv, kv, jstate, state = setup
    jstep = _jax_step(jspec, jkv)
    step = pt.build_paged_decode_step(spec, kv)
    state = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in state.items()}
    batches = [([0, 2, -1, -1], [5, 9, 0, 0]), ([2, 0, -1, -1], [1, 2, 0, 0]), ([0, -1, 2, -1], [7, 0, 3, 0])]
    for req_ids, toks in batches:
        req = np.asarray(req_ids, np.int32)
        tok = np.asarray(toks, np.int32)[:, None]
        jnext, jstate = jstep(jparams, jstate, jnp.asarray(tok), jnp.asarray(req))
        nxt, state = step(params, state, torch.from_numpy(tok).long(), torch.from_numpy(req))
        _same_state(jstate, state, ["log_k", "log_v", "log_meta", "log_tail", "lengths"])
        live = req >= 0
        np.testing.assert_array_equal(nxt.numpy()[live], np.asarray(jnext)[live])


def test_compact_log_matches_jax(setup):
    """Compaction through log_compact (into both pools) equals JAX's."""
    jspec, jparams, spec, params, jkv, kv, jstate, state = setup
    jstep = _jax_step(jspec, jkv)
    step = pt.build_paged_decode_step(spec, kv)
    state = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in state.items()}
    req = np.asarray([0, 2, -1, -1], np.int32)
    tok = np.asarray([[4], [6], [0], [0]], np.int32)
    for _ in range(3):
        _, jstate = jstep(jparams, jstate, jnp.asarray(tok), jnp.asarray(req))
        _, state = step(params, state, torch.from_numpy(tok).long(), torch.from_numpy(req))
    # dirty pages: request 0 positions 19..21 (logical 2, resident in slot 7),
    # request 2 positions 13..15 (logical 1 resident in slot 9)
    fh = np.asarray([[0, 2, 7], [2, 1, 9]], np.int32)
    fo = np.asarray([[0, 2, jt.host_slot(jkv, 0, 2)], [2, 1, jt.host_slot(jkv, 2, 1)]], np.int32)
    jstate = jt.compact_log(jkv, jstate, jnp.asarray(fh), jnp.asarray(fo))
    pt.compact_log(kv, state, torch.from_numpy(fh), torch.from_numpy(fo))
    _same_state(jstate, state, ["hbm_k", "hbm_v", "host_k", "host_v", "log_meta", "log_tail", "compacted"])


def test_joint_targets_one_row_per_dirty_page():
    """The two tiers' flush lists become one table: a page resident in the
    fast pool gets both slots, a parked page -1 for the fast slot; padding
    rows (request -1) are dropped."""
    fh = np.asarray([[0, 2, 7], [2, 1, 9], [-1, 0, -1]], np.int32)
    fo = np.asarray([[0, 2, 16], [1, 0, 6], [2, 1, 13]], np.int32)
    assert pt.joint_targets(fh, fo) == [[0, 2, 7, 16], [1, 0, -1, 6], [2, 1, 9, 13]]
    assert pt.joint_targets(torch.from_numpy(fh[:1]), []) == [[0, 2, 7, -1]]
