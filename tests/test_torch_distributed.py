"""The port's sharded train step (``launch/steps.py::build_train_step(mesh=)``)
in gloo processes on CPU meshes, against JAX's single-device
``build_train_step`` on the same bridged weights and batch. JAX's own
sharded step cannot serve as the reference: ``tests/test_distributed.py``
fails in JAX (ROADMAP.md, "The reference's own state"), and GSPMD does not
change the math. Each test spawns its ranks (``torch_dist_worker.py``) with
a timeout of ``torch_step_rules.RUN_TIMEOUT`` seconds.

- reduced qwen3-1.7b on a (2, 4) data x model mesh, the batch of
  tests/test_distributed.py, accum 2, lr 1e-3, three steps, with and
  without int8 error feedback: the losses finite and falling, and each step
  against JAX's step from the same state by tests/test_torch_train_step.py's
  rules (``assert_one_step``);
- reduced olmoe-1b-7b on a (3, 2) mesh (embed 64 and the router fall back
  to replication on "data", the experts shard over "model"), batch 12,
  accum 2: the same, JAX's top-k taking the run's expert ids (bf16 router
  ties), with (token, choice) pairs dropped by the global capacity, the
  same ones as the unsharded step's;
- the same on a (2, 2, 2) pod x data x model mesh, with compression;
- reduced whisper-base on (2, 2), with compression, through the split
  step (until the encdec, rwkv6 and mamba2 families split their compute,
  this case held the step that gathered the whole model), each step
  against JAX's step;
- a 1 x 1 mesh equals the unsharded step bit for bit, and so do the
  sharded prefill and decode steps (one arch of each family; and in JAX's
  "tp_only" and "dp" layout profiles);
- elastic restore: saved on (2, 4), restored on (1, 1) and on (4, 2), the
  leaves equal, the next step equal.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import OptimConfig as JaxOptimConfig
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.optim.adamw import AdamWState as JaxAdamWState
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro_torch import bridge
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import OptimConfig, get_reduced
from repro_torch.launch.steps import build_train_step
from repro_torch.models import layers
from test_torch_train_cases import grad_tol, jax_exact, jax_flash_attention, train_pair  # noqa: F401
from torch_step_rules import LR, MU_TOL, assert_one_step, assert_states_equal, quant_steps, restored, run_ranks

# A router call of JAX's step is matched to the port's recorded call whose
# probabilities lie nearest; the two differ by bf16 rounding upstream
# (far below this), two different calls by far more.
ROUTE_MATCH = 1e-2


def start(tmp: Path, arch: str, compress: bool, tokens: np.ndarray):
    """The bridged train state saved as step 0 of ``tmp/ckpt_in``, the batch
    as ``tmp/batch.npy``; returns (pair, JAX state)."""
    pair = train_pair(arch)
    jstate = {"params": pair.jparams, "opt": jax_adamw_init(pair.jparams)}
    if compress:
        jstate["residual"] = jax.tree_util.tree_map(lambda x: jnp.zeros(x.shape, jnp.float32), pair.jparams)
    state = bridge.train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate))
    Checkpointer(str(tmp / "ckpt_in"), async_save=False).save(0, state)
    np.save(tmp / "batch.npy", tokens)
    return pair, jstate


def jax_state(state):
    """The port's train state as JAX's (jnp leaves, an AdamWState)."""
    tree = bridge.train_state_to_jax(state)
    tree["opt"] = JaxAdamWState(**tree["opt"])
    return jax.tree_util.tree_map(jnp.asarray, tree)


def optim_kw(compress: bool):
    return dict(lr=LR, warmup_steps=0, total_steps=10, compress_grads=compress)


def frontend_rows(cfg, B: int, S: int):
    """A vlm's patch embeddings (B, n_frontend_tokens, d) or an encdec's
    frame embeddings (B, S // 4, d), fp32 values of bf16 (the port is given
    them as bf16, JAX as the same bf16), or None."""
    n = {"vlm": cfg.n_frontend_tokens, "encdec": max(S // 4, 1)}.get(cfg.family)
    if n is None:
        return None
    x = np.random.default_rng(5).normal(size=(B, n, cfg.d_model)).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def with_frontend(tmp: Path, cfg, tokens: np.ndarray) -> dict:
    """The worker's case entry for the model's frontend rows (saved under
    ``tmp``), if it takes any."""
    fe = frontend_rows(cfg, *tokens.shape)
    if fe is None:
        return {}
    np.save(tmp / "frontend.npy", fe)
    return {"frontend": str(tmp / "frontend.npy")}


def jax_step_fn(pair, state, tokens, accum: int, compress: bool, frontend=None):
    """JAX's single-device step, compiled once: state (the port's) ->
    (metrics, the new state in the port's form)."""
    jb = {"tokens": jnp.asarray(tokens)}
    if frontend is not None:
        jb["frontend"] = jnp.asarray(frontend, jnp.bfloat16)
    fn = jax_exact(jax_build_train_step(pair.jspec, JaxOptimConfig(**optim_kw(compress)), accum_steps=accum),
                   jax_state(state), jb)

    def step(st):
        new, m = fn(jax_state(st), jb)
        return {k: float(v) for k, v in m.items()}, bridge.train_state_from_jax(jax.tree_util.tree_map(np.asarray, new))

    return step


def port_step(pair, state, tokens, accum: int, compress: bool):
    """The port's unsharded step from a copy of ``state``: (metrics, new
    state)."""
    st = {"params": {n: t.clone().requires_grad_(True) for n, t in state["params"].items()},
          "opt": state["opt"]._replace(mu={n: t.clone() for n, t in state["opt"].mu.items()},
                                       nu={n: t.clone() for n, t in state["opt"].nu.items()},
                                       master={n: t.clone() for n, t in state["opt"].master.items()})}
    if compress:
        st["residual"] = {n: t.clone() for n, t in state["residual"].items()}
    step = build_train_step(pair.spec, OptimConfig(**optim_kw(compress)), accum)
    new, m = step(st, {"tokens": torch.from_numpy(tokens)})
    return {k: float(v) for k, v in m.items()}, new


def run_steps(tmp: Path, arch: str, mesh, compress: bool, tokens: np.ndarray, steps: int = 3,
              axes=("data", "model"), **extra):
    """``steps`` sharded steps from the bridged state; returns (pair, the
    run's metrics.json, the state before each step and after the last)."""
    pair, _ = start(tmp, arch, compress, tokens)
    out = run_ranks(tmp, "run", int(np.prod(mesh)), arch=arch, mesh=mesh, axes=list(axes), accum=2, lr=LR,
                    compress=compress, steps=steps, ckpt_in=str(tmp / "ckpt_in"), step_in=0,
                    batch=str(tmp / "batch.npy"), ckpt_out=str(tmp / "ckpt_out"), save_after=list(range(steps + 1)),
                    **extra)
    states = [restored(tmp / "ckpt_out", arch, compress, k) for k in range(steps + 1)]
    losses = [m["loss"] for m in out["metrics"]]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    return pair, out, states


QWEN_TOKENS = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 64), 0, 100, jnp.int32))


@pytest.mark.parametrize("compress", [False, True])
def test_qwen3_on_2x4_matches_jax(tmp_path, compress):
    """Three steps on a (2, 4) mesh; each step against JAX's step from the
    same state (the trajectories of any two implementations part by bf16
    noise over steps, the port's unsharded step's too)."""
    pair, out, states = run_steps(tmp_path, "qwen3-1.7b", [2, 4], compress, QWEN_TOKENS)
    jstep = jax_step_fn(pair, states[0], QWEN_TOKENS, 2, compress)
    for k in range(3):
        want_m, want = jstep(states[k])
        quant = quant_steps(out, k, states[k]["params"]) if compress else None
        assert_one_step(states[k], states[k + 1], out["metrics"][k], want, want_m, quant)


def test_qwen3_on_a_pod_data_model_mesh_matches_jax(tmp_path):
    """The multi-pod layout, (2, 2, 2) as ("pod", "data", "model"): the
    batch split over pod and data (pod major), the gradient summed over
    both; two steps, each against JAX's step from the same state."""
    pair, out, states = run_steps(tmp_path, "qwen3-1.7b", [2, 2, 2], True, QWEN_TOKENS, steps=2,
                                  axes=("pod", "data", "model"))
    jstep = jax_step_fn(pair, states[0], QWEN_TOKENS, 2, True)
    for k in range(2):
        want_m, want = jstep(states[k])
        assert_one_step(states[k], states[k + 1], out["metrics"][k], want, want_m, quant_steps(out, k, states[k]["params"]))


def forced_top_k(table):
    """``jax.lax.top_k`` for the trace of JAX's MoE: each router call takes
    the expert ids a port run recorded for the same call, and the
    probabilities at them as its gates (``moe_ffn(experts=)``'s rule).
    ``table`` holds one step's calls: "probs" (calls, T0, E), rank 0's router
    probabilities of its own rows (the first T0 of the global microbatch),
    and "ids" (calls, T, k), the global expert ids. A call is the recorded
    one whose probabilities lie nearest, within ROUTE_MATCH."""

    def lookup(probs):
        probs = np.asarray(probs)
        gap = np.abs(table["probs"] - probs[None, :table["probs"].shape[1]]).max(axis=(1, 2))
        c = int(gap.argmin())
        if gap[c] > ROUTE_MATCH:
            raise AssertionError(f"no recorded router call within {ROUTE_MATCH} (nearest {gap[c]})")
        return table["ids"][c].astype(np.int32)

    def top_k(probs, k):
        shape = jax.ShapeDtypeStruct(probs.shape[:-1] + (k,), jnp.int32)
        idx = jax.pure_callback(lookup, shape, jax.lax.stop_gradient(probs))
        return jnp.take_along_axis(probs, idx, axis=-1), idx

    return top_k


def test_olmoe_on_3x2_matches_jax_with_global_capacity(tmp_path):
    """Three steps on a (3, 2) mesh: embed 64 and the router replicated on
    "data" (3 does not divide 64), the experts split over "model". The
    global capacity drops (token, choice) pairs, the same ones as the
    port's unsharded step. bf16 router logits tie exactly between experts,
    and a one-ulp difference between torch's and XLA's GEMMs breaks a tie
    the other way (ROADMAP.md §3), so JAX's top-k takes the sharded run's
    expert ids (``forced_top_k``); its capacity, slots, drops, gates, aux
    and gradients are its own. Each step is then held to JAX's step from
    the same state by ``assert_one_step`` (mu by the loss tests' gradient
    tolerance of each leaf), and to the port's unsharded step by it as it
    stands."""
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (12, 64), 0, 100, jnp.int32))
    pair, out, states = run_steps(tmp_path, "olmoe-1b-7b", [3, 2], False, tokens, routing=True)
    assert sum(out["drops"]) > 0, "no (token, choice) pair was dropped: the global capacity is not tested"
    recorded = np.load(tmp_path / "run" / "routing.npz")
    inner, drops = layers.moe_slots, []

    def counting(idx, num_experts, cap):
        pos, keep = inner(idx, num_experts, cap)
        drops.append(int((~keep).sum()))
        return pos, keep

    # mu after step 0 is (1 - b1) x the clipped gradient: against JAX, each
    # leaf within its gradient tolerance of the loss tests (grad_tol: 5e-2
    # for the norm gains, which sum bf16 products over every position;
    # measured: attn_norm 0.0207 at step 0, wk 0.0190, the rest <= 0.0151)
    jax_mu_tol = lambda name: max(MU_TOL, grad_tol(pair.spec, "olmoe-1b-7b", name))  # noqa: E731
    table = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "top_k", forced_top_k(table))
        jstep = jax_step_fn(pair, states[0], tokens, 2, False)
    per_step = len(out["drops"]) // 3  # the sharded run's MoE calls a step (forward and remat recompute)
    for k in range(3):
        drops.clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(layers, "moe_slots", counting)
            un_m, un = port_step(pair, states[k], tokens, 2, False)
        assert out["drops"][k * per_step:(k + 1) * per_step] == drops
        assert_one_step(states[k], states[k + 1], out["metrics"][k], un, un_m)
        calls = slice(k * per_step, (k + 1) * per_step)
        table.update(probs=recorded["probs"][calls], ids=recorded["ids"][calls])
        want_m, want = jstep(states[k])
        assert_one_step(states[k], states[k + 1], out["metrics"][k], want, want_m, mu_tol=jax_mu_tol)


def test_whole_gather_family_on_2x2_matches_jax(tmp_path):
    """Reduced whisper-base (encdec, with its frame rows) on a (2, 2) mesh,
    with int8 error feedback: two steps, each against JAX's step from the
    same state (mu by the loss tests' gradient tolerance of each leaf). The
    encdec family once took a sharded step that gathered the whole bf16
    model; it now takes the split step (dense's TP for the encoder, the
    decoder and cross-attention; tests/test_torch_split_families.py holds
    every family's), which this case holds to JAX as it held that one."""
    arch = "whisper-base"
    extra = with_frontend(tmp_path, get_reduced(arch), QWEN_TOKENS)
    pair, out, states = run_steps(tmp_path, arch, [2, 2], True, QWEN_TOKENS, steps=2, **extra)
    jstep = jax_step_fn(pair, states[0], QWEN_TOKENS, 2, True, frontend=np.load(extra["frontend"]))
    mu_tol = lambda name: max(MU_TOL, grad_tol(pair.spec, arch, name))  # noqa: E731
    for k in range(2):
        want_m, want = jstep(states[k])
        assert_one_step(states[k], states[k + 1], out["metrics"][k], want, want_m,
                        quant_steps(out, k, states[k]["params"]), mu_tol=mu_tol)


@pytest.mark.parametrize("arch,layout", [
    pytest.param(arch, "default", id=arch) for arch in ("qwen3-1.7b", "olmoe-1b-7b", "llava-next-34b", "whisper-base",
                                                         "rwkv6-3b", "zamba2-7b")
] + [pytest.param(arch, layout, id=f"{arch}-{layout}") for arch, layout in (
    ("qwen3-1.7b", "dp"), ("qwen3-1.7b", "tp_only"), ("olmoe-1b-7b", "dp"), ("whisper-base", "dp"), ("zamba2-7b", "dp"),
    ("smollm-135m", "dp"))])
def test_1x1_mesh_is_the_unsharded_step_bit_for_bit(tmp_path, arch, layout):
    """One arch of each family (dense, moe, vlm with its frontend rows,
    encdec with its frame rows, rwkv6, zamba2), and a few in JAX's "dp" and
    "tp_only" layout profiles: on 1 x 1 every gather is a view and every op
    the unsharded one. The trained params then serve a prompt (4 rows of 32
    tokens, 4 new) through the sharded prefill and decode steps and through
    the unsharded ones: tokens, logits and every cache entry bit-equal."""
    pair, _ = start(tmp_path, arch, True, QWEN_TOKENS)
    extra = with_frontend(tmp_path, pair.spec.cfg, QWEN_TOKENS)
    out = run_ranks(tmp_path, "run", 1, arch=arch, mesh=[1, 1], axes=["data", "model"], rules=layout, accum=2, lr=LR,
                    compress=True, steps=2, ckpt_in=str(tmp_path / "ckpt_in"), step_in=0,
                    batch=str(tmp_path / "batch.npy"), ckpt_out=str(tmp_path / "ckpt_out"), save_after=[2],
                    unsharded=True, serve_check=True, **extra)
    assert out["metrics"] == out["unsharded"]
    assert out["serve_equal"] is True
    assert_states_equal(restored(tmp_path / "ckpt_out", arch, True, 2),
                        restored(tmp_path / "ckpt_out_unsharded", arch, True, 2))


def test_elastic_restore(tmp_path):
    """Saved on (2, 4) after step 1; restored on (1, 1) and on (4, 2): the
    restored leaves, saved again, equal the checkpoint's; the next step on
    (1, 1) is the unsharded next step bit for bit, and on (4, 2) JAX's next
    step from the checkpoint, by ``assert_one_step``."""
    arch = "qwen3-1.7b"
    case = dict(arch=arch, axes=["data", "model"], accum=2, lr=LR, compress=True, batch=str(tmp_path / "batch.npy"))
    pair, _ = start(tmp_path, arch, True, QWEN_TOKENS)
    run_ranks(tmp_path, "a", 8, mesh=[2, 4], steps=1, ckpt_in=str(tmp_path / "ckpt_in"), step_in=0,
              ckpt_out=str(tmp_path / "a"), save_after=[1], **case)
    saved = restored(tmp_path / "a", arch, True, 1)
    for name, mesh in (("b", [1, 1]), ("c", [4, 2])):
        world = int(np.prod(mesh))
        out = run_ranks(tmp_path, name, world, mesh=mesh, steps=1, ckpt_in=str(tmp_path / "a"), step_in=1,
                        ckpt_out=str(tmp_path / name), save_after=[0, 1], unsharded=(world == 1), **case)
        assert_states_equal(restored(tmp_path / name, arch, True, 1), saved)
        after = restored(tmp_path / name, arch, True, 2)
        if world == 1:
            assert out["metrics"] == out["unsharded"]
            assert_states_equal(after, restored(tmp_path / f"{name}_unsharded", arch, True, 2))
        else:
            want_m, want = jax_step_fn(pair, saved, QWEN_TOKENS, 2, True)(saved)
            assert_one_step(saved, after, out["metrics"][0], want, want_m, quant_steps(out, 0, saved["params"]))
