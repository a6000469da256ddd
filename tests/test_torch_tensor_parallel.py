"""The port's split train step (``launch/steps.py::build_train_step(mesh=)``
for the dense, moe and vlm families: per-layer FSDP gathers, Megatron TP
over "model" for heads, ffn and vocab, EP for the experts) in gloo
processes on CPU meshes (``torch_dist_worker.py``), each step held to JAX's
single-device ``build_train_step`` from the same state, in ``jax_exact``
mode, and to the port's unsharded step from the same state, by the
one-step rules (``torch_step_rules.assert_one_step``).

Every case runs two steps from the bridged weights: step 0 without
compression and step 1 with int8 error feedback (the state carries the
residual throughout). Cases:

- reduced qwen3-1.7b (4 q / 2 KV heads of 16) on (1, 2) and (2, 2), and on
  (1, 4), where JAX's flattened split cuts each KV head in two, so a rank
  gathers its q head's KV head from its neighbour;
- reduced smollm-135m on (1, 2): 3 q heads over 2 cut a q head, so the
  attention takes the replicated route; tied embeddings, so the
  vocab-parallel embedding (128 over 2) is also the logits' weight;
- reduced qwen2.5-32b (QKV bias, sharded with its heads) on (2, 2);
- reduced llava-next-34b (vlm: 16 frontend rows projected by the
  replicated ``frontend_proj``, masked out of the loss) on (1, 2);
- reduced olmoe-1b-7b on (1, 2) and (2, 2) with the experts split over
  "model" (EP): JAX's ``lax.top_k`` takes the run's recorded expert ids
  (``forced_top_k``), and the dropped (token, choice) pairs equal the
  unsharded step's.

Each case's checkpoints (saved whole by the split step) are read by the
port's unsharded restore and by JAX's ``Checkpointer`` alike. Each case
also checks that no rank gathers the whole model: the most weight bytes
gathered over "data" alive at once (counted by the dry run's
``CountingWeights`` in ``use_weight``) stay within the dry run's
``split_gathered_bytes`` (the largest layer's compute shards plus those of
the leaves outside the layers), and are 0 where no axis splits "data"; and
the fp32 gradient sum AdamW is given has the rank's shards' elements. The (1, 1)
mesh of each family is bit-equal to the unsharded step
(tests/test_torch_distributed.py::test_1x1_mesh_is_the_unsharded_step_bit_for_bit).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs import OptimConfig as JaxOptimConfig
from repro.launch.steps import build_train_step as jax_build_train_step
from repro_torch import bridge
from repro_torch.configs import OptimConfig
from repro_torch.launch.dryrun import split_gathered_bytes
from repro_torch.launch.steps import build_train_step
from repro_torch.models import layers
from test_torch_distributed import QWEN_TOKENS, forced_top_k, frontend_rows, jax_state, optim_kw, start
from test_torch_train_cases import grad_tol, jax_exact, jax_flash_attention  # noqa: F401
from torch_step_rules import (LR, MU_TOL, NU_TOL, _rel, assert_one_step, assert_states_equal, quant_steps, restored,
                              run_ranks)

STEPS = 2
COMPRESS_FROM = 1  # step 0 plain, step 1 with int8 error feedback


def jax_steps(pair, state, batch_np, accum: int):
    """JAX's single-device step without and with compression, each compiled
    once: step k -> (metrics, the new state in the port's form)."""
    jb = {k: jnp.asarray(v, jnp.bfloat16 if k == "frontend" else None) for k, v in batch_np.items()}
    fns = [jax_exact(jax_build_train_step(pair.jspec, JaxOptimConfig(**optim_kw(compress)), accum_steps=accum),
                     jax_state(state), jb) for compress in (False, True)]

    def step(st, k):
        new, m = fns[int(k >= COMPRESS_FROM)](jax_state(st), jb)
        return {k_: float(v) for k_, v in m.items()}, bridge.train_state_from_jax(jax.tree_util.tree_map(np.asarray, new))

    return step


def unsharded_step(pair, state, batch_np, accum: int, k: int):
    """The port's unsharded step k from a copy of ``state``."""
    clone = lambda leaves: {n: t.clone() for n, t in leaves.items()}  # noqa: E731
    st = {"params": {n: t.clone().requires_grad_(True) for n, t in state["params"].items()},
          "opt": state["opt"]._replace(mu=clone(state["opt"].mu), nu=clone(state["opt"].nu),
                                       master=clone(state["opt"].master)),
          "residual": clone(state["residual"])}
    step = build_train_step(pair.spec, OptimConfig(**optim_kw(k >= COMPRESS_FROM)), accum)
    batch = {n: torch.tensor(v, dtype=torch.bfloat16 if n == "frontend" else torch.int32) for n, v in batch_np.items()}
    new, m = step(st, batch)
    return {n: float(v) for n, v in m.items()}, new


def run_split(tmp: Path, arch: str, mesh, routing: bool = False):
    """Two split steps from the bridged state (with a residual); returns
    (pair, batch as numpy, the run's metrics.json, the states)."""
    pair, _ = start(tmp, arch, True, QWEN_TOKENS)
    batch = {"tokens": QWEN_TOKENS}
    extra = {}
    fe = frontend_rows(pair.spec.cfg, *QWEN_TOKENS.shape)
    if fe is not None:
        np.save(tmp / "frontend.npy", fe)
        batch["frontend"] = fe
        extra["frontend"] = str(tmp / "frontend.npy")
    out = run_ranks(tmp, "run", int(np.prod(mesh)), arch=arch, mesh=list(mesh), axes=["data", "model"], accum=2,
                    lr=LR, compress=False, compress_from=COMPRESS_FROM, steps=STEPS, ckpt_in=str(tmp / "ckpt_in"),
                    step_in=0, batch=str(tmp / "batch.npy"), ckpt_out=str(tmp / "ckpt_out"),
                    save_after=list(range(STEPS + 1)), routing=routing, **extra)
    states = [restored(tmp / "ckpt_out", arch, True, k) for k in range(STEPS + 1)]
    # the split step's checkpoint (whole arrays) reads the same with JAX's Checkpointer
    jrestored, _, step = JaxCheckpointer(str(tmp / "ckpt_out")).restore(jax_state(states[0]), step=STEPS)
    assert step == STEPS
    assert_states_equal(bridge.train_state_from_jax(jax.tree_util.tree_map(np.asarray, jrestored)), states[STEPS])
    losses = [m["loss"] for m in out["metrics"]]
    assert np.isfinite(losses).all(), losses
    assert out["grad_elements"] == [out["shard_elements"]] * STEPS, "the fp32 gradient sum is not the rank's shards"
    # nothing is gathered without a "data" axis of more than one rank
    bound = split_gathered_bytes(pair.spec.cfg, dict(zip(("data", "model"), mesh)))
    assert out["gathered_peak"] <= bound and (out["gathered_peak"] > 0) == (mesh[0] > 1), (out["gathered_peak"], bound)
    return pair, batch, out, states


# qwen2.5-32b's key bias: a bias on k adds q.bk to every score of a query,
# which the softmax cancels but for RoPE's rotation, so its gradient is near
# 0 and mostly bf16 rounding on either side. Measured on this batch (step 0,
# mu over its max): the port's unsharded step 0.0586 from JAX's, the split
# step 0.0335 from JAX's and 0.0249 from the unsharded step's. Its mu and nu
# are held within twice the unsharded step's own gap.
ROUNDING_LEAVES = {("qwen2.5-32b", "blocks.bk"): 0.12}


def leaf_tols(pair, arch: str):
    """(mu's, nu's) tolerance of each leaf: mu by the loss tests' gradient
    tolerance (``grad_tol``: 5e-2 for the gains and biases, whose gradients
    sum bf16 products over every position and cancel, as qwen2.5-32b's bv
    at 0.022 in the unsharded loss test; 2e-2 = MU_TOL otherwise), nu by
    NU_TOL; both by ROUNDING_LEAVES where a leaf is listed there."""
    mu = lambda name: ROUNDING_LEAVES.get((arch, name), max(MU_TOL, grad_tol(pair.spec, arch, name)))  # noqa: E731
    nu = lambda name: ROUNDING_LEAVES.get((arch, name), NU_TOL)  # noqa: E731
    return dict(mu_tol=mu, nu_tol=nu)


def report(case: str, k: int, after, m, ref_after, ref_m) -> None:
    """Prints a step's measured gaps (``pytest -s``): relative loss and grad
    norm, and the largest mu gap over its leaf's max."""
    mu = max((_rel(after["opt"].mu[n], ref_after["opt"].mu[n]), n) for n in after["params"])
    print(f"{case} step {k}: loss {abs(m['loss'] - ref_m['loss']) / abs(ref_m['loss']):.3g}, grad norm "
          f"{abs(m['grad_norm'] - ref_m['grad_norm']) / ref_m['grad_norm']:.3g}, mu {mu[0]:.4f} ({mu[1]})")


def compressed_quant(out, k: int, names):
    """{leaf: int8 quantization step} of step k where it compressed."""
    return quant_steps(out, k - COMPRESS_FROM, names) if k >= COMPRESS_FROM else None


@pytest.mark.parametrize("arch,mesh", [
    ("qwen3-1.7b", (1, 2)), ("qwen3-1.7b", (2, 2)), ("qwen3-1.7b", (1, 4)), ("smollm-135m", (1, 2)),
    ("qwen2.5-32b", (2, 2)), ("llava-next-34b", (1, 2)),
])
def test_split_step_matches_jax_and_the_unsharded_step(tmp_path, arch, mesh):
    pair, batch, out, states = run_split(tmp_path, arch, mesh)
    jstep, tols = jax_steps(pair, states[0], batch, 2), leaf_tols(pair, arch)
    for k in range(STEPS):
        quant = compressed_quant(out, k, states[k]["params"])
        want_m, want = jstep(states[k], k)
        un_m, un = unsharded_step(pair, states[k], batch, 2, k)
        report(f"{arch} {mesh} vs JAX", k, states[k + 1], out["metrics"][k], want, want_m)
        report(f"{arch} {mesh} vs unsharded", k, states[k + 1], out["metrics"][k], un, un_m)
        assert_one_step(states[k], states[k + 1], out["metrics"][k], want, want_m, quant, **tols)
        assert_one_step(states[k], states[k + 1], out["metrics"][k], un, un_m, quant, **tols)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_olmoe_with_experts_split_over_model(tmp_path, mesh):
    """EP: each rank runs its 4 of 8 experts on its slice of the dispatch
    buffer and the partial outputs are summed over "model"; the routing,
    capacity and drops are the whole layer's. The drops equal the unsharded
    step's from the same state, and each step is held to the unsharded step
    and to JAX's, whose top-k takes the run's expert ids (bf16 router ties,
    ROADMAP.md §3; mu by the loss tests' gradient tolerance of each leaf, as
    in tests/test_torch_distributed.py)."""
    arch = "olmoe-1b-7b"
    pair, batch, out, states = run_split(tmp_path, arch, mesh, routing=True)
    assert sum(out["drops"]) > 0, "no (token, choice) pair was dropped: the capacity is not tested"
    recorded = np.load(tmp_path / "run" / "routing.npz")
    inner, drops = layers.moe_slots, []

    def counting(idx, num_experts, cap):
        pos, keep = inner(idx, num_experts, cap)
        drops.append(int((~keep).sum()))
        return pos, keep

    tols = leaf_tols(pair, arch)
    table = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "top_k", forced_top_k(table))
        jstep = jax_steps(pair, states[0], batch, 2)
    per_step = len(out["drops"]) // STEPS
    for k in range(STEPS):
        quant = compressed_quant(out, k, states[k]["params"])
        drops.clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(layers, "moe_slots", counting)
            un_m, un = unsharded_step(pair, states[k], batch, 2, k)
        assert out["drops"][k * per_step:(k + 1) * per_step] == drops
        calls = slice(k * per_step, (k + 1) * per_step)
        table.update(probs=recorded["probs"][calls], ids=recorded["ids"][calls])
        want_m, want = jstep(states[k], k)
        report(f"{arch} {mesh} vs JAX", k, states[k + 1], out["metrics"][k], want, want_m)
        report(f"{arch} {mesh} vs unsharded", k, states[k + 1], out["metrics"][k], un, un_m)
        assert_one_step(states[k], states[k + 1], out["metrics"][k], un, un_m, quant, **tols)
        assert_one_step(states[k], states[k + 1], out["metrics"][k], want, want_m, quant, **tols)
