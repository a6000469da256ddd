"""The split train step of the encoder-decoder, RWKV6 and Mamba2/Zamba2
families (``launch/steps.py::build_train_step(mesh=)``: per-layer FSDP
gathers, TP over "model" for attention and recurrent heads, ffn and vocab)
in gloo processes on CPU meshes (``torch_dist_worker.py``), each step held
to JAX's single-device ``build_train_step`` from the same state, in
``jax_exact`` mode (JAX's prefill attention its flash oracle), and to the
port's unsharded step from the same state, by the one-step rules
(``torch_step_rules.assert_one_step``; mu by the loss tests' gradient
tolerance of each leaf: 5e-2 for the gains, biases and rwkv6's leaves,
2e-2 otherwise; rwkv6's grad norm against JAX's by JAX_GNORM_RTOL).
Two steps from the bridged weights: step 0 without
compression, step 1 with int8 error feedback.

Cases: reduced whisper-base with vocab 129 on (1, 2): "model" does not
divide it (JAX's rule replicates the embedding's and ``lm_head``'s vocab
dim: the logits and the cross entropy whole on every rank; its self and
cross attention and gelu MLP split; whisper with its vocab split, on (2,
2): tests/test_torch_distributed.py); reduced rwkv6-3b on (2, 2) (4 heads
of 16, 2 a rank), and with 3 heads on (1, 2) ("inner" 48 splits into 1.5
heads: every rank computes every head); reduced zamba2-7b on (1, 2) and
(2, 2) (the mixers' heads and the shared block's heads split; the shared
block applied twice a step, its gradient reduced into the rank's shard
once a microbatch on (2, 2)). Each case also
checks that no rank gathers the whole model (the most weight bytes gathered
over "data" alive at once within the dry run's ``split_gathered_bytes``,
0 without a "data" axis) and that the fp32 gradient sum AdamW is given has
the rank's shards' elements. Their fp32 loss and gradients against the
unsharded model's: tests/test_torch_tp_ops.py; a 1 x 1 mesh, bit for bit:
tests/test_torch_distributed.py.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_reduced as jax_get_reduced
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro_torch import bridge
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch.dryrun import split_gathered_bytes
from test_torch_distributed import QWEN_TOKENS, frontend_rows
from test_torch_family_cases import make_pair, pair_of
from test_torch_tensor_parallel import COMPRESS_FROM, STEPS, compressed_quant, jax_steps, leaf_tols, report, unsharded_step
from test_torch_train_cases import jax_flash_attention, train_pair  # noqa: F401
from torch_dist_worker import reduced_config
from torch_step_rules import GNORM_RTOL, LR, assert_one_step, restored, run_ranks

# rwkv6's grad norm against JAX's: its gradients differ from JAX's by bf16
# noise of 2-5 % of a leaf's max (NOISY_ARCHS), and the grad norm by up to
# 4e-3 (reduced rwkv6-3b, this batch; the port's unsharded step from the
# same state: 2.15e-3 at step 0 with 3 heads, 4.07e-3 at the compressed
# step 1 with 4, where the int8 quantization moves elements by whole steps;
# the split step 2.29e-3 and 4.09e-3, and within 1.4e-4 of the unsharded
# step). Held to 1e-2 against JAX; GNORM_RTOL for every other arch.
JAX_GNORM_RTOL = {"rwkv6-3b": 1e-2}
CASES = [
    ("whisper-base", (1, 2), {"vocab": 129}),
    ("rwkv6-3b", (2, 2), {}), ("rwkv6-3b", (1, 2), {"ssm_heads": 3}),
    ("zamba2-7b", (1, 2), {}), ("zamba2-7b", (2, 2), {}),
]


def family_pair(arch: str, replace: dict, seed: int = 3):
    """The bridged weights of the reduced ``arch`` with ``replace``'s
    fields replaced on both sides (``reduced_config``'s names)."""
    if not replace:
        return train_pair(arch, seed)
    if "ssm_heads" in replace:
        jcfg = jax_get_reduced(arch)
        jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, heads=replace["ssm_heads"]))
        return pair_of(jcfg, reduced_config({"arch": arch, "replace": replace}), seed)
    return make_pair(arch, seed, **replace)


def run_family(tmp: Path, arch: str, mesh, replace: dict):
    """Two split steps from the bridged state (with a residual): (pair,
    batch as numpy, the run's metrics.json, the states)."""
    pair = family_pair(arch, replace)
    jstate = {"params": pair.jparams, "opt": jax_adamw_init(pair.jparams),
              "residual": jax.tree_util.tree_map(lambda x: jnp.zeros(x.shape, jnp.float32), pair.jparams)}
    Checkpointer(str(tmp / "ckpt_in"), async_save=False).save(
        0, bridge.train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate)))
    np.save(tmp / "batch.npy", QWEN_TOKENS)
    batch, extra = {"tokens": QWEN_TOKENS}, {}
    fe = frontend_rows(pair.cfg, *QWEN_TOKENS.shape)
    if fe is not None:
        np.save(tmp / "frontend.npy", fe)
        batch["frontend"], extra["frontend"] = fe, str(tmp / "frontend.npy")
    out = run_ranks(tmp, "run", int(np.prod(mesh)), arch=arch, replace=replace, mesh=list(mesh),
                    axes=["data", "model"], accum=2, lr=LR, compress=False, compress_from=COMPRESS_FROM, steps=STEPS,
                    ckpt_in=str(tmp / "ckpt_in"), step_in=0, batch=str(tmp / "batch.npy"),
                    ckpt_out=str(tmp / "ckpt_out"), save_after=list(range(STEPS + 1)), **extra)
    states = [restored(tmp / "ckpt_out", arch, True, k, replace) for k in range(STEPS + 1)]
    assert np.isfinite([m["loss"] for m in out["metrics"]]).all()
    assert out["grad_elements"] == [out["shard_elements"]] * STEPS, "the fp32 gradient sum is not the rank's shards"
    bound = split_gathered_bytes(pair.cfg, dict(zip(("data", "model"), mesh)))
    assert out["gathered_peak"] <= bound and (out["gathered_peak"] > 0) == (mesh[0] > 1), (out["gathered_peak"], bound)
    return pair, batch, out, states


@pytest.mark.parametrize("arch,mesh,replace", CASES)
def test_split_family_step_matches_jax_and_the_unsharded_step(tmp_path, arch, mesh, replace):
    pair, batch, out, states = run_family(tmp_path, arch, mesh, replace)
    jstep, tols = jax_steps(pair, states[0], batch, 2), leaf_tols(pair, arch)
    for k in range(STEPS):
        quant = compressed_quant(out, k, states[k]["params"])
        want_m, want = jstep(states[k], k)
        un_m, un = unsharded_step(pair, states[k], batch, 2, k)
        case = f"{arch} {mesh} {replace}"
        report(f"{case} vs JAX", k, states[k + 1], out["metrics"][k], want, want_m)
        report(f"{case} vs unsharded", k, states[k + 1], out["metrics"][k], un, un_m)
        report(f"{case} unsharded vs JAX", k, un, un_m, want, want_m)
        assert_one_step(states[k], states[k + 1], out["metrics"][k], want, want_m, quant,
                        gnorm_rtol=JAX_GNORM_RTOL.get(arch, GNORM_RTOL), **tols)
        assert_one_step(states[k], states[k + 1], out["metrics"][k], un, un_m, quant, **tols)
