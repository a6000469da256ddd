"""The port's ModelSpec.loss and its gradients against JAX's
``value_and_grad`` of ``ModelSpec.loss``, on the CPU, for the reduced GQA
decoder archs (dense, moe, vlm): the analog of
tests/test_system.py::test_loss_and_grad. Same weights (through the bridge)
and batch (2 x 32) on both sides; harness and tolerances in
tests/test_torch_train_cases.py."""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_train_cases import (ARCHS, LOSS_RTOL, assert_grads_close, batches, f32, jax_flash_attention,  # noqa: F401
                                    jax_loss_and_grads, port_loss_and_grads, train_pair)

GQA = [a for a in ARCHS if a not in ("whisper-base", "rwkv6-3b", "zamba2-7b")]


@pytest.mark.parametrize("arch", GQA)
def test_loss_and_grads_match_jax(arch):
    pair = train_pair(arch)
    jb, tb = batches(pair.cfg, 2, 32, seed=5)
    jloss, jm, jgrads = jax_loss_and_grads(pair.jspec, pair.jparams, jb)
    loss, m, grads = port_loss_and_grads(pair.spec, pair.params, tb)
    assert set(m) == {"ce", "aux", "loss"} and all(t.dtype == torch.float32 and t.dim() == 0 for t in m.values())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=1e-5, atol=1e-7)
    if pair.cfg.family == "moe":
        assert float(m["aux"]) > 0
    assert_grads_close(pair, arch, grads, jgrads)


def test_vlm_loss_without_frontend_clamps_the_slice():
    """A vlm batch without patch embeddings: JAX's dynamic_slice clamps the
    start nf - 1 to 0, so each of the S logits scores its own token; the
    port clamps the same way."""
    pair = train_pair("llava-next-34b")
    jb, tb = batches(pair.cfg, 2, 32, seed=6)
    del jb["frontend"], tb["frontend"]
    jloss, jm, _ = jax_loss_and_grads(pair.jspec, pair.jparams, jb)
    loss, _, _ = port_loss_and_grads(pair.spec, pair.params, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)


def test_vlm_loss_reads_the_text_positions():
    """With nf frontend tokens the predictions are logits[:, nf-1 : nf-1+S]:
    a small frontend (nf = 4 < S) must give JAX's loss too."""
    pair = train_pair("llava-next-34b")
    cfg4 = dataclasses.replace(pair.cfg, n_frontend_tokens=4)
    jcfg4 = dataclasses.replace(pair.jspec.cfg, n_frontend_tokens=4)
    jb, tb = batches(cfg4, 2, 32, seed=7)
    jloss, _, _ = jax_loss_and_grads(type(pair.jspec)(jcfg4), pair.jparams, jb)
    loss, _, _ = port_loss_and_grads(type(pair.spec)(cfg4), pair.params, tb)
    assert tb["frontend"].shape[1] == 4
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
