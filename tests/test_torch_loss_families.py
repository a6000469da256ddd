"""The port's loss and gradients for the encoder-decoder, RWKV6 and
Mamba2/Zamba2 families against JAX's ``value_and_grad`` (CPU, reduced
archs; harness in tests/test_torch_train_cases.py), and the training
forward's own properties: remat changes no number, one ``unbind`` per
stack gives the gradients of per-layer indexing, and zamba2's gradients
stay finite where JAX's are NaN."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.models import common, dense
from repro_torch.models.api import ModelSpec
from test_torch_train_cases import (ARCHS, LOSS_RTOL, assert_grads_close, batches, jax_flash_attention,  # noqa: F401
                                    jax_loss_and_grads, make_pair, port_loss_and_grads, t2np, train_pair)


@pytest.mark.parametrize("arch", ["whisper-base", "rwkv6-3b", "zamba2-7b"])
def test_loss_and_grads_match_jax(arch):
    pair = train_pair(arch)
    jb, tb = batches(pair.cfg, 2, 32, seed=5)
    jloss, jm, jgrads = jax_loss_and_grads(pair.jspec, pair.jparams, jb)
    loss, m, grads = port_loss_and_grads(pair.spec, pair.params, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    assert_grads_close(pair, arch, grads, jgrads)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_number(arch):
    """remat=True (layer bodies recomputed in the backward) and remat=False
    give the same loss and gradients, bit for bit."""
    pair = make_pair(arch, seed=4)
    _, tb = batches(pair.cfg, 2, 32, seed=8)
    a = port_loss_and_grads(pair.spec, pair.params, tb, remat=True)
    b = port_loss_and_grads(pair.spec, pair.params, tb, remat=False)
    assert torch.equal(a[0], b[0])
    for n in a[2]:
        assert torch.equal(a[2][n], b[2][n]), n


def test_layer_stack_gives_the_layer_params_gradients(monkeypatch):
    """The training forward's per-layer views (one unbind per stack) give
    the gradients that per-layer indexing (``t[layer]``) gives, bit for
    bit, and the same loss."""
    spec = ModelSpec(get_reduced("qwen3-1.7b"))
    params = spec.init(torch.Generator().manual_seed(0), device="cpu")
    batch = spec.smoke_batch(torch.Generator().manual_seed(1), 2, 32, device="cpu")
    a = port_loss_and_grads(spec, params, batch)
    cfg = spec.cfg
    monkeypatch.setattr(dense, "layer_stack",
                        lambda p, stack="blocks": [{n: t[i] for n, t in common.sub_params(p, stack).items()}
                                                   for i in range(cfg.n_layers)])
    b = port_loss_and_grads(spec, params, batch)
    assert torch.equal(a[0], b[0])
    for n in a[2]:
        assert torch.equal(a[2][n], b[2][n]), n


def test_zamba2_grads_finite_where_jax_is_nan():
    """With random A_log / dt_bias / D a chunk's cumulative log-decay passes
    88: JAX's ``where(lower, exp(diff), 0)`` overflows above the diagonal
    and its gradients are NaN; the port masks before the exp (the same
    forward) and its gradients are finite. The losses agree."""
    pair = make_pair("zamba2-7b", seed=3)
    jb, tb = batches(pair.cfg, 2, 32, seed=5)
    jloss, _, jgrads = jax_loss_and_grads(pair.jspec, pair.jparams, jb)
    loss, _, grads = port_loss_and_grads(pair.spec, pair.params, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert not np.isfinite(np.asarray(jgrads["mamba"]["A_log"], np.float32)).all()
    assert all(torch.isfinite(g).all() for g in grads.values())
