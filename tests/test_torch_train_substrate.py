"""The port's data pipeline, checkpointer and train-state bridge on the CPU:
the analogs of tests/test_substrate.py:55-91, the pipeline's batches equal
to JAX's, and checkpoints that the JAX package's Checkpointer reads and
writes (the same layout)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.optim.adamw import AdamWState as JaxAdamWState
from repro_torch import bridge
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import DataState, SyntheticLM, make_pipeline
from repro_torch.launch.steps import make_train_state
from repro_torch.models.api import ModelSpec


@pytest.mark.parametrize("seed,vocab,seq,batch", [(0, 151936, 128, 2), (7, 1000, 64, 4), (3, 128, 33, 3)])
def test_pipeline_batches_equal_jax(seed, vocab, seq, batch):
    a, b = SyntheticLM(vocab, seq, batch, seed=seed), JaxSyntheticLM(vocab, seq, batch, seed=seed)
    for step in (0, 1, 5, 17):
        got, want = a.batch_at(step)["tokens"], b.batch_at(step)["tokens"]
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_data_pipeline_restart_safe():
    a = SyntheticLM(1000, 64, 4, seed=7)
    b = SyntheticLM(1000, 64, 4, seed=7)
    for step in (0, 3, 11):
        np.testing.assert_array_equal(a.batch_at(step)["tokens"], b.batch_at(step)["tokens"])
    assert not np.array_equal(a.batch_at(0)["tokens"], a.batch_at(1)["tokens"])
    assert DataState.from_dict(DataState(7, 12).to_dict()) == DataState(7, 12)


def test_make_pipeline_prefetches_in_order():
    src, it = make_pipeline(1000, 32, 2, seed=4, prefetch=2)
    ref = SyntheticLM(1000, 32, 2, seed=4)
    for step in range(4):
        np.testing.assert_array_equal(next(it)["tokens"], ref.batch_at(step)["tokens"])


def _state(seed=0, compress=True):
    spec = ModelSpec(get_reduced("smollm-135m"))
    state = make_train_state(spec, torch.Generator().manual_seed(seed), compress=compress, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for tree in (state["opt"].mu, state["opt"].nu, state.get("residual", {})):
        for t in tree.values():
            t.copy_(torch.randn(t.shape, generator=gen))
    return {**state, "opt": state["opt"]._replace(step=5 + seed)}


def _equal_states(a, b):
    assert a["opt"].step == b["opt"].step
    for tree in ("params", "residual"):
        assert list(a[tree]) == list(b[tree])
        for n in a[tree]:
            assert a[tree][n].dtype == b[tree][n].dtype and torch.equal(a[tree][n], b[tree][n]), (tree, n)
    for field in ("mu", "nu", "master"):
        for n, t in getattr(a["opt"], field).items():
            assert torch.equal(t, getattr(b["opt"], field)[n]), (field, n)


def test_checkpoint_roundtrip(tmp_path):
    state = _state(0)
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(5, state, extra={"data_step": 6})
    target = _state(1)  # other values, the same structure
    restored, extra, step = ck.restore(target, device="cpu")
    assert step == 5 and extra["data_step"] == 6
    _equal_states(restored, state)
    assert all(p.requires_grad for p in restored["params"].values())
    assert list(restored) == list(target)  # the target's key order


def test_checkpoint_keep_and_atomic(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.ones(3) * s})
    assert sorted(ck.all_steps()) == [3, 4]
    assert not list(tmp_path.glob(".tmp_step_*"))
    (tmp_path / ".tmp_step_9").mkdir()  # a save that died before its rename
    restored, _, step = ck.restore({"x": torch.zeros(3)})
    assert step == 4 and float(restored["x"][0]) == 4.0


def test_checkpoint_async_save_and_mismatch(tmp_path):
    ck = Checkpointer(str(tmp_path))  # async
    state = _state(2, compress=False)
    ck.save(3, state)
    state["params"]["embed"].data.zero_()  # the saved copy was taken at save()
    ck.wait()
    restored, _, _ = ck.restore(_state(3, compress=False))
    assert restored["params"]["embed"].abs().sum() > 0
    with pytest.raises(ValueError):
        ck.restore({"x": torch.zeros(3)})
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore({"x": torch.zeros(3)})


def _jax_state(state):
    tree = bridge.train_state_to_jax(state)
    tree["opt"] = JaxAdamWState(**tree["opt"])
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The port's checkpoint restores with JAX's Checkpointer into a JAX
    train state, and JAX's restores with the port's: the same leaves in the
    same order, bf16 as a uint16 view, the step an int32 scalar."""
    state = _state(4)
    Checkpointer(str(tmp_path / "port"), async_save=False).save(7, state, extra={"data_step": 7})
    jrestored, extra, step = JaxCheckpointer(str(tmp_path / "port")).restore(_jax_state(_state(5)))
    assert step == 7 and extra == {"data_step": 7}
    _equal_states(bridge.train_state_from_jax(jax.tree_util.tree_map(np.asarray, jrestored)), state)

    JaxCheckpointer(str(tmp_path / "jax"), async_save=False).save(9, _jax_state(state), extra={"data_step": 9})
    restored, extra, step = Checkpointer(str(tmp_path / "jax")).restore(_state(6))
    assert step == 9 and extra == {"data_step": 9}
    _equal_states(restored, state)


def test_train_state_bridge_round_trip():
    state = _state(7)
    back = bridge.train_state_from_jax(bridge.train_state_to_jax(state))
    _equal_states(back, state)
    assert all(p.requires_grad for p in back["params"].values())
