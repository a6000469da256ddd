"""JAX's layout profiles (``REPRO_LAYOUT``: "default", "tp_only", "dp";
``repro/launch/dryrun.py:142-164``) in the port's sharded steps, on gloo
CPU ranks of ``torch_dist_worker.py`` (its ``rules`` key), each step held
to JAX's single-device ``build_train_step`` from the same state by the
one-step rules (``torch_step_rules.assert_one_step``):

- "dp" (every parameter replicated, the rows over ("data", "model"), no
  "model" split in the compute) on (1, 2), (2, 2) and (pod 2, data 1,
  model 2) of reduced qwen3-1.7b: every rank's params bit-equal after the
  step. On the pod mesh the pods hold the same rows: a gradient summed over
  them as well would be twice JAX's;
- "dp" with a microbatch of 2 rows on (1, 4): the batch axes do not divide
  it, so every rank computes every row (``filter_spec_for_mesh``'s
  replication), and nothing is summed over ranks;
- "tp_only" (the default rules with ``embed`` unsplit) train on (2, 2):
  nothing gathered over "data";
- "dp" prefill and decode on (1, 2) against JAX's steps and the unsharded
  ones (tests/test_torch_sharded_serving.py's ``check``: each rank's cache
  holds its rows with the sequence whole);
- the dry run's meta FLOPs of a "dp" and a "tp_only" (1, 2) prefill and
  decode cell equal rank 0's count in the sharded steps on CPU ranks;
- ``layout_rules`` / ``layout_batch_spec`` equal JAX's dry run's, and
  ``spec_for_leaf`` keeps an all-None rules dict.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jax_sharding
from repro.models.api import ModelSpec as JaxSpec
from repro_torch import configs
from repro_torch.configs import ShapeConfig
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.models.api import ModelSpec
from repro_torch.models.common import flat_leaves
from test_torch_distributed import QWEN_TOKENS, jax_step_fn, start
from test_torch_dryrun import _FakeMesh, _jax_flat
from test_torch_sharded_serving import check
from test_torch_train_cases import jax_flash_attention  # noqa: F401
from torch_dist_worker import bits
from torch_step_rules import LR, assert_one_step, quant_steps, restored, run_ranks

ARCH = "qwen3-1.7b"


def one_step(tmp, mesh, axes, rules: str, tokens: np.ndarray, compress: bool = False):
    """One sharded step of reduced qwen3-1.7b from the bridged state in
    layout ``rules``, held to JAX's single-device step from the same state;
    returns the run's metrics.json."""
    pair, _ = start(tmp, ARCH, compress, tokens)
    out = run_ranks(tmp, "run", int(np.prod(mesh)), arch=ARCH, mesh=list(mesh), axes=list(axes), rules=rules,
                    accum=2, lr=LR, compress=compress, steps=1, ckpt_in=str(tmp / "ckpt_in"), step_in=0,
                    batch=str(tmp / "batch.npy"), ckpt_out=str(tmp / "ckpt_out"), save_after=[0, 1])
    before, after = (restored(tmp / "ckpt_out", ARCH, compress, k) for k in (0, 1))
    want_m, want = jax_step_fn(pair, before, tokens, 2, compress)(before)
    quant = quant_steps(out, 0, before["params"]) if compress else None
    assert_one_step(before, after, out["metrics"][0], want, want_m, quant)
    return out


@pytest.mark.parametrize("mesh,axes,compress", [
    ((1, 2), ("data", "model"), False),
    ((2, 2), ("data", "model"), False),
    ((2, 1, 2), ("pod", "data", "model"), True),
], ids=["1x2", "2x2", "pod2x1x2"])
def test_dp_train_step_matches_jax(tmp_path, mesh, axes, compress):
    """The "dp" step: every rank a replica, its rows (2, 1 and 2 of each
    microbatch of 4) over ("data", "model"), the gradient the mean over the
    distinct rows; nothing gathered; every rank's params bit-equal."""
    out = one_step(tmp_path, mesh, axes, "dp", QWEN_TOKENS, compress)
    assert len(set(out["param_digests"])) == 1, out["param_digests"]
    assert out["gathered_peak"] == 0
    assert out["grad_elements"] == [out["shard_elements"]]  # the whole model a rank


def test_dp_microbatch_the_batch_axes_do_not_divide(tmp_path):
    """2 rows a microbatch on (1, 4): every rank computes both rows, as
    ``filter_spec_for_mesh`` replicates a batch the axes do not divide, and
    the step is still JAX's."""
    out = one_step(tmp_path, (1, 4), ("data", "model"), "dp", QWEN_TOKENS[:4])
    assert len(set(out["param_digests"])) == 1, out["param_digests"]


def test_tp_only_train_step_matches_jax(tmp_path):
    """"tp_only" on (2, 2): the weights split over "model" only, the rows
    over "data"; nothing gathered over "data"."""
    out = one_step(tmp_path, (2, 2), ("data", "model"), "tp_only", QWEN_TOKENS)
    assert out["gathered_peak"] == 0
    assert out["param_digests"][0] == out["param_digests"][2] != out["param_digests"][1]  # replicas over "data"


def test_dp_serving_matches_jax_and_the_unsharded_steps(tmp_path):
    """"dp" prefill and decode on (1, 2): each rank's 2 rows through the
    replicated weights, its cache rows with the sequence whole."""
    check(tmp_path, ARCH, (1, 2), 14, 32, rules="dp")


@pytest.mark.parametrize("layout", ["dp", "tp_only"])
def test_layout_serve_cell_flops_on_meta_equal_the_sharded_steps_on_cpu(tmp_path, layout):
    """A (1, 2) prefill and decode cell of reduced qwen3-1.7b in ``layout``:
    the dry run's meta count of rank 0's body equals the FLOPs rank 0
    computes in the sharded steps on two CPU gloo ranks; "dp" sends nothing
    over "model" and gathers nothing."""
    cfg = configs.get_reduced(ARCH)
    spec = ModelSpec(cfg)
    B, S, mesh = 4, 16, {"data": 1, "model": 2}
    params = spec.init(torch.Generator().manual_seed(0), device="cpu")
    np.savez(tmp_path / "params.npz", **{n: bits(t) for n, t in params.items()})
    np.save(tmp_path / "tokens.npy", np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(np.int32))
    out = run_ranks(tmp_path, "flops", 2, arch=ARCH, mesh=list(mesh.values()), axes=list(mesh), serve=True,
                    rules=layout, params=str(tmp_path / "params.npz"), tokens=str(tmp_path / "tokens.npy"), flops=True)
    for kind, got in zip(("prefill", "decode"), out["flops"]):
        meta = dryrun.cell_flops(cfg, ShapeConfig(f"{kind}_32k", S, B, kind), mesh, layout=layout)
        assert meta["flops"] == got > 0, (kind, meta["flops"], got)
        assert meta["collective_bytes"]["fsdp_gather"] == 0
        assert (meta["collective_bytes"]["model"] > 0) == (layout == "tp_only"), meta
        assert meta["rows_per_device"] == (B // 2 if layout == "dp" else B)


@pytest.mark.parametrize("layout", sharding.LAYOUTS)
@pytest.mark.parametrize("mesh", [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}, {"data": 2}],
                         ids=["single", "multi", "data-only"])
def test_layout_specs_equal_jax_dryrun(layout, mesh):
    """``layout_rules`` and ``layout_batch_spec`` are JAX's dry run's
    (``dryrun.py:145-164``), and every leaf's spec under them is JAX's
    ``param_specs``' with the same rules; an all-None rules dict is kept by
    ``spec_for_leaf`` (not replaced by the default)."""
    rules = sharding.layout_rules(layout)
    want_rules = {"dp": {k: None for k in ("layers", "vocab", "embed", "heads", "kv", "ffn", "inner", "experts")},
                  "tp_only": dict(jax_sharding.DEFAULT_RULES, embed=None),
                  "default": dict(jax_sharding.DEFAULT_RULES)}[layout]
    assert rules == want_rules
    fake = _FakeMesh(mesh)
    want_batch = jax.sharding.PartitionSpec(("data", "model")) if layout == "dp" else jax_sharding.batch_spec(fake)
    assert tuple(sharding.layout_batch_spec(layout, mesh)) == tuple(want_batch)
    for arch in ("smollm-135m", "olmoe-1b-7b"):
        spec = ModelSpec(configs.get_config(arch))
        jspecs = dict(_jax_flat(jax_sharding.param_specs(JaxSpec(jax_get_config(arch)).schema(), fake, rules)))
        got = sharding.param_specs(spec.schema(), mesh, rules)
        assert {n: tuple(s) for n, s in got.items()} == {n: tuple(s) for n, s in jspecs.items()}, (arch, layout)
        if layout == "dp":
            assert all(all(e is None for e in s) for s in got.values())
    leaf = next(leaf for _, leaf in flat_leaves(ModelSpec(configs.get_config("smollm-135m")).schema()))
    assert all(e is None for e in sharding.spec_for_leaf(leaf, {"data": 2, "model": 2}, sharding.layout_rules("dp")))
