"""The port's dry run (``repro_torch/launch/dryrun.py``) against the JAX
package's layout, on the meta device with no process group:

- every arch x shape x mesh cell, in each layout profile: the skip list
  is JAX's ``shape_applicable``; the per-device bytes of params, opt (mu,
  nu, master and the int32 step), residual, inputs and a decode cell's
  cache equal those computed here from JAX's ``param_specs``,
  ``abstract_train_state``, ``input_specs``, ``batch_spec``, ``cache_pspec``
  and ``filter_spec_for_mesh`` on the same fake mesh, with the rules and
  batch spec JAX's dry run builds for the layout (a "dp" decode cache: see
  ``jax_cell_bytes``);
- ``ModelSpec.input_specs`` / ``cache_specs`` / ``cache_pspec`` equal JAX's;
- the FLOPs counted on meta equal those counted on a real CPU run of the
  same reduced arch and shape;
- a train cell of every family counts the split step: at most one
  gathered layer, the gradient shard, FLOPs that split over "model",
  collectives from the meta run; the four largest archs fit;
- prefill and decode cells count the sharded serving steps: at most one
  gathered layer, the cache by ``cache_pspec``; the 32k cells of the four
  largest fit on 16 x 16 with no rank holding the whole model, and so do
  whisper-base's, rwkv6-3b's and zamba2-7b's train_4k, prefill and decode
  cells; the meta FLOPs of a (1, 2) serve cell equal rank 0's on CPU gloo
  ranks running the sharded steps (``torch_dist_worker.py``);
- the CLI writes one cell's JSON.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import shape_applicable as jax_shape_applicable
from repro.distributed import sharding as jax_sharding
from repro.launch.steps import abstract_train_state as jax_abstract_train_state
from repro.models.api import ModelSpec as JaxSpec
from repro_torch import configs
from repro_torch.configs import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models.api import ModelSpec
from repro_torch.models.common import flat_leaves

ROOT = Path(__file__).resolve().parent.parent
MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}
JP = jax.sharding.PartitionSpec
DTYPES = {torch.bfloat16: "bfloat16", torch.float32: "float32", torch.int32: "int32"}


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _jax_flat(tree, prefix=""):
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, dict):
            yield from _jax_flat(node, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", node


def _local_bytes(sds, spec, mesh) -> int:
    """One device's bytes of ``sds`` under a JAX spec, counted here."""
    n = 1
    for dim, entry in zip(sds.shape, tuple(spec) + (None,) * (len(sds.shape) - len(spec))):
        names = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
        size = math.prod(mesh[a] for a in names)
        assert dim % size == 0
        n *= dim // size
    return n * np.dtype(sds.dtype).itemsize


def jax_layout(layout, fake):
    """(rules, batch spec) as JAX's dry run builds them for ``layout``
    (``repro/launch/dryrun.py:145-164``)."""
    if layout == "dp":
        return {k: None for k in ("layers", "vocab", "embed", "heads", "kv", "ffn", "inner", "experts")}, \
            JP(("data", "model"))
    if layout == "tp_only":
        return dict(jax_sharding.DEFAULT_RULES, embed=None), jax_sharding.batch_spec(fake)
    return None, jax_sharding.batch_spec(fake)


def dp_cache_spec(spec):
    """A JAX ``cache_pspec`` entry as the port's "dp" cache holds it: the
    batch marker ("pod", "data") over "dp"'s batch axes ("data", "model"),
    "model" dropped (the sequence whole), as JAX's ``shard_hint`` resolves
    them under ``REPRO_BATCH_AXES=data,model REPRO_MODEL_HINTS=0``. JAX's
    dry run places the cache by ``cache_pspec`` beside the "dp" batch and
    GSPMD reshards between the two; the port computes on the rows it holds,
    so its cache is compared to this spec instead (ROADMAP.md §3)."""
    def entry(e):
        names = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        if names == ("pod", "data"):
            return ("data", "model")
        return None if "model" in names else e

    return JP(*(entry(e) for e in spec))


def jax_cell_bytes(arch, shape_name, mesh, layout="default"):
    jspec, fake, shape = JaxSpec(jax_get_config(arch)), _FakeMesh(mesh), JAX_SHAPES[shape_name]
    rules, bspec = jax_layout(layout, fake)
    specs = dict(_jax_flat(jax_sharding.param_specs(jspec.schema(), fake, rules)))
    state = jax_abstract_train_state(jspec, compress=True)
    per = lambda tree: sum(_local_bytes(s, specs[n], mesh) for n, s in _jax_flat(tree))  # noqa: E731
    opt = state["opt"]
    out = {"params": per(state["params"]), "residual": per(state["residual"]), "opt": 0}
    if shape.kind == "train":
        out["opt"] = per(opt.mu) + per(opt.nu) + per(opt.master) + np.dtype(opt.step.dtype).itemsize
    inputs = dict(jspec.input_specs(shape))
    cache = inputs.pop("cache", None)
    out["inputs"] = sum(
        _local_bytes(s, jax_sharding.filter_spec_for_mesh(JP(*([bspec[0]] + [None] * (len(s.shape) - 1))), fake,
                                                          s.shape), mesh) if s.shape else np.dtype(s.dtype).itemsize
        for s in inputs.values())
    if cache is not None:
        cspec = {k: dp_cache_spec(v) if layout == "dp" else v for k, v in jspec.cache_pspec().items()}
        out["cache"] = sum(_local_bytes(s, jax_sharding.filter_spec_for_mesh(cspec[k], fake, s.shape), mesh)
                           for k, s in cache.items())
    out["state"] = out["params"] + out["opt"]
    return out


@pytest.mark.parametrize("mesh_kind,layout", [
    pytest.param(kind, layout, id=kind if layout == "default" else f"{kind}-{layout}")
    for layout in ("default", "tp_only", "dp") for kind in MESHES])
def test_every_cell_bytes_and_skips_equal_jax(tmp_path, mesh_kind, layout):
    """Each cell JAX's ``shape_applicable`` skips is written as skipped (a
    non-default layout's under its own directory); every other cell's byte
    columns equal JAX's in ``layout``. "dp" gathers nothing, and "tp_only"
    nothing over "data"."""
    mesh = MESHES[mesh_kind]
    out = tmp_path if layout == "default" else tmp_path / layout
    for arch in configs.ARCH_IDS:
        for shape_name in configs.SHAPES:
            if not configs.shape_applicable(configs.get_config(arch), configs.SHAPES[shape_name])[0]:
                rec = dryrun.run_cell(arch, shape_name, mesh_kind, tmp_path, layout=layout)
                assert rec["skipped"] and rec["reason"] and rec["layout"] == layout, (arch, shape_name)
                assert (out / mesh_kind / f"{arch}__{shape_name}.json").exists()
                continue
            rec = dryrun.cell_bytes(arch, shape_name, mesh, layout=layout)
            assert rec["bytes"] == jax_cell_bytes(arch, shape_name, mesh, layout), (arch, shape_name)
            cfg = configs.get_config(arch)
            whole = ModelSpec(cfg).param_count()
            # every family's split train step and sharded prefill and decode steps: at most
            # one whole layer and the leaves outside the layers gathered; a train cell's fp32
            # gradient sum is the shard's (the residual's bytes)
            outside = sum(math.prod(leaf.shape) for n, leaf in flat_leaves(ModelSpec(cfg).schema())
                          if leaf.axes[0] != "layers")
            one_layer = (whole - outside) // cfg.n_layers
            gathered = rec["port_step_bytes"]["gathered_params"]
            assert gathered <= 2 * (one_layer + outside), (arch, shape_name)
            assert gathered > 0 if layout == "default" else (gathered == 0 or layout == "tp_only"), (arch, shape_name)
            if configs.SHAPES[shape_name].kind == "train":
                assert rec["port_step_bytes"]["grad_sum"] == rec["bytes"]["residual"]
            else:
                assert "grad_sum" not in rec["port_step_bytes"]
    skipped = {(r.stem.split("__")[0], r.stem.split("__")[1]) for r in (out / mesh_kind).glob("*.json")}
    assert skipped == {(a, s) for a in configs.ARCH_IDS for s, shape in JAX_SHAPES.items()
                       if not jax_shape_applicable(jax_get_config(a), shape)[0]}


def test_full_state_bytes_on_one_device():
    """qwen3-1.7b's state on a 1 x 1 mesh: 14 B a parameter (bf16 params,
    fp32 mu, nu, master) plus the step, and 4 more with the residual (what
    chip_smoke.py's phase 8 holds the card's allocation to). The split step
    on 1 x 1 computes on views of the shards (nothing gathered) and sums the
    whole fp32 gradient, its shard; on (1, 2) the gradient sum is half."""
    rec = dryrun.cell_bytes("qwen3-1.7b", "train_4k", {"data": 1, "model": 1})
    n = ModelSpec(configs.get_config("qwen3-1.7b")).param_count()
    assert rec["bytes"]["state"] == 14 * n + 4 and rec["bytes"]["residual"] == 4 * n
    assert rec["port_step_bytes"] == {"gathered_params": 0, "grad_sum": 4 * n}
    half = dryrun.cell_bytes("qwen3-1.7b", "train_4k", {"data": 1, "model": 2})
    assert half["port_step_bytes"]["grad_sum"] == half["bytes"]["residual"] < 4 * n * 0.51


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_input_specs_and_cache_pspec_equal_jax(arch):
    spec, jspec = ModelSpec(configs.get_config(arch)), JaxSpec(jax_get_config(arch))
    assert {k: tuple(v) for k, v in spec.cache_pspec().items()} == {k: tuple(v) for k, v in jspec.cache_pspec().items()}
    for name, shape in configs.SHAPES.items():
        got, want = spec.input_specs(shape), jspec.input_specs(JAX_SHAPES[name])
        got_cache, want_cache = got.pop("cache", {}), dict(want).pop("cache", {})
        want = {k: v for k, v in want.items() if k != "cache"}
        for g, w in [(got, want), (got_cache, want_cache)]:
            assert sorted(g) == sorted(w), (name, sorted(g), sorted(w))
            for k, t in g.items():
                assert t.device.type == "meta" and tuple(t.shape) == tuple(w[k].shape), (name, k)
                assert DTYPES[t.dtype] == np.dtype(w[k].dtype).name, (name, k)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b", "whisper-base", "rwkv6-3b", "zamba2-7b",
                                  "llava-next-34b"])
def test_flops_on_meta_equal_a_cpu_run(arch):
    cfg = configs.get_reduced(arch)
    mesh = {"data": 1, "model": 1}
    for shape in (ShapeConfig("train_4k", 64, 8, "train"), ShapeConfig("prefill_32k", 64, 2, "prefill"),
                  ShapeConfig("decode_32k", 64, 2, "decode")):
        meta = dryrun.cell_flops(cfg, shape, mesh, device="meta")
        cpu = dryrun.cell_flops(cfg, shape, mesh, device="cpu")
        assert meta == cpu and meta["flops"] > 0, (shape.kind, meta, cpu)


# A split cell's FLOPs x the model-axis size against the unsharded step's
# (reduced archs whose heads, KV heads, ffn, experts and vocab divide by
# 2). The split does the same matmuls, but the remat recompute runs each
# row-parallel matmul (wo, w_down) that the unsharded recompute skips: an
# autograd Function saves its inputs when its forward has run, where a
# plain matmul saves them before it runs, and the recompute stops at the
# last saved tensor. Measured: qwen3-1.7b 1.0495, olmoe-1b-7b 1.0086 (its
# experts' matmuls are bmm, as in the unsharded step), llava-next-34b 1.0512.
SPLIT_FLOPS_RTOL = 0.08


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b", "llava-next-34b"])
def test_split_train_cells_count_the_split(arch):
    """Dense, moe and vlm train cells count the split compute: per-device
    FLOPs times the "model" size within SPLIT_FLOPS_RTOL of the unsharded
    step's; the collectives over "data" and "model" counted on the meta run
    (none over "data" on (1, 2)); and at full width on (16, 16) the weights
    ``use_weight`` held gathered at once stay within the cell's
    ``gathered_params``, and the cell fits."""
    cfg = configs.get_reduced(arch)
    shape = ShapeConfig("train_4k", 64, 8, "train")
    whole = dryrun.cell_flops(cfg, shape, {"data": 1, "model": 1})
    split = dryrun.cell_flops(cfg, shape, {"data": 1, "model": 2})
    ratio = split["flops"] * 2 / whole["flops"]
    assert abs(ratio - 1) <= SPLIT_FLOPS_RTOL, ratio
    assert split["collective_bytes"]["model"] > 0
    assert split["collective_bytes"]["fsdp_gather"] == split["collective_bytes"]["grad_reduce"] == 0
    rec = dryrun.count_cell(arch, "train_4k", "single")
    assert 0 < rec["use_weight_peak_bytes"] <= rec["port_step_bytes"]["gathered_params"]
    assert all(v > 0 for v in rec["collective_bytes"].values()) and rec["fits"]


@pytest.mark.parametrize("arch", ["whisper-base", "rwkv6-3b", "zamba2-7b"])
def test_split_family_train_cells_count_the_split(arch):
    """The encdec, rwkv6 and mamba2 families' train cells count their split
    step on meta (reduced archs): per-device FLOPs times the "model" size
    above the unsharded step's, by the compute each rank repeats (the
    replicated branches: rwkv6's ``w_lora_a`` and ``w_cr``, mamba2's
    ``w_B``, ``w_C``, ``w_dt``, the B and C conv channels; the remat
    recompute of the row-parallel matmuls; measured 1.045, 1.146, 1.099),
    within SPLIT_FAMILY_FLOPS_MAX; collectives over "model" on (1, 2), and
    over "data" too on (2, 2)."""
    cfg = configs.get_reduced(arch)
    shape = ShapeConfig("train_4k", 64, 8, "train")
    whole = dryrun.cell_flops(cfg, shape, {"data": 1, "model": 1})
    split = dryrun.cell_flops(cfg, shape, {"data": 1, "model": 2})
    assert 1 < split["flops"] * 2 / whole["flops"] <= SPLIT_FAMILY_FLOPS_MAX
    assert split["collective_bytes"]["model"] > 0
    assert split["collective_bytes"]["fsdp_gather"] == split["collective_bytes"]["grad_reduce"] == 0
    fsdp = dryrun.cell_flops(cfg, shape, {"data": 2, "model": 2})
    assert all(v > 0 for v in fsdp["collective_bytes"].values())


SPLIT_FAMILY_FLOPS_MAX = 1.25
# PR 19's dry run counted these families' train_4k cells by the step that
# gathered the whole model: rwkv6-3b 18.80 GB and zamba2-7b 40.86 GB a device
# on 16 x 16; their split steps hold the layout's shards and one layer
FAMILY_SERVE_ARCHS = ("whisper-base", "rwkv6-3b", "zamba2-7b")


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k"])
def test_the_split_families_fit_on_16x16(shape_name):
    """whisper-base, rwkv6-3b and zamba2-7b on (16, 16) by their split
    steps: every train_4k, prefill and decode cell fits one NVIDIA H100 80GB
    HBM3 (activations not counted), a train_4k cell under 1 GB (the whole
    model's gather was 18.80 and 40.86 GB), and a rank's weights, stored and
    gathered, far below the whole model's (whisper's vocab of 51,865, which
    "model" does not divide, leaves its embedding and ``lm_head`` whole
    over "model": a third of its weights a rank)."""
    mesh = {"data": 16, "model": 16}
    for arch in FAMILY_SERVE_ARCHS:
        rec = dryrun.cell_bytes(arch, shape_name, mesh)
        whole = 2 * ModelSpec(configs.get_config(arch)).param_count()
        held = rec["bytes"]["params"] + rec["port_step_bytes"]["gathered_params"]
        assert rec["total_bytes"] <= dryrun.DEVICE_BYTES, (arch, rec["total_bytes"])
        assert held < whole / (1.2 if arch == "whisper-base" else 20), (arch, held, whole)
        if shape_name == "train_4k":
            assert rec["total_bytes"] < 1e9, (arch, rec["total_bytes"])


def test_the_four_largest_archs_fit_a_card_when_split():
    """train_4k on (16, 16): the split step's state, residual, gradient
    shard and one gathered layer fit one NVIDIA H100 80GB HBM3 (activations
    not counted); the whole-model gather did not (198-742 GB)."""
    for arch in ("qwen2.5-32b", "llava-next-34b", "llama4-scout-17b-a16e", "mistral-large-123b"):
        rec = dryrun.cell_bytes(arch, "train_4k", {"data": 16, "model": 16})
        assert rec["total_bytes"] <= 12e9, (arch, rec["total_bytes"])


SERVE_ARCHS = ("mistral-large-123b", "llama4-scout-17b-a16e", "llava-next-34b", "qwen2.5-32b")


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
def test_the_largest_archs_serve_on_16x16_with_no_rank_holding_the_model(shape_name):
    """The sharded prefill and decode cells on (16, 16): the params' shard,
    one gathered layer, the cache by ``cache_pspec`` and the inputs fit one
    NVIDIA H100 80GB HBM3 (the unsharded steps took the whole bf16 model a
    device: 65-246 GB), and a rank's weights, stored and gathered, are far
    below the whole model's. mistral-large-123b's decode cell also runs on
    meta: ``use_weight`` held no more gathered at once than the count."""
    mesh = {"data": 16, "model": 16}
    for arch in SERVE_ARCHS:
        rec = dryrun.cell_bytes(arch, shape_name, mesh)
        whole = 2 * ModelSpec(configs.get_config(arch)).param_count()
        held = rec["bytes"]["params"] + rec["port_step_bytes"]["gathered_params"]
        assert rec["total_bytes"] <= dryrun.DEVICE_BYTES and held < whole / 20, (arch, rec["total_bytes"], held)
        if shape_name == "decode_32k":  # the cache's sequence split over "model", its batch over "data"
            cfg = configs.get_config(arch)
            kv = 2 * 2 * cfg.n_layers * 128 * 32_768 * cfg.n_kv_heads * cfg.resolved_head_dim  # k and v, bf16
            assert rec["bytes"]["cache"] == kv // 256 + 4, arch  # and the int32 length
    rec = dryrun.count_cell("mistral-large-123b", shape_name, "single")
    assert rec["fits"] and 0 < rec["use_weight_peak_bytes"] <= rec["port_step_bytes"]["gathered_params"]
    assert rec["collective_bytes"]["model"] > 0 and rec["collective_bytes"]["fsdp_gather"] > 0


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b", "llava-next-34b", "whisper-base", "rwkv6-3b",
                                  "zamba2-7b"])
def test_serve_cell_flops_on_meta_equal_the_sharded_steps_on_cpu(tmp_path, arch):
    """A prefill and a decode cell of a reduced arch on (1, 2): the dry
    run's meta count of the sharded step's body on rank 0 equals the FLOPs
    rank 0 computes in the sharded steps on two CPU gloo ranks (the prefill
    of (4, 16) tokens, and one decode step at the cell's last position of a
    cache of its length)."""
    import numpy as np

    from test_torch_distributed import with_frontend
    from torch_dist_worker import bits
    from torch_step_rules import run_ranks

    cfg = configs.get_reduced(arch)
    spec = ModelSpec(cfg)
    B, S, mesh = 4, 16, {"data": 1, "model": 2}
    params = spec.init(torch.Generator().manual_seed(0), device="cpu")
    np.savez(tmp_path / "params.npz", **{n: bits(t) for n, t in params.items()})
    np.save(tmp_path / "tokens.npy", np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(np.int32))
    out = run_ranks(tmp_path, "flops", 2, arch=arch, mesh=list(mesh.values()), axes=list(mesh), serve=True,
                    params=str(tmp_path / "params.npz"), tokens=str(tmp_path / "tokens.npy"), flops=True,
                    **with_frontend(tmp_path, cfg, np.zeros((B, S), np.int32)))
    for kind, got in zip(("prefill", "decode"), out["flops"]):
        meta = dryrun.cell_flops(cfg, ShapeConfig(f"{kind}_32k", S, B, kind), mesh)
        assert meta["flops"] == got > 0, (kind, meta["flops"], got)
        assert meta["collective_bytes"]["model"] > 0 and meta["collective_bytes"]["fsdp_gather"] == 0


def test_cli_writes_a_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "smollm-135m", "--shape",
                          "decode_32k", "--mesh", "multi", "--out", str(tmp_path)], env=env, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert "done: ok=1 fail=0 skip=0" in res.stdout
    rec = json.loads((tmp_path / "multi" / "smollm-135m__decode_32k.json").read_text())
    assert rec["ok"] and rec["mesh_kind"] == "multi" and rec["n_devices"] == 512 and rec["flops"] > 0
    assert rec["device"] == "NVIDIA H100 80GB HBM3" and rec["fits"] is (rec["total_bytes"] <= 80e9) is True
    assert rec["mesh"] == {"pod": 2, "data": 16, "model": 16}
    assert set(rec["bytes"]) == {"params", "opt", "residual", "inputs", "cache", "state"}


def test_cli_layout_flag_and_env(tmp_path):
    """``--layout dp`` writes its record under ``<out>/dp/``, with
    ``"layout"``; ``REPRO_LAYOUT=dp`` without the flag writes the same
    record; the "default" record of the same cell stays where it was and
    is never read back for "dp"."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_LAYOUT", None)
    cell = ["--arch", "smollm-135m", "--shape", "prefill_32k", "--mesh", "single"]
    recs = {}
    for name, extra, extra_env in (("default", [], {}), ("flag", ["--layout", "dp"], {}),
                                   ("env", [], {"REPRO_LAYOUT": "dp"})):
        out = tmp_path / name
        res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *cell, *extra, "--out", str(out)],
                             env=dict(env, **extra_env), capture_output=True, text=True, timeout=240)
        assert res.returncode == 0 and "done: ok=1 fail=0 skip=0" in res.stdout, res.stderr
        sub = out if name == "default" else out / "dp"
        recs[name] = json.loads((sub / "single" / "smollm-135m__prefill_32k.json").read_text())
        recs[name].pop("count_s")
    assert recs["flag"] == recs["env"] and recs["flag"]["layout"] == "dp" and recs["default"]["layout"] == "default"
    assert recs["flag"]["collective_bytes"]["model"] == 0 < recs["default"]["collective_bytes"]["model"]
    # 32 rows: 2 a device over "data", and all 32 under "dp" (256 devices do not divide them: replicated)
    assert recs["flag"]["rows_per_device"] == 32 and recs["default"]["rows_per_device"] == 32 // 16
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *cell], env=dict(env, REPRO_LAYOUT="fsdp"),
                         capture_output=True, text=True, timeout=240)
    assert res.returncode != 0 and "REPRO_LAYOUT" in res.stderr


def test_kernel_wrappers_choose_by_device_type():
    """On meta a wrapper runs its plain version (shapes only); cpu and meta
    take the plain version, cuda the kernel, any other device type raises."""
    from types import SimpleNamespace

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import flash_attention

    q = torch.empty((1, 16, 4, 8), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((1, 16, 2, 8), dtype=torch.bfloat16, device="meta")
    out = flash_attention(q, kv, kv)
    assert out.device.type == "meta" and out.shape == q.shape
    fake = lambda kind: SimpleNamespace(device=SimpleNamespace(type=kind))  # noqa: E731
    assert _build.plain(fake("cpu"), "op") and _build.plain(fake("meta"), "op") and not _build.plain(fake("cuda"), "op")
    with pytest.raises(ValueError):
        _build.plain(fake("xpu"), "op")
