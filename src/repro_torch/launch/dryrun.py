"""Dry run of every (arch x shape x mesh) cell on the meta device (port of
``repro/launch/dryrun.py``).

JAX lowers and compiles each cell for a 256/512-chip mesh and reads XLA's
cost and memory analyses and the partitioned HLO. torch has no HLO (the
HLO walk stays JAX's), so this counts from the layout instead, with no
process group and no data:

  * skipped and the reason (``shape_applicable``), or ok / the error;
  * the mesh and ``n_devices``; a train cell's ``accum_steps`` (JAX's
    loop) and the rows one device computes a microbatch;
  * per-device bytes of params, opt (mu, nu, master, the int32 step) and
    the error-feedback residual by ``param_specs``; of the step's inputs by
    ``batch_spec``, and of a decode cell's cache by ``cache_pspec``, both
    through ``filter_spec_for_mesh``;
  * the bytes the port's step holds beyond its state (every family's
    train, prefill and decode steps split their compute,
    ``launch/steps.py``): ``gathered_params``, the weights gathered at once
    (the largest layer's compute shards, gathered over "data", with the
    whole projections a head route gathers over "model": an attention's
    ``head_route``, or a recurrence whose heads the split cuts; plus the
    compute shards of the embedding, ``lm_head`` and the other leaves
    outside the layers, zamba2's shared block among them; a leaf the data
    axes do not split is computed on a view of its shard and adds
    nothing), and in a train cell ``grad_sum``, the fp32 gradient sum of
    the rank's shards. ``fits``: state + inputs + cache + those within
    ``--device-bytes`` (default 80e9, one NVIDIA H100 80GB HBM3).
    Activations are not counted: a cell that does not fit here does not
    fit at all, one that fits may still not;
  * per-device FLOPs of one step: ``torch.utils.flop_counter.FlopCounterMode``
    over one microbatch of the device's rows on meta (a train cell: loss,
    backward and the remat recompute; the MoE routes over the global
    microbatch as in the sharded step; a split cell with rank 0's local
    shapes, its collectives keeping shapes), times ``accum_steps``; a split
    prefill or decode cell: the sharded step's body on rank 0's rows, local
    shards and cache chunk (``steps.prefill_local`` / ``decode_local``);
  * per-device collective bytes of one step (bytes one rank sends, ring
    algorithms), counted on the meta run of a mesh of more than one
    device. A prefill or decode cell: ``fsdp_gather`` (each weight's
    all-gather over "data") and ``model`` (over "model": the TP
    all-reduces, the vocab-parallel embedding and greedy, EP's combine, the
    projections a head route gathers, Mamba2's states gathered; a decode
    cell also the new token's K/V row and q of every head gathered, and
    decode attention's combine over the sequence-sharded cache). A train
    cell: ``fsdp_gather`` (each weight's all-gather over "data" in the
    forward and the remat recompute), ``grad_reduce`` (each weight's
    gradient summed over the data-parallel ranks in the backward, in bf16,
    as an all-reduce plus the own block; zamba2's shared block once a
    microbatch for all its applications), ``model`` (over "model": the TP
    all-reduces of each block, forward, recompute and backward, the
    vocab-parallel embedding and cross entropy, EP's combine, and the KV or
    whole projections a head route gathers); times ``accum_steps``.

Every count is of one layout profile (``--layout``, or JAX's
``REPRO_LAYOUT`` when the flag is not given; ``sharding.LAYOUTS``): the
params and state by its ``layout_rules``, the inputs and the rows by its
``layout_batch_spec`` ("dp": over ("data", "model"), all of a microbatch
on every device where those do not divide it, as in JAX), a decode cache
by ``layout_cache_pspec`` ("dp": the rank's rows with the sequence whole,
where JAX's dry run places it by ``cache_pspec`` and lets GSPMD reshard);
"dp" splits nothing over "model" and "tp_only" gathers nothing over
"data". The microbatch count is JAX's in every layout (over the data axes).
Every record carries ``"layout"``; "default"'s are written under
``<out>/<mesh_kind>/``, another layout's under ``<out>/<layout>/<mesh_kind>/``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --layout dp   # or REPRO_LAYOUT=dp
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import weakref
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES, OptimConfig, ShapeConfig, get_config, shape_applicable
from repro_torch.distributed.groups import DataParallelWeights, ModelParallel, ShapeOnlyGroup, ShapeOnlyRows
from repro_torch.distributed.sharding import (LAYOUTS, MODEL_AXIS, compute_spec, filter_spec_for_mesh, head_route,
                                              layout_batch_axes, layout_batch_spec, layout_cache_pspec, layout_rules,
                                              local_bytes, local_shape, param_specs, split_dim)
from repro_torch.launch.mesh import dp_size, production_mesh_shape
from repro_torch.launch.steps import (abstract_train_state, build_prefill_step, build_serve_step, build_train_step,
                                      decode_local, prefill_local)
from repro_torch.models import layers
from repro_torch.models.api import ModelSpec
from repro_torch.models.common import flat_leaves

DEVICE_NAME = "NVIDIA H100 80GB HBM3"
DEVICE_BYTES = 80e9


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def accum_steps(cfg, shape, mesh: Mapping[str, int]) -> int:
    """JAX's microbatch count: the config's per-shard microbatch over every
    data-parallel rank, lowered until it splits the batch evenly."""
    mb = cfg.microbatch.get(shape.name, 8)
    dp = dp_size(mesh)
    accum = max(1, shape.global_batch // max(mb * dp, 1))
    while shape.global_batch % accum or (shape.global_batch // accum) % dp:
        accum -= 1
    return accum


def _batch_bytes(t: torch.Tensor, mesh, layout: str = "default") -> int:
    bspec = layout_batch_spec(layout, mesh)
    spec = filter_spec_for_mesh((bspec[0],) + (None,) * (t.dim() - 1), mesh, t.shape)
    return local_bytes(t.shape, t.element_size(), spec, mesh)


def _device_rows(batch: int, mesh, layout: str = "default") -> int:
    """The rows of a ``batch`` one device computes: its share over the
    layout's batch axes, or all of them where those do not divide it."""
    return local_shape((batch,), filter_spec_for_mesh(layout_batch_spec(layout, mesh), mesh, (batch,)), mesh)[0]


class CountingWeights(DataParallelWeights):
    """``DataParallelWeights`` that counts the bytes of gathered weights
    alive at once: each gather over "data" is counted until its result is
    freed, and ``peak`` is the most at any time. A view of the shard (a leaf
    the data axes do not split, or one "data" rank) adds nothing."""

    def __init__(self, *args):
        super().__init__(*args)
        self.alive = self.peak = 0

    def gather(self, w: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        return self._count(super().gather(w, dim), dim)

    def gather_at(self, w: torch.Tensor, dim: Optional[int], anchor: Optional[torch.Tensor]) -> torch.Tensor:
        out = super().gather_at(w, dim, anchor)  # without an anchor, ``gather`` has counted it
        return out if anchor is None else self._count(out, dim)

    def _count(self, out: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        if dim is not None and self.data_size > 1:
            n = out.numel() * out.element_size()
            self.alive += n
            self.peak = max(self.peak, self.alive)
            weakref.finalize(out, self._free, n)
        return out

    def _free(self, n: int) -> None:
        self.alive -= n


def _gathered_whole(cfg, specs, mesh: Mapping[str, int], layout: str = "default"):
    """The leaves rank 0 gathers whole over "model" in a split step (none
    without a "model" axis of more than one rank, or under "dp", which
    splits nothing over it): an attention's head route
    "replicated" (wq, wk, wv, wo and the biases) or "kv_gather" (wk, wv, bk,
    bv), and a recurrence's heads cut by the split (rwkv6's time-mix and
    Mamba2's mixer projections, every head on every rank)."""
    size = mesh.get(MODEL_AXIS, 1)
    if size == 1 or layout == "dp":
        return set()
    split = lambda name: split_dim(compute_spec(specs[name]), MODEL_AXIS) is not None  # noqa: E731
    out = set()

    def attention(leaf: str):
        r = head_route(cfg.n_heads, cfg.n_kv_heads, size, 0, split(f"{leaf}wq"), split(f"{leaf}wk"))
        names = {"replicated": ("wq", "wk", "wv", "wo", "bq", "bk", "bv"),
                 "kv_gather": ("wk", "wv", "bk", "bv")}.get(r.route, ())
        out.update(f"{leaf}{n}" for n in names if f"{leaf}{n}" in specs)

    def recurrence(stack: str, names):
        H = cfg.ssm.heads
        if head_route(H, H, size, 0, split(f"{stack}.{names[0]}"), True).route == "replicated":
            out.update(f"{stack}.{n}" for n in names if split(f"{stack}.{n}"))

    family = cfg.family
    if family in ("dense", "moe", "vlm"):
        attention("blocks.")
    elif family == "encdec":
        for leaf in ("enc.attn_", "dec.attn_", "dec.cross_"):
            attention(leaf)
    elif family == "ssm":
        recurrence("blocks", ("w_r", "w_k", "w_v", "w_g", "w_lora_b", "w_o"))
    else:
        recurrence("mamba", ("w_x", "w_z", "w_out"))
        if cfg.shared_attn_every:
            attention("shared_attn.")
    return out


def split_gathered_bytes(cfg, mesh: Mapping[str, int], layout: str = "default") -> int:
    """The split step's weights gathered at once on a device: the largest
    layer's compute shards (of the stack whose layer is largest: the
    encoder's or the decoder's, say), with the whole projections it gathers
    over "model" (``_gathered_whole``), plus the compute shards of every
    leaf outside the layers (the embedding, ``lm_head``, zamba2's shared
    block, whole where it gathers them). A leaf the data axes do not split
    is computed on a view of its shard: 0 bytes (every leaf under "dp" and
    "tp_only", whose rules split nothing over "data")."""
    spec = ModelSpec(cfg)
    specs = param_specs(spec.schema(), mesh, layout_rules(layout))
    whole = _gathered_whole(cfg, specs, mesh, layout)
    layers_of: Dict[str, int] = {}
    outside = 0
    for name, leaf in flat_leaves(spec.schema()):
        compute = math.prod(local_shape(leaf.shape, compute_spec(specs[name]), mesh)) * 2
        n = compute if compute > local_bytes(leaf.shape, 2, specs[name], mesh) else 0
        stacked = leaf.axes[0] == "layers"
        if name in whole:
            n += math.prod(leaf.shape[1 if stacked else 0:]) * 2 * (leaf.shape[0] if stacked else 1)
        if not stacked:
            outside += n
            continue
        stack = name.split(".", 1)[0]
        layers_of[stack] = layers_of.get(stack, 0) + n // leaf.shape[0]
    return max(layers_of.values(), default=0) + outside


def cache_bytes(spec: ModelSpec, batch: int, max_len: int, mesh: Mapping[str, int], layout: str = "default") -> int:
    """One device's bytes of ``spec.init_cache(batch, max_len)`` under
    ``cache_pspec`` (``layout_cache_pspec``'s for ``layout``) through
    ``filter_spec_for_mesh`` (``length`` a 0-d int32, as JAX's
    ``cache_specs``)."""
    cspec = layout_cache_pspec(layout, spec.cache_pspec())
    return sum(local_bytes(t.shape, t.element_size(), filter_spec_for_mesh(cspec[k], mesh, t.shape), mesh)
               for k, t in spec.cache_specs(batch, max_len).items())


def cell_bytes(arch: str, shape_name: str, mesh: Mapping[str, int], cfg=None,
               layout: str = "default") -> Dict[str, Any]:
    """The byte columns of one cell on the mesh ``{axis: size}`` (no data)
    under ``layout``; ``cfg``: the arch's config cut (its depth, say) in
    place of the full one."""
    cfg, shape = cfg or get_config(arch), SHAPES[shape_name]
    spec = ModelSpec(cfg)
    specs = param_specs(spec.schema(), mesh, layout_rules(layout))
    state = abstract_train_state(spec, compress=True)
    per = lambda leaves: sum(local_bytes(t.shape, t.element_size(), specs[n], mesh) for n, t in leaves.items())  # noqa: E731
    opt = state["opt"]
    rec: Dict[str, Any] = {"params": per(state["params"]), "residual": per(state["residual"])}
    inputs = spec.input_specs(shape)
    cache = inputs.pop("cache", None)
    rec["inputs"] = sum(_batch_bytes(t, mesh, layout) if t.dim() else _nbytes(t) for t in inputs.values())
    extra = {"gathered_params": split_gathered_bytes(cfg, mesh, layout)}
    if shape.kind == "train":
        rec["opt"] = per(opt.mu) + per(opt.nu) + per(opt.master) + _nbytes(opt.step)
        extra["grad_sum"] = per(opt.master)
    else:
        rec["opt"] = 0
    if cache is not None:
        rec["cache"] = cache_bytes(spec, shape.global_batch, shape.seq_len, mesh, layout)
    rec["state"] = rec["params"] + rec["opt"]
    return {"bytes": rec, "port_step_bytes": extra,
            "total_bytes": rec["state"] + rec["inputs"] + rec.get("cache", 0) + sum(extra.values())}


def cell_flops(cfg, shape: ShapeConfig, mesh: Mapping[str, int], device="meta",
               layout: str = "default") -> Dict[str, Any]:
    """Per-device FLOPs of one step of ``cfg`` at ``shape`` under
    ``layout``: one microbatch of the device's rows through the step's
    model work under ``FlopCounterMode``, times the microbatch count.
    ``device``: meta (no data), or a real device, to count the same work
    computed."""
    spec = ModelSpec(cfg)
    dev = torch.device(device)
    if math.prod(mesh.values()) > 1:
        if dev.type != "meta":
            raise ValueError("a split cell is counted on the meta device only")
        return (_split_flops if shape.kind == "train" else _split_serve_flops)(spec, shape, mesh, layout)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(0)
    params = spec.abstract_params() if gen is None else spec.init(gen, device=dev)
    for p in params.values():
        p.requires_grad_(shape.kind == "train")
    inputs = spec.input_specs(shape)

    def rows_of(t: torch.Tensor, rows: int) -> torch.Tensor:
        size = (rows, *t.shape[1:])
        if gen is None:
            return torch.empty(size, dtype=t.dtype, device=dev)
        if t.dtype == torch.int32:
            return torch.randint(0, cfg.vocab, size, generator=gen, dtype=t.dtype, device=dev)
        return torch.randn(size, generator=gen, device=dev).to(t.dtype)

    counter = FlopCounterMode(display=False)
    accum = 1
    if shape.kind == "train":
        accum = accum_steps(cfg, shape, mesh)
        rows = shape.global_batch // accum // dp_size(mesh)
        batch = {k: rows_of(t, rows) for k, t in inputs.items()}
        step = build_train_step(spec, OptimConfig(), accum_steps=1)
        with layers.data_parallel_rows(ShapeOnlyRows(dp_size(mesh)) if dev.type == "meta" else None), counter:
            step.grads_and_loss(params, batch)
    elif shape.kind == "prefill":
        rows = _device_rows(shape.global_batch, mesh)
        batch = {k: rows_of(t, rows) for k, t in inputs.items()}
        with torch.no_grad(), counter:
            build_prefill_step(spec)(params, batch["tokens"], batch.get("frontend"))
    else:
        rows = _device_rows(shape.global_batch, mesh)
        cache = spec.init_cache(rows, shape.seq_len, device=dev)
        with torch.no_grad(), counter:
            build_serve_step(spec)(params, cache, rows_of(inputs["tokens"], rows), shape.seq_len - 1)
    return {"flops": counter.get_total_flops() * accum, "rows_per_device": rows,
            **({"accum_steps": accum} if shape.kind == "train" else {})}


def _meta_split(spec: ModelSpec, mesh: Mapping[str, int], grad: bool, cache=None, layout: str = "default",
                rows: int = 1):
    """Rank 0 of ``mesh`` on the meta device under ``layout``: (its storage
    shards of the params, requiring grad with ``grad``; the ShapeOnlyGroups
    over "data", the ``rows`` ranks the gradient is summed over and
    "model", which count the bytes sent; the ``CountingWeights``; the
    step's ``layers.Split``, with the cache entries' specs ``cache``)."""
    specs = param_specs(spec.schema(), mesh, layout_rules(layout))
    stacked = {n for n, leaf in flat_leaves(spec.schema()) if leaf.axes[0] == "layers"}
    params = {n: torch.empty(local_shape(t.shape, specs[n], mesh), dtype=t.dtype, device="meta").requires_grad_(grad)
              for n, t in spec.abstract_params().items()}
    data, dp_group = ShapeOnlyGroup(mesh.get("data", 1)), ShapeOnlyGroup(rows)
    model = ShapeOnlyGroup(mesh.get(MODEL_AXIS, 1))
    weights = CountingWeights(data, data.size, 0, dp_group, rows)
    tp = ModelParallel(model, model.size, 0) if model.size > 1 and layout != "dp" else None
    split = layers.Split({n: s[1:] if n in stacked else s for n, s in specs.items()}, weights, tp, cache)
    return params, (data, dp_group, model), weights, split


def _split_flops(spec: ModelSpec, shape: ShapeConfig, mesh: Mapping[str, int],
                 layout: str = "default") -> Dict[str, Any]:
    """``cell_flops`` of a split train cell: one microbatch of rank 0's rows
    (under "dp" every row where the batch axes do not divide the
    microbatch, with no gradient sum) through the split step's accumulation
    on meta, its params rank 0's storage shards, its collectives over
    ``ShapeOnlyGroup``s that count the bytes sent; FLOPs and bytes times
    the microbatch count. Also the most weight bytes ``use_weight`` held
    gathered at once."""
    accum = accum_steps(spec.cfg, shape, mesh)
    mb = shape.global_batch // accum
    n = dp_size(mesh, layout_batch_axes(layout, mesh))
    dp = n if mb % n == 0 else 1  # the ranks the rows split over, as the step's ``_Rows`` takes them
    rows = mb // dp
    params, (data, dp_group, model), weights, split = _meta_split(spec, mesh, grad=True, layout=layout, rows=dp)
    batch = {k: torch.empty((rows, *t.shape[1:]), dtype=t.dtype, device="meta")
             for k, t in spec.input_specs(shape).items()}
    counter = FlopCounterMode(display=False)
    step = build_train_step(spec, OptimConfig(), accum_steps=1)
    with layers.data_parallel_rows(ShapeOnlyRows(n) if mb % n == 0 else None), layers.split_compute(split), counter:
        step.grads_and_loss(params, batch)
    return {"flops": counter.get_total_flops() * accum, "rows_per_device": rows, "accum_steps": accum,
            "collective_bytes": {"fsdp_gather": int(data.sent * accum), "grad_reduce": int(dp_group.sent * accum),
                                 "model": int(model.sent * accum)},
            "use_weight_peak_bytes": weights.peak}


def _split_serve_flops(spec: ModelSpec, shape: ShapeConfig, mesh: Mapping[str, int],
                       layout: str = "default") -> Dict[str, Any]:
    """``cell_flops`` of a split prefill or decode cell: the sharded step's
    body (``steps.prefill_local`` / ``decode_local``) on rank 0's rows,
    storage shards and cache chunk on meta, under no grad, its collectives
    over ``ShapeOnlyGroup``s that count the bytes sent. A decode cell's
    cache is ``cache_pspec``'s local shape at the cell's length, and the
    step writes and attends at its last position (the cache by
    ``layout_cache_pspec``). Also the most weight bytes ``use_weight`` held
    gathered at once."""
    inputs = spec.input_specs(shape)
    cache = cache_specs = None
    if shape.kind == "decode":
        cspec = layout_cache_pspec(layout, spec.cache_pspec())
        entries = {k: t for k, t in inputs["cache"].items() if t.dim()}
        cache_specs = {k: filter_spec_for_mesh(cspec[k], mesh, t.shape) for k, t in entries.items()}
        cache = {k: torch.empty(local_shape(t.shape, cache_specs[k], mesh), dtype=t.dtype, device="meta")
                 for k, t in entries.items()}
        cache["length"] = shape.seq_len - 1
    n = dp_size(mesh, layout_batch_axes(layout, mesh))
    params, (data, _, model), weights, split = _meta_split(spec, mesh, grad=False, cache=cache_specs, layout=layout,
                                                           rows=n)
    rows = _device_rows(shape.global_batch, mesh, layout)
    dp_rows = ShapeOnlyRows(n) if rows * n == shape.global_batch else None
    batch = {k: torch.empty((rows, *t.shape[1:]), dtype=t.dtype, device="meta")
             for k, t in inputs.items() if k in ("tokens", "frontend")}
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), layers.data_parallel_rows(dp_rows), layers.split_compute(split), counter:
        if shape.kind == "prefill":
            prefill_local(spec, params, batch["tokens"], batch.get("frontend"), dp_rows)
        else:
            decode_local(spec, params, cache, batch["tokens"], shape.seq_len - 1, dp_rows)
    return {"flops": counter.get_total_flops(), "rows_per_device": rows,
            "collective_bytes": {"fsdp_gather": int(data.sent), "model": int(model.sent)},
            "use_weight_peak_bytes": weights.peak}


def count_cell(arch: str, shape_name: str, mesh_kind: str, device_bytes: float = DEVICE_BYTES,
               layout: str = "default") -> Dict[str, Any]:
    mesh = production_mesh_shape(multi_pod=(mesh_kind == "multi"))
    t0 = time.time()
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "layout": layout, "mesh": mesh,
                           "n_devices": math.prod(mesh.values()), **cell_bytes(arch, shape_name, mesh, layout=layout)}
    rec["device"] = DEVICE_NAME if device_bytes == DEVICE_BYTES else "--device-bytes"
    rec["device_bytes"] = device_bytes
    rec["fits"] = rec["total_bytes"] <= device_bytes
    rec["fits_counts"] = ("state + inputs + cache + gathered params (the largest layer's and the outside "
                          "leaves' gathered weights) + a train cell's fp32 gradient shard; not activations")
    rec.update(cell_flops(get_config(arch), SHAPES[shape_name], mesh, layout=layout))
    rec["count_s"] = round(time.time() - t0, 2)
    return rec


def cell_path(outdir: Path, arch: str, shape_name: str, mesh_kind: str, layout: str = "default") -> Path:
    """Where ``run_cell`` keeps a cell's record: "default"'s under
    ``<outdir>/<mesh_kind>/``, another layout's under
    ``<outdir>/<layout>/<mesh_kind>/`` (a record is never read back for
    another layout)."""
    return (outdir if layout == "default" else outdir / layout) / mesh_kind / f"{arch}__{shape_name}.json"


def run_cell(arch: str, shape_name: str, mesh_kind: str, outdir: Path, force=False,
             device_bytes: float = DEVICE_BYTES, layout: str = "default") -> Dict:
    layout_rules(layout)  # the name's check, before a path is made of it
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    path = cell_path(outdir, arch, shape_name, mesh_kind, layout)
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.exists() and not force:
        return json.loads(path.read_text())
    applicable, why = shape_applicable(cfg, shape)
    if not applicable:
        rec = {"arch": arch, "shape": shape_name, "layout": layout, "mesh_kind": mesh_kind, "skipped": True,
               "reason": why}
        path.write_text(json.dumps(rec, indent=2))
        return rec
    try:
        rec = count_cell(arch, shape_name, mesh_kind, device_bytes, layout)
        rec["ok"] = True
    except Exception as e:  # a failed cell is recorded and the run goes on, as in JAX's dry run
        rec = {"arch": arch, "shape": shape_name, "layout": layout, "ok": False, "error": f"{type(e).__name__}: {e}"}
    rec["mesh_kind"] = mesh_kind
    path.write_text(json.dumps(rec, indent=2))
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--device-bytes", type=float, default=DEVICE_BYTES,
                    help=f"memory of one device (default {DEVICE_BYTES:.0e}: one {DEVICE_NAME})")
    ap.add_argument("--layout", choices=list(LAYOUTS), default=None,
                    help="JAX's layout profile (default: $REPRO_LAYOUT, else default)")
    args = ap.parse_args()
    layout = args.layout or os.environ.get("REPRO_LAYOUT", "default")
    if layout not in LAYOUTS:
        ap.error(f"REPRO_LAYOUT={layout!r}: not one of {LAYOUTS}")
    outdir = Path(args.out)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all, required")
        cells = [(args.arch, args.shape)]

    n_ok = n_fail = n_skip = 0
    for mesh_kind in meshes:
        for a, s in cells:
            t0 = time.time()
            rec = run_cell(a, s, mesh_kind, outdir, force=args.force, device_bytes=args.device_bytes, layout=layout)
            dt = time.time() - t0
            if rec.get("skipped"):
                tag, n_skip = "SKIP", n_skip + 1
            elif rec.get("ok"):
                tag, n_ok = "OK", n_ok + 1
            else:
                tag, n_fail = "FAIL", n_fail + 1
            detail = rec.get("error", "")[:120]
            if rec.get("ok"):
                detail = (f"state/dev {rec['bytes']['state'] / 1e9:.2f} GB, total {rec['total_bytes'] / 1e9:.2f} GB "
                          f"({'fits' if rec['fits'] else 'does not fit'}), {rec['flops'] / 1e12:.1f} TFLOP/dev")
            print(f"[{tag}] {mesh_kind:6s} {a:24s} {s:12s} {dt:6.1f}s {detail}", flush=True)
    print(f"done: ok={n_ok} fail={n_fail} skip={n_skip}")


if __name__ == "__main__":
    main()
