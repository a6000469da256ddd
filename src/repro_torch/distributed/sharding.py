"""Logical-axis -> mesh-axis sharding rules (port of
``repro/distributed/sharding.py``) and their DTensor placements.

Parameters carry logical axis names in their schema (``models/common.py``).
This module translates them to partition specs for a mesh, with JAX's
divisibility check: a logical rule is dropped (the dim replicated) when the
mesh axis does not divide the dim, which is what makes one rule set work
across all 10 archs.

Default rules (2D: FSDP on "data" x TP/EP on "model"):
    vocab   -> model        embed -> data (FSDP)
    heads   -> model        kv    -> model
    ffn     -> model        inner -> model
    experts -> model (EP)   layers/None -> replicated

The spec functions are pure functions of the mesh's axis sizes: a mesh is a
``DeviceMesh``, anything whose ``.shape`` maps axis names to sizes (a fake
mesh), or such a mapping itself. torch has no PartitionSpec, so
``PartitionSpec`` here is a tuple of one entry per tensor dim: None, an axis
name, or a tuple of axis names (the first one major), as JAX's.

The split train step computes in another layout than it stores:
``compute_spec`` is a leaf's storage spec with the data axes dropped (what
JAX's ``use_weight`` constrains a weight to at its use site), and
``head_route`` gives the head-aligned q and KV heads a rank on the "model"
axis computes, where JAX's flattened split of ``H * hd`` may cut a head.

Layout profiles (JAX's ``REPRO_LAYOUT``, ``repro/launch/dryrun.py``):
"default" is the rules above with the batch over ("pod", "data");
"tp_only" drops FSDP (``embed`` replicated: weights split over "model"
only); "dp" replicates every parameter and spreads the batch over ("data",
"model"), with no "model" split in the compute (JAX's
``REPRO_BATCH_AXES=data,model REPRO_MODEL_HINTS=0``). ``layout_rules``,
``layout_batch_spec`` and ``layout_cache_pspec`` give each profile's.
"""
from __future__ import annotations

import math
import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.models.common import flat_leaves

DATA_AXES = ("pod", "data")  # the data-parallel mesh axes, pod major
MODEL_AXIS = "model"

DEFAULT_RULES: Dict[str, Any] = {
    "layers": None,
    "vocab": "model",
    "embed": "data",
    "heads": "model",
    "kv": "model",
    "ffn": "model",
    "inner": "model",
    "experts": "model",
}


LAYOUTS = ("default", "tp_only", "dp")
_LOGICAL_AXES = ("layers", "vocab", "embed", "heads", "kv", "ffn", "inner", "experts")
_DP_BATCH_AXES = ("data", "model")


def layout_rules(name: str) -> Dict[str, Any]:
    """The logical-axis rules of layout profile ``name`` (JAX's
    ``dryrun.py:147-160``): "dp" maps every logical axis to None,
    "tp_only" is DEFAULT_RULES with ``embed`` None."""
    if name == "dp":
        return {k: None for k in _LOGICAL_AXES}
    if name == "tp_only":
        return dict(DEFAULT_RULES, embed=None)
    if name == "default":
        return dict(DEFAULT_RULES)
    raise ValueError(f"unknown layout {name!r}; one of {LAYOUTS}")


def _entry(entry):
    """JAX's normal form of one entry: a list becomes a tuple, a tuple of
    one axis that axis, an empty tuple None."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else (entry or None)
    return entry


class PartitionSpec(tuple):
    """``PartitionSpec("data", None)``: one entry per tensor dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, a fake mesh or a mapping."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh.shape if hasattr(mesh, "shape") else mesh)


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _axis_size(shape: Mapping[str, int], axis) -> int:
    return math.prod(shape[a] for a in _names(axis))


def spec_for_leaf(leaf, mesh, rules=None) -> PartitionSpec:
    """The spec of one schema leaf: each logical axis by ``rules``; a mesh
    axis the mesh lacks, or one that does not divide the dim, replicates it."""
    rules = rules or DEFAULT_RULES
    shape = mesh_shape(mesh)
    entries = []
    for dim, logical in zip(leaf.shape, leaf.axes):
        mesh_axis = rules.get(logical) if logical is not None else None
        if mesh_axis is not None and (mesh_axis not in shape or dim % _axis_size(shape, mesh_axis) != 0):
            mesh_axis = None  # divisibility fallback: replicate this dim
        entries.append(mesh_axis)
    return P(*entries)


def param_specs(schema, mesh, rules=None) -> Dict[str, PartitionSpec]:
    """{dotted parameter name: spec}, the port's flat layout."""
    return {name: spec_for_leaf(leaf, mesh, rules) for name, leaf in flat_leaves(schema)}


def batch_spec(mesh) -> PartitionSpec:
    """Global batch dim over every data-parallel axis present."""
    shape = mesh_shape(mesh)
    axes = tuple(a for a in ("pod", "data") if a in shape)
    return P(axes if axes else None)


def layout_batch_spec(name: str, mesh) -> "PartitionSpec":
    """The global batch dim's spec under layout profile ``name``:
    ``batch_spec(mesh)``, or ("data", "model") for "dp" (as JAX writes it:
    no "pod", so the pods hold the same rows; ``filter_spec_for_mesh``
    drops an axis the mesh lacks)."""
    layout_rules(name)  # the name's check
    return P(_DP_BATCH_AXES) if name == "dp" else batch_spec(mesh)


def layout_batch_axes(name: str, mesh) -> Tuple[str, ...]:
    """The mesh axes the batch rows split over under ``name``, major
    first: the mesh's among ``layout_batch_spec``'s."""
    sizes = mesh_shape(mesh)
    return tuple(a for a in _names(layout_batch_spec(name, mesh)[0]) if a in sizes)


def layout_cache_pspec(name: str, pspec: Mapping[str, Any]) -> Dict[str, "PartitionSpec"]:
    """A model's ``cache_pspec`` under layout profile ``name``: as it is,
    but for "dp", where the batch marker ("pod", "data") resolves to
    ("data", "model") and a "model" entry to None (JAX's ``shard_hint``
    under ``REPRO_BATCH_AXES=data,model REPRO_MODEL_HINTS=0``): each
    rank's rows, the sequence whole. JAX's dry run instead places the
    cache by ``cache_pspec`` beside the "dp" batch and lets GSPMD reshard."""
    if name != "dp":
        layout_rules(name)
        return dict(pspec)

    def entry(e):
        if _names(e) == DATA_AXES:
            return _DP_BATCH_AXES
        return None if MODEL_AXIS in _names(e) else e

    return {k: P(*(entry(e) for e in spec)) for k, spec in pspec.items()}


def filter_spec_for_mesh(spec, mesh, shape: Optional[Sequence[int]] = None) -> PartitionSpec:
    """Drop axis names a mesh doesn't have (and non-divisible dims if shape
    given) from a spec — lets one spec serve both mesh variants."""
    sizes = mesh_shape(mesh)
    out = []
    for i, entry in enumerate(spec):
        names = tuple(n for n in _names(entry) if n in sizes)
        if shape is not None and names and shape[i] % _axis_size(sizes, names) != 0:
            names = ()
        out.append(names if len(names) > 1 else (names[0] if names else None))
    return P(*out)


def local_shape(shape: Sequence[int], spec, mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` tensor under ``spec``
    (every dim a spec shards is divisible, by construction)."""
    sizes = mesh_shape(mesh)
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, padded):
        n = _axis_size(sizes, entry)
        if dim % n:
            raise ValueError(f"spec {spec} splits a dim of {dim} into {n}")
        out.append(dim // n)
    return tuple(out)


def local_bytes(shape: Sequence[int], itemsize: int, spec, mesh) -> int:
    return math.prod(local_shape(shape, spec, mesh)) * itemsize


def _check(spec, names: Sequence[str]) -> None:
    seen = []
    for entry in spec:
        for a in _names(entry):
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, which the mesh {tuple(names)} lacks")
            if a in seen:
                raise ValueError(f"spec {spec} names mesh axis {a!r} twice")
            seen.append(a)
        order = [names.index(a) for a in _names(entry)]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: the axes of one dim must follow the mesh's order {tuple(names)}")


def placements(spec, mesh) -> List[Any]:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on each mesh
    dim a tensor dim maps to, ``Replicate()`` elsewhere. A tensor dim split
    over several mesh axes (``("pod", "data")``) is split by the first one
    first, as in JAX, which is DTensor's order when the axes follow the
    mesh's. Raises on a mesh axis named twice or not in the mesh."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    _check(spec, names)
    out: List[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for a in _names(entry):
            out[names.index(a)] = Shard(dim)
    return out


def spec_of(t: torch.Tensor) -> PartitionSpec:
    """The spec a DTensor is placed by (``placements`` read back: each tensor
    dim names the mesh axes that shard it, in the mesh's order); a plain
    tensor's is ``P()``, the whole tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return P()
    entries: List[List[str]] = [[] for _ in range(t.dim())]
    for name, placement in zip(t.device_mesh.mesh_dim_names, t.placements):
        if placement.is_shard():
            entries[placement.dim].append(name)
        elif not placement.is_replicate():
            raise ValueError(f"spec_of: placement {placement} is neither a shard nor a replica")
    return P(*entries)


def mesh_coordinate(mesh) -> Dict[str, int]:
    """{axis name: this rank's coordinate} on a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def shard_slices(shape: Sequence[int], spec, mesh, coord: Mapping[str, int]) -> Tuple[slice, ...]:
    """The index of the shard at mesh coordinate ``coord``."""
    sizes = mesh_shape(mesh)
    _check(spec, list(sizes))
    local = local_shape(shape, spec, mesh)
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for n, entry in zip(local, padded):
        block = 0
        for a in _names(entry):  # mixed radix, the first axis major
            block = block * sizes[a] + coord[a]
        out.append(slice(block * n, (block + 1) * n))
    return tuple(out)


def is_first_replica(spec, mesh, coord: Mapping[str, int]) -> bool:
    """Whether the rank at ``coord`` holds the first copy of its shard: its
    coordinate is 0 on every mesh axis ``spec`` does not split. Summing a
    per-shard quantity over the ranks for which this holds counts each
    element of the whole tensor once."""
    used = {a for entry in spec for a in _names(entry)}
    return all(c == 0 for a, c in coord.items() if a not in used)


def mesh_device(mesh) -> torch.device:
    """The device a ``DeviceMesh`` places this rank's shards on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def distribute(t: torch.Tensor, mesh, spec):
    """A DTensor on ``mesh`` holding this rank's shard of the whole tensor
    ``t`` (which every rank holds) by ``spec``: a fresh contiguous copy on
    the mesh's device; ``t`` is left as it was."""
    from torch.distributed.tensor import DTensor

    idx = shard_slices(t.shape, spec, mesh, mesh_coordinate(mesh))
    local = torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype, device=mesh_device(mesh))
    local.copy_(t.detach()[idx])
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False)  # even shards: the shape follows


def shard_params(spec, params: Dict[str, torch.Tensor], mesh, rules=None) -> Dict[str, Any]:
    """The params alone on ``mesh`` (a served model has no optimizer state;
    ``launch/steps.py::shard_train_state`` places its leaves named as the
    params through it): DTensors placed by ``param_specs(spec.schema(),
    mesh, rules)``, each rank's shard a fresh copy on the mesh's device
    (``params`` is left as it was). The steps read each
    leaf's layout from its placements, so ``rules`` may be other rules than
    the default: JAX's "tp_only" serving layout is ``dict(DEFAULT_RULES,
    embed=None)`` (no FSDP: the weights split over "model" only)."""
    specs = param_specs(spec.schema(), mesh, rules)
    return {n: distribute(t, mesh, specs[n]) for n, t in params.items()}


def cache_layout(spec, shape: Sequence[int], mesh) -> Tuple[PartitionSpec, Tuple[slice, ...]]:
    """A cache entry of global ``shape`` under its ``cache_pspec`` entry
    ``spec``: (the spec through ``filter_spec_for_mesh``, which replicates a
    dim the mesh axis does not divide; this rank's slices of the whole)."""
    spec = filter_spec_for_mesh(spec, mesh, shape)
    return spec, shard_slices(shape, spec, mesh, mesh_coordinate(mesh))


def gather(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (a collective over its mesh), as a plain
    tensor; a plain tensor as it is. With gloo on CUDA tensors (ranks
    sharing one card), where torch's ``full_tensor`` kills the process
    (SIGSEGV on torch 2.11.0+cu128, ``scripts/gloo_cuda_probe.py``), each
    shard's first replica writes it into a zero tensor that is summed over
    every process (the mesh must span them all): exact."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    if not (t.to_local().is_cuda and dist.get_backend() == "gloo"):
        return t.full_tensor()
    mesh = t.device_mesh
    if mesh.size() != dist.get_world_size():
        raise ValueError("gather: a mesh over gloo on CUDA must span every process")
    spec, sizes, coord = spec_of(t), mesh_shape(mesh), mesh_coordinate(mesh)
    whole = torch.zeros(t.shape, dtype=t.dtype, device=t.to_local().device)
    if is_first_replica(spec, sizes, coord):
        whole[shard_slices(t.shape, spec, sizes, coord)] = t.to_local()
    dist.all_reduce(whole)
    return whole


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (its storage, not a copy); a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def compute_spec(spec) -> PartitionSpec:
    """JAX's ``use_weight`` target: ``spec`` with the data axes dropped, so
    that the weight is split over "model" only."""
    return P(*[tuple(a for a in _names(e) if a not in DATA_AXES) for e in spec])


def split_dim(spec, axis: str) -> Optional[int]:
    """The tensor dim ``spec`` splits over mesh axis ``axis``, or None."""
    for dim, entry in enumerate(spec):
        if axis in _names(entry):
            return dim
    return None


@dataclasses.dataclass(frozen=True)
class HeadRoute:
    """The heads one rank on the "model" axis computes attention for.

    ``route``: "local" (its q heads and their KV heads are its shards of
    ``wq`` and ``wk``/``wv``), "kv_gather" (its q heads are its shard; the
    KV heads they read are cut by the split or not split at all, so ``wk``
    and ``wv`` are gathered over "model" and the heads ``kv`` taken) or
    "replicated" (the q heads do not divide over "model": every rank
    computes every head). ``q`` and ``kv``: [start, stop) head ranges.
    ``kv_of_q``: for each local q head, its KV head's index in the ``kv``
    range, where the local heads do not form whole GQA groups (None where
    the flash kernel's own mapping, q head h reads KV head h // group,
    holds)."""

    route: str
    q: Tuple[int, int]
    kv: Tuple[int, int]
    kv_of_q: Optional[Tuple[int, ...]] = None


def head_route(n_heads: int, n_kv_heads: int, size: int, index: int, q_split: bool, kv_split: bool) -> HeadRoute:
    """The heads of rank ``index`` of ``size`` on "model". ``q_split`` /
    ``kv_split``: whether ``wq``'s / ``wk``'s compute spec splits its heads
    dim over "model" (JAX's divisibility rule splits ``H * hd``, which may
    cut a head: then the q heads take the replicated route, and the KV
    heads are gathered)."""
    if not q_split or n_heads % size:
        return HeadRoute("replicated", (0, n_heads), (0, n_kv_heads))
    group = n_heads // n_kv_heads
    per = n_heads // size
    q0, q1 = index * per, (index + 1) * per
    kv = (q0 // group, (q1 - 1) // group + 1)
    route = "local" if kv_split and n_kv_heads % size == 0 else "kv_gather"
    uniform = (per % group == 0 and q0 % group == 0) or group % per == 0
    kv_of_q = None if uniform else tuple(h // group - kv[0] for h in range(q0, q1))
    return HeadRoute(route, (q0, q1), kv, kv_of_q)
