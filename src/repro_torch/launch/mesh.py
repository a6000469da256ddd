"""Production mesh construction (port of ``repro/launch/mesh.py``), on
``torch.distributed.device_mesh.init_device_mesh``.

Single pod : (data=16, model=16)            = 256 devices
Multi-pod  : (pod=2, data=16, model=16)     = 512 devices
The "pod" axis carries only data-parallel gradient reduction; "model"
carries TP/EP/sequence-sharded KV.

Functions, not module-level meshes: building one needs the process group
(``torch.distributed.init_process_group``, which the caller starts with its
address, world size and rank). The dry run needs none: it reads the
shapes, as plain data, from ``PRODUCTION_MESHES``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

from repro_torch.distributed.sharding import DATA_AXES, MODEL_AXIS, mesh_coordinate, mesh_shape

# mesh kind -> (shape, axis names)
PRODUCTION_MESHES: Dict[str, Tuple[Tuple[int, ...], Tuple[str, ...]]] = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
}


def production_mesh_shape(multi_pod: bool = False) -> Dict[str, int]:
    """{axis name: size} of the production mesh, with no process group."""
    shape, axes = PRODUCTION_MESHES["multi" if multi_pod else "single"]
    return dict(zip(axes, shape))


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = PRODUCTION_MESHES["multi" if multi_pod else "single"]
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda"):
    """Degenerate 1x1 mesh: the sharded step through the same code on one
    device."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (1, 1), mesh_dim_names=("data", "model"))


def dp_size(mesh, axes: Tuple[str, ...] = DATA_AXES) -> int:
    """The number of ranks along ``axes`` (default: the data-parallel axes,
    as JAX's microbatch count takes it in every layout; a layout's batch
    axes, ``sharding.layout_batch_axes``, give its row count)."""
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in axes if a in shape)


def dp_index(mesh, axes: Tuple[str, ...] = DATA_AXES) -> int:
    """This rank's position among the ranks along ``axes``: its coordinate
    on them, the first major (the order of the batch spec's rows; default
    ("pod", "data"))."""
    shape, coord = mesh_shape(mesh), mesh_coordinate(mesh)
    index = 0
    for a in axes:
        if a in shape:
            index = index * shape[a] + coord[a]
    return index


def dp_group(mesh, axes: Tuple[str, ...] = DATA_AXES):
    """The process group of the ranks along ``axes`` that share this rank's
    other coordinates, its group ranks in ``dp_index`` order (None where
    the mesh has none of ``axes``). ``axes`` follow the mesh's order."""
    axes = tuple(a for a in axes if a in mesh_shape(mesh))
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def model_size(mesh) -> int:
    """The size of the "model" axis (1 where the mesh has none)."""
    return mesh_shape(mesh).get(MODEL_AXIS, 1)


def model_index(mesh) -> int:
    """This rank's coordinate on "model" (0 where the mesh has none)."""
    return mesh_coordinate(mesh)[MODEL_AXIS] if MODEL_AXIS in mesh_shape(mesh) else 0


def model_group(mesh):
    """The process group of the ranks that share this rank's data-parallel
    coordinates, in "model" order (None where the mesh has no "model")."""
    return mesh.get_group(MODEL_AXIS) if MODEL_AXIS in mesh_shape(mesh) else None


def data_group(mesh):
    """The process group along the "data" axis alone (the ranks that share
    this rank's "pod" and "model" coordinates): the axis a weight's FSDP
    shards lie on (None where the mesh has no "data")."""
    return mesh.get_group("data") if "data" in mesh_shape(mesh) else None
