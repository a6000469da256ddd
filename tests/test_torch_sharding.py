"""The port's sharding rules (``repro_torch/distributed/sharding.py``), mesh
shapes (``launch/mesh.py``) and shape grid (``configs.py``) against the JAX
package's, as pure functions of a mesh's axis sizes (fake meshes, as
tests/test_substrate.py checks JAX's): every leaf of the 10 full-width
archs on the single- and multi-pod production meshes, the cases of
tests/test_substrate.py, and tables of cases for ``batch_spec``,
``filter_spec_for_mesh`` and the DTensor ``placements``."""
import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import shape_applicable as jax_shape_applicable
from repro.distributed import sharding as jax_sharding
from repro.launch.mesh import dp_size as jax_dp_size
from repro.models.api import ModelSpec as JaxSpec
from repro.models.common import Leaf as JaxLeaf
from repro_torch import configs
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P
from repro_torch.launch import mesh as torch_mesh
from repro_torch.models.api import ModelSpec
from repro_torch.models.common import Leaf

MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}
JP = jax.sharding.PartitionSpec


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


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_equal_jax_for_every_leaf(arch, mesh_kind):
    mesh = _FakeMesh(MESHES[mesh_kind])
    want = dict(_jax_flat(jax_sharding.param_specs(JaxSpec(jax_get_config(arch)).schema(), mesh)))
    got = sharding.param_specs(ModelSpec(configs.get_config(arch)).schema(), mesh)
    assert sorted(got) == sorted(want)
    for name, spec in got.items():
        assert isinstance(spec, P) and tuple(spec) == tuple(want[name]), (name, spec, want[name])
    assert torch_mesh.dp_size(mesh) == jax_dp_size(mesh)


def test_divisibility_fallback_as_in_test_substrate():
    mesh = _FakeMesh({"data": 16, "model": 16})
    assert sharding.spec_for_leaf(Leaf((256, 1024), ("embed", "ffn")), mesh) == P("data", "model")
    assert sharding.spec_for_leaf(Leaf((40, 64), ("heads", None)), mesh) == P(None, None)
    # the same through a plain mapping, and with rules of one's own
    assert sharding.spec_for_leaf(Leaf((40, 64), ("heads", None)), {"data": 8, "model": 8}) == P("model", None)
    rules = dict(sharding.DEFAULT_RULES, embed=None)
    assert sharding.spec_for_leaf(Leaf((256, 1024), ("embed", "ffn")), mesh, rules) == P(None, "model")
    for leaf, jleaf in ((Leaf((256, 1024), ("embed", "ffn")), JaxLeaf((256, 1024), ("embed", "ffn"))),
                        (Leaf((2, 64, 8), ("layers", "embed", None)), JaxLeaf((2, 64, 8), ("layers", "embed", None)))):
        for shape in ({"data": 3, "model": 2}, {"data": 2, "model": 4}, {"model": 4}):
            fake = _FakeMesh(shape)
            assert tuple(sharding.spec_for_leaf(leaf, fake)) == tuple(jax_sharding.spec_for_leaf(jleaf, fake))


@pytest.mark.parametrize("shape", [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}, {"model": 4},
                                   {"data": 3, "model": 2}])
def test_batch_spec_equals_jax(shape):
    assert tuple(sharding.batch_spec(_FakeMesh(shape))) == tuple(jax_sharding.batch_spec(_FakeMesh(shape)))


FILTER_CASES = [  # (spec, mesh shape, tensor shape or None)
    ((None, ("pod", "data"), "model", None, None), {"data": 16, "model": 16}, None),
    ((None, ("pod", "data"), "model", None, None), {"pod": 2, "data": 16, "model": 16}, (28, 128, 32768, 8, 128)),
    ((None, ("pod", "data"), "model", None, None), {"pod": 2, "data": 16, "model": 16}, (28, 1, 524288, 8, 128)),
    ((None, ("pod", "data"), None, None), {"data": 16, "model": 16}, (81, 1, 3, 7296)),
    ((("pod", "data"), None), {"data": 16, "model": 16}, (256, 4096)),
    ((("pod", "data"), None), {"pod": 2, "data": 16, "model": 16}, (16, 4096)),
    (("model", "data"), {"data": 3, "model": 2}, (4, 6)),
    (("model", "data"), {"data": 3, "model": 2}, (3, 6)),
    ((), {"data": 2}, ()),
]


@pytest.mark.parametrize("spec,shape,tshape", FILTER_CASES)
def test_filter_spec_for_mesh_equals_jax(spec, shape, tshape):
    got = sharding.filter_spec_for_mesh(P(*spec), _FakeMesh(shape), tshape)
    assert tuple(got) == tuple(jax_sharding.filter_spec_for_mesh(JP(*spec), _FakeMesh(shape), tshape))


PLACEMENT_CASES = [  # (spec, mesh shape, placements)
    (("data", "model"), {"data": 2, "model": 4}, [Shard(0), Shard(1)]),
    ((None, "model", "data"), {"data": 2, "model": 4}, [Shard(2), Shard(1)]),
    (("model", None, None), {"data": 2, "model": 4}, [Replicate(), Shard(0)]),
    ((None, None), {"data": 2, "model": 4}, [Replicate(), Replicate()]),
    ((), {"data": 1, "model": 1}, [Replicate(), Replicate()]),
    ((("pod", "data"), None), {"pod": 2, "data": 16, "model": 16}, [Shard(0), Shard(0), Replicate()]),
    ((None, ("pod", "data"), "model"), {"pod": 2, "data": 16, "model": 16}, [Shard(1), Shard(1), Shard(2)]),
]


@pytest.mark.parametrize("spec,shape,want", PLACEMENT_CASES)
def test_placements(spec, shape, want):
    assert sharding.placements(P(*spec), shape) == want


@pytest.mark.parametrize("spec,shape", [
    (("data", "data"), {"data": 2, "model": 4}),  # one mesh axis twice, as JAX's PartitionSpec refuses
    (("model", ("data", "model")), {"data": 2, "model": 4}),
    (("expert", None), {"data": 2, "model": 4}),  # not an axis of the mesh
    ((("data", "pod"), None), {"pod": 2, "data": 2, "model": 2}),  # against the mesh's order
])
def test_placements_refuse(spec, shape):
    with pytest.raises(ValueError):
        sharding.placements(P(*spec), shape)


@pytest.mark.parametrize("spec,shape", [
    (("data", "model"), {"data": 2, "model": 4}),
    ((None, "model", "data"), {"data": 2, "model": 4}),
    ((("pod", "data"), None, "model"), {"pod": 2, "data": 3, "model": 2}),
    ((None, None, None), {"data": 3, "model": 2}),
])
def test_shards_tile_the_tensor_once(spec, shape):
    """Every mesh coordinate's slice, by ``shard_slices``, has
    ``local_shape`` and ``local_bytes``; the first replicas
    (``is_first_replica``) tile the whole tensor once."""
    dims = (12, 8, 6)
    t = torch.arange(np.prod(dims)).reshape(dims)
    covered = torch.zeros(dims, dtype=torch.int64)
    names = list(shape)
    for flat in range(int(np.prod(list(shape.values())))):
        coord = dict(zip(names, np.unravel_index(flat, tuple(shape.values()))))
        idx = sharding.shard_slices(dims, P(*spec), shape, coord)
        assert tuple(t[idx].shape) == sharding.local_shape(dims, P(*spec), shape)
        assert sharding.local_bytes(dims, 2, P(*spec), shape) == 2 * t[idx].numel()
        if sharding.is_first_replica(P(*spec), shape, coord):
            covered[idx] += 1
    assert bool((covered == 1).all())


def test_production_meshes_and_dp_size():
    assert torch_mesh.production_mesh_shape() == {"data": 16, "model": 16}
    assert torch_mesh.production_mesh_shape(multi_pod=True) == {"pod": 2, "data": 16, "model": 16}
    for shape in ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}, {"model": 8}):
        assert torch_mesh.dp_size(shape) == jax_dp_size(_FakeMesh(shape))


def test_shape_grid_equals_jax():
    assert list(configs.SHAPES) == list(JAX_SHAPES)
    for name, shape in configs.SHAPES.items():
        assert vars(shape) == vars(JAX_SHAPES[name])
        for arch in configs.ARCH_IDS:
            assert configs.shape_applicable(configs.get_config(arch), shape) == \
                jax_shape_applicable(jax_get_config(arch), JAX_SHAPES[name])
