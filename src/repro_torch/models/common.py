"""Parameter schema system: the single source of truth for parameter shapes
and initialization (port of ``repro/models/common.py``).

Every model family defines ``schema(cfg) -> nested dict of Leaf``. The port
keeps parameters as a FLAT dict of tensors keyed by the schema path joined
with dots (``"embed"``, ``"blocks.wq"``, ...). Per-layer parameters stay
STACKED along a leading layers axis, exactly as in the JAX schema, so the
weight bridge (``repro_torch.bridge``) is a 1:1 name map.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

Schema = Dict[str, Any]
Params = Dict[str, torch.Tensor]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # "normal" | "zeros" | "ones"
    scale: Optional[float] = None  # default: 1/sqrt(fan_in)
    dtype: str = "bfloat16"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def stacked(n_layers: int, shape: Tuple[int, ...], axes, **kw) -> Leaf:
    """A per-layer parameter stacked along the leading layers axis."""
    return Leaf((n_layers, *shape), ("layers", *axes), **kw)


def flat_leaves(schema: Schema, prefix: str = "") -> Iterator[Tuple[str, Leaf]]:
    """(dotted name, Leaf) pairs in sorted key order (JAX's flatten order)."""
    for key in sorted(schema):
        node = schema[key]
        name = f"{prefix}{key}"
        if isinstance(node, Leaf):
            yield name, node
        else:
            yield from flat_leaves(node, name + ".")


def param_count(schema: Schema) -> int:
    return int(sum(math.prod(leaf.shape) for _, leaf in flat_leaves(schema)))


def _leaf_init(generator: torch.Generator, leaf: Leaf, device) -> torch.Tensor:
    dtype = _DTYPES[leaf.dtype]
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=dtype, device=device)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=dtype, device=device)
    if leaf.init == "normal":
        # fan_in = first non-layer dim unless 1-D (as the JAX schema)
        dims = [d for d, a in zip(leaf.shape, leaf.axes) if a != "layers"]
        fan_in = dims[0] if len(dims) > 1 else dims[-1]
        scale = leaf.scale if leaf.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        x = torch.randn(leaf.shape, generator=generator, dtype=torch.float32, device=device)
        return (x.mul_(scale)).to(dtype)
    raise ValueError(leaf.init)


def init_params(generator: torch.Generator, schema: Schema, device) -> Params:
    """Random parameters drawn from ``generator`` (which must live on
    ``device``). The numbers differ from ``jax.random`` for the same seed;
    tests that compare the two frameworks move JAX's weights through the
    bridge instead."""
    return {name: _leaf_init(generator, leaf, device) for name, leaf in flat_leaves(schema)}


def abstract_params(schema: Schema) -> Params:
    """The parameters on the meta device: the schema's shapes and dtypes,
    no data (JAX's ``ShapeDtypeStruct`` tree)."""
    return {name: torch.empty(leaf.shape, dtype=_DTYPES[leaf.dtype], device="meta") for name, leaf in flat_leaves(schema)}


def sub_params(params: Params, group: str) -> Params:
    """The parameters under ``<group>.*``, keyed without the prefix."""
    prefix = group + "."
    return {name[len(prefix):]: t for name, t in params.items() if name.startswith(prefix)}


def layer_stack(params: Params, stack: str = "blocks") -> List[Params]:
    """Views of every layer of the stacked ``<stack>.*`` parameters
    (``blocks``; the encoder-decoder's ``enc`` and ``dec``; ``mamba``), from
    ONE ``unbind(0)`` per parameter: under autograd its backward is a single
    ``stack`` of the layers' gradients, where ``t[layer]`` for each layer
    would build a zero-filled gradient of the whole stack per layer."""
    per = {name: t.unbind(0) for name, t in sub_params(params, stack).items()}
    n = len(next(iter(per.values())))
    return [{name: views[i] for name, views in per.items()} for i in range(n)]


def maybe_remat(fn: Callable, enabled: bool, *args):
    """``fn(*args)``; with ``enabled``, while autograd records, its
    activations are dropped and recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant: the port's ``jax.checkpoint``
    of a layer body). The numbers are the same either way."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)
