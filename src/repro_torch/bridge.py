"""Weight bridge between the JAX package's parameter pytrees and the port's
flat parameter dicts.

The JAX side hands over (and gets back) nested dicts of NUMPY arrays, so
this module never sees JAX. Names map 1:1: the nested key path joined with
dots (``params["blocks"]["wq"]`` <-> ``"blocks.wq"``). bf16 crosses as its
raw 16-bit pattern, so the round trip is bit-exact.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _to_torch(x: np.ndarray) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bf16 dtype; only the bridge back needs it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> flat ``{dotted name: tensor}``."""
    out: Dict[str, torch.Tensor] = {}
    for key, node in tree.items():
        name = f"{prefix}{key}"
        if isinstance(node, dict):
            out.update(params_from_jax(node, name + "."))
        else:
            out[name] = _to_torch(np.asarray(node))
    return out


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Flat ``{dotted name: tensor}`` -> nested dict of numpy arrays."""
    tree: Dict[str, Any] = {}
    for name, t in params.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = _to_numpy(t)
    return tree
