"""Weight bridge between the JAX package's parameter pytrees and the port's
flat parameter dicts.

The JAX side hands over (and gets back) nested dicts of NUMPY arrays, so
this module never sees JAX. Names map 1:1: the nested key path joined with
dots (``params["blocks"]["wq"]`` <-> ``"blocks.wq"``). bf16 crosses as its
raw 16-bit pattern, so the round trip is bit-exact. A train state crosses
too (``train_state_from_jax`` / ``train_state_to_jax``): params, the AdamW
state (step, mu, nu, master) and the error-feedback residual.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWState


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


def train_state_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX train state as numpy (``{"params", "opt": AdamWState, and
    optionally "residual"}``; ``opt`` may be any object with ``step``,
    ``mu``, ``nu`` and ``master``, or a dict of them) -> the port's, on the
    CPU, params requiring grad."""
    opt = tree["opt"]
    get = opt.get if isinstance(opt, dict) else (lambda name: getattr(opt, name))
    params = {n: t.requires_grad_(True) for n, t in params_from_jax(tree["params"]).items()}
    state = {"params": params, "opt": AdamWState(int(np.asarray(get("step"))), params_from_jax(get("mu")),
                                                 params_from_jax(get("nu")), params_from_jax(get("master")))}
    if "residual" in tree:
        state["residual"] = params_from_jax(tree["residual"])
    return state


def train_state_to_jax(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's train state -> numpy, ``opt`` as a dict of AdamWState's
    fields (``AdamWState(**opt)`` on the JAX side; the step an int32
    scalar)."""
    opt = state["opt"]
    tree = {"params": params_to_jax(state["params"]),
            "opt": {"step": np.asarray(opt.step, dtype=np.int32), "mu": params_to_jax(opt.mu),
                    "nu": params_to_jax(opt.nu), "master": params_to_jax(opt.master)}}
    if "residual" in state:
        tree["residual"] = params_to_jax(state["residual"])
    return tree
