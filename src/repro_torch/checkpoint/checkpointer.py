"""Checkpointing with async save, atomic publish and restore onto a device
(port of ``repro/checkpoint/checkpointer.py``, for torch state).

  * ``save(step, state)``: the state's leaves (tensors and ints, nested in
    dicts and tuples) are copied to the host, then written by a thread as
    ``leaves.npz`` plus ``manifest.json`` (step, n_leaves, dtypes, leaf
    names, extra) into ``.tmp_step_N`` and published by ``os.rename``, so a
    crash mid-save never corrupts the latest checkpoint. ``keep`` bounds how
    many are kept.
  * ``restore(target, step=None, device=None)``: the latest (or the given)
    step in the structure of ``target``, each tensor on ``device`` (default:
    where the target's lies), with its dtype, shape and ``requires_grad``.

Elastic, across meshes (JAX's ``restore(shardings=)``): ``save`` of a
sharded state (DTensor leaves; every rank calls it) gathers each leaf and
writes the WHOLE arrays from global rank 0, in the same layout, so a
sharded checkpoint is an unsharded one. ``restore(..., mesh=, specs=)``
places each leaf named by a parameter of ``specs`` (``param_specs``; the
params, mu, nu, master and residual) on ``mesh`` as a DTensor, this rank's
shard only; the mesh may differ from the one saved on.

The layout is JAX's: leaves in JAX's flatten order (dict keys sorted, tuple
fields in order; a flat dotted-name dict sorts as the nested tree), bf16
stored as a uint16 view with its true dtype in the manifest, the step of an
``AdamWState`` as an int32 scalar. bf16 is restored through an int16 view
(``torch.from_numpy(...).view(torch.bfloat16)``), with no ``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding

State = Any


def _flatten(tree: State, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(name, leaf) pairs in JAX's flatten order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten(tree[key], f"{path}{key}/")
    elif isinstance(tree, tuple):
        for key, node in zip(getattr(tree, "_fields", range(len(tree))), tree):
            yield from _flatten(node, f"{path}{key}/")
    else:
        yield path.rstrip("/"), tree


def _unflatten(target: State, leaves: Iterator[Any]) -> State:
    if isinstance(target, dict):
        built = {key: _unflatten(target[key], leaves) for key in sorted(target)}
        return {key: built[key] for key in target}  # the target's key order
    if isinstance(target, tuple):
        nodes = [_unflatten(node, leaves) for node in target]
        return type(target)(*nodes) if hasattr(target, "_fields") else tuple(nodes)
    return next(leaves)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)  # a copy also on the CPU: the caller may update in place
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    if isinstance(leaf, (bool, np.bool_)) or not isinstance(leaf, (int, np.integer)):
        raise TypeError(f"checkpoint leaves are tensors and ints, not {type(leaf).__name__}")
    return np.asarray(leaf, dtype=np.int32)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return "int32"


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---- save ----
    def save(self, step: int, state: State, extra: Optional[Dict] = None) -> None:
        """Writes ``state``; DTensor leaves are gathered whole (a collective:
        every rank of their mesh calls ``save``), and only global rank 0
        writes."""
        pairs = list(_flatten(state))
        names = [name for name, _ in pairs]
        dtypes = [_dtype_name(leaf) for _, leaf in pairs]
        writer = not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
        host = []
        for _, leaf in pairs:  # copied now, before the caller's next update
            whole = sharding.gather(leaf) if isinstance(leaf, torch.Tensor) else leaf
            host.append(_to_host(whole) if writer else None)
        if not writer:
            return
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(target=self._write_caught, args=(step, host, names, dtypes, extra))
            self._thread.start()
        else:
            self._write(step, host, names, dtypes, extra)

    def _write_caught(self, *args) -> None:
        try:
            self._write(*args)
        except BaseException as e:  # re-raised by wait(), in the caller's thread
            self._error = e

    def _write(self, step, host: List[np.ndarray], names, dtypes, extra) -> None:
        tmp = self.dir / f".tmp_step_{step}"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "leaves.npz", **{f"l{i}": a for i, a in enumerate(host)})
        manifest = {"step": step, "n_leaves": len(host), "dtypes": dtypes, "names": names, "extra": extra or {}}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        for s in sorted(self.all_steps())[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def wait(self) -> None:
        """Wait for an async save; raise its error, if it had one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    # ---- restore ----
    def all_steps(self) -> List[int]:
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*") if (p / "manifest.json").exists()]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, target: State, step: Optional[int] = None, device=None, mesh=None,
                specs: Optional[Dict[str, Any]] = None):
        """Returns (state in ``target``'s structure, extra, step). With
        ``mesh``, each leaf whose name ends in a parameter of ``specs``
        becomes a DTensor on ``mesh`` by its spec, and the other tensors go
        to the mesh's device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "leaves.npz") as z:
            host = [z[f"l{i}"] for i in range(manifest["n_leaves"])]
        pairs = list(_flatten(target))
        if len(pairs) != len(host):
            raise ValueError(f"checkpoint has {len(host)} leaves, target {len(pairs)}")
        leaves = []
        for (name, want), a, dtype in zip(pairs, host, manifest["dtypes"]):
            if not isinstance(want, torch.Tensor):
                leaves.append(int(a))
                continue
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) if dtype == "bfloat16" else torch.from_numpy(a)
            if t.dtype != want.dtype or tuple(t.shape) != tuple(want.shape):
                raise ValueError(f"{name}: checkpoint has {t.dtype} {tuple(t.shape)}, target "
                                 f"{want.dtype} {tuple(want.shape)}")
            param = name.rsplit("/", 1)[-1]
            if mesh is not None and specs is not None and param in specs:
                leaves.append(sharding.distribute(t, mesh, specs[param]))
                continue
            if mesh is not None:
                t = t.to(sharding.mesh_device(mesh))
            else:
                t = t.to(want.device if device is None else device)
            leaves.append(t.requires_grad_(want.requires_grad))
        return _unflatten(target, iter(leaves)), manifest["extra"], step
