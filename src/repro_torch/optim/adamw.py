"""AdamW with fp32 master weights (port of ``repro/optim/adamw.py``).

The state mirrors the flat parameter dict leaf for leaf: fp32 ``mu``,
``nu`` and ``master``, and an int ``step``. Unlike JAX, which returns new
buffers, the update writes the state and the bf16 params IN PLACE, leaf by
leaf, so that a full-width step needs no second copy of the optimizer
state; every term is JAX's, in JAX's order.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs import OptimConfig

Tensors = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: int
    mu: Tensors  # fp32, like params
    nu: Tensors  # fp32, like params
    master: Tensors  # fp32 master copy of params


def adamw_init(params: Tensors) -> AdamWState:
    zeros = lambda: {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}  # noqa: E731
    master = {n: p.detach().to(torch.float32).clone() for n, p in params.items()}
    return AdamWState(0, zeros(), zeros(), master)


def leaf_square_sums(grads: Tensors) -> torch.Tensor:
    """(n_leaves,) fp32: each leaf's sum of squares, leaves in flatten order
    (sorted dotted names: JAX's order of the nested tree)."""
    return torch.stack([torch.sum(torch.square(grads[n].to(torch.float32))) for n in sorted(grads)])


def norm_of_sums(sums: torch.Tensor) -> torch.Tensor:
    """sqrt of the Python sum of the leaves' sums of squares, in order."""
    return torch.sqrt(sum(sums.unbind()))


def global_norm(grads: Tensors) -> torch.Tensor:
    return norm_of_sums(leaf_square_sums(grads))


def adamw_update(
    cfg: OptimConfig, state: AdamWState, grads: Tensors, lr, params: Tensors, gnorm: torch.Tensor,
) -> Tuple[Tensors, AdamWState]:
    """One AdamW step after a clip by the global norm ``gnorm`` (of the
    whole gradient: ``global_norm(grads)``, or the sharded step's norm when
    ``grads`` are shards). Returns (``params``, new state). ``grads`` must
    be fp32 and are CONSUMED (overwritten); mu, nu, master and the bf16
    ``params`` are updated in place."""
    scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip) / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    t = torch.tensor(step, dtype=torch.float32, device=gnorm.device)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=t.device), t)
    lr = torch.as_tensor(lr, dtype=torch.float32).to(t.device)
    with torch.no_grad():
        for n in sorted(grads):
            g, mu, nu, master = grads[n], state.mu[n], state.nu[n], state.master[n]
            if g.dtype != torch.float32:
                raise ValueError(f"adamw_update: grad {n} is {g.dtype}, want float32")
            g.mul_(scale)
            mu.mul_(cfg.b1).add_(g * (1 - cfg.b1))  # b1 mu + (1 - b1) g
            nu.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))  # b2 nu + (1 - b2) g^2
            upd = torch.div(mu, bc1).div_(torch.div(nu, bc2, out=g).sqrt_().add_(cfg.eps))  # mhat / (sqrt(nhat) + eps)
            upd.add_(torch.mul(master, cfg.weight_decay, out=g))  # + wd master
            master.sub_(upd.mul_(lr))  # master - lr (...)
            params[n].copy_(master)
    return params, AdamWState(step, state.mu, state.nu, state.master)
