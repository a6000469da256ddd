"""LR schedule (port of ``repro/optim/schedules.py``): a pure function of
the step, in fp32 as JAX computes it."""
from __future__ import annotations

import math

import torch

from repro_torch.configs import OptimConfig


def cosine_schedule(cfg: OptimConfig, step) -> torch.Tensor:
    """Linear warmup to ``cfg.lr`` over ``warmup_steps``, then a cosine to 0
    at ``total_steps``. ``step`` is an int (or a tensor); returns a 0-d fp32
    tensor on the CPU. At step 0 with ``warmup_steps > 0`` the rate is 0."""
    t = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * t / max(cfg.warmup_steps, 1)
    frac = torch.clamp((t - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * cfg.lr * (1.0 + torch.cos(torch.tensor(math.pi, dtype=torch.float32) * frac))
    return torch.where(t < cfg.warmup_steps, warm, cos)
