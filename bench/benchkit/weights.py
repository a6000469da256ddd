"""Weights drawn from the seed, in the flat dotted layout the program's
``ModelSpec`` takes (``embed``, ``blocks.wq``, ...; per-layer leaves stacked
on a leading layers axis).

The layout is the configuration's family's (``families/<family>.py``:
``layout(model)``), written there from the configuration, not read from the
program, so the yardstick does not move with it; a CPU test holds it equal
to the program's schema. All normal leaves are drawn by ONE ``torch.randn``
into one buffer of the served dtype on the card, then scaled leaf by leaf in
place: a 13.8 GB draw is one call.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# (name, shape, init, scale): init "normal" (N(0, 1) x scale) or "ones"
# (scale unused)
Leaf = Tuple[str, Tuple[int, ...], str, float]


def param_bytes(leaves: List[Leaf], dtype=torch.bfloat16) -> int:
    es = torch.empty((), dtype=dtype).element_size()
    return sum(math.prod(shape) for _, shape, _, _ in leaves) * es


def draw(leaves: List[Leaf], seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The parameters for ``seed``: the normal leaves, in ``leaves``' order,
    from one draw on ``device``; norms one."""
    normal = [(n, s, sc) for n, s, init, sc in leaves if init == "normal"]
    total = sum(math.prod(s) for _, s, _ in normal)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(total, generator=gen, dtype=dtype, device=device)
    params, at = {}, 0
    for name, shape, scale in normal:
        n = math.prod(shape)
        params[name] = buf[at:at + n].view(shape).mul_(scale)
        at += n
    for name, shape, init, _ in leaves:
        if init == "ones":
            params[name] = torch.ones(shape, dtype=dtype, device=device)
    return {name: params[name] for name, _, _, _ in leaves}
