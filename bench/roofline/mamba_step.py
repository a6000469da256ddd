"""Least time of one Mamba2 decode-token launch (``csrc/mamba_step.cu``,
kernel ``mamba_step_kernel``): one layer of one decode step.

Bytes each live row needs, each once: its SSM state (H x P x N fp32) and
conv window ((W - 1) x C in the storage type) read and written, its
in-projection row (z, x B C and dt) read and its output row written (~3.80
MB a row at Zamba2-7B-Instruct's widths). FLOPs: the conv's 2 x W a
channel, the state's 6 a element (decay, input, sum, C.S), the gate and
norm's few an output; bytes bound by far."""
from __future__ import annotations

from typing import Tuple

KERNELS = ("mamba_step_kernel",)


def bytes_flops(model: dict, rows: int, elem: int = 2) -> Tuple[float, float]:
    """``rows``: the live rows of the step."""
    s = model["ssm"]
    H, P, N, G, W = s["heads"], s["head_dim"], s["state_dim"], model["ssm_groups"], s["conv_dim"]
    inner = H * P
    C = inner + 2 * G * N
    state = H * P * N * 4 + (W - 1) * C * elem
    io = (2 * inner + 2 * G * N + H) * elem + inner * elem
    flops = 2 * W * C + 6 * H * P * N + 8 * inner
    return float(rows * (2 * state + io)), float(rows * flops)
