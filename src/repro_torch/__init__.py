"""PyTorch + CUDA port of the JAX package ``repro``'s model stack: the
SkyByte tiered-KV serving engine, every model family's prefill and decode,
and the training path (loss, AdamW, int8 error feedback, the train step,
data pipeline, checkpointer and ``launch.train``).

Mirrors the module layout of the JAX package (the reference it is tested
against) but imports nothing of it. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; on the CPU every hand-written
CUDA kernel is replaced by its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device that is not there
    (no silent switch to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels"
        )
    return dev
