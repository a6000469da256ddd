"""Step builders (port of ``repro/launch/steps.py``): greedy prefill and
decode steps over a ``ModelSpec``, for every family.

These are how the encoder-decoder, RWKV6 and Mamba2/Zamba2 families are
served (the tiered engine serves the GQA decoder families only, as in JAX).
``build_train_step`` comes with the training slice (ROADMAP.md §1 item 8).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.models.api import ModelSpec


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) -> (B, 1) int32: the first index of each row's maximum."""
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def decode_cache(spec: ModelSpec, prefill_cache: Dict[str, Any], batch: int, max_len: int, device="cuda"):
    """``spec.init_cache(batch, max_len)`` holding ``prefill_cache`` in the
    leading slice of each entry, zeros after it (how JAX's
    ``tests/test_system.py::test_prefill_decode`` hands a prefill to
    decode; an encdec's cross rows beyond the frames stay zero and are
    attended, as in JAX). Entries keep the prefill's dtypes, so an fp32
    prefill gives an fp32 cache."""
    dc = spec.init_cache(batch, max_len, device=device)
    for key, v in prefill_cache.items():
        if key != "length":
            dc[key] = dc[key].to(v.dtype)
            dc[key][tuple(slice(0, n) for n in v.shape)] = v
    return dc


def build_prefill_step(spec: ModelSpec) -> Callable:
    """prefill_step(params, tokens, frontend=None) -> (next token (B, 1)
    int32, cache)."""

    def prefill_step(params, tokens, frontend=None):
        logits, cache = spec.prefill(params, tokens, frontend)
        return _greedy(logits), cache

    return prefill_step


def build_serve_step(spec: ModelSpec) -> Callable:
    """serve_step(params, cache, tokens (B, 1), pos) -> (next token (B, 1)
    int32, cache): one greedy decode step against the KV/state cache."""

    def serve_step(params, cache, tokens, pos: int):
        logits, cache = spec.decode_step(params, cache, tokens, pos)
        return _greedy(logits), cache

    return serve_step
