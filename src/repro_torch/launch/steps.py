"""Step builders (port of ``repro/launch/steps.py``): the train step, and
greedy prefill and decode steps over a ``ModelSpec``, for every family.

The prefill and decode steps are how the encoder-decoder, RWKV6 and
Mamba2/Zamba2 families are served (the tiered engine serves the GQA decoder
families only, as in JAX). The train step is ``python -m
repro_torch.launch.train``'s; the dry run's ``abstract_train_state`` is not
ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs import OptimConfig
from repro_torch.models.api import ModelSpec
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.grad_compress import error_feedback_leaf
from repro_torch.optim.schedules import cosine_schedule

Tensors = Dict[str, torch.Tensor]


def make_train_state(spec: ModelSpec, generator: torch.Generator, compress: bool = False, device="cuda"):
    """{"params": bf16 params (requiring grad), "opt": AdamWState, and with
    ``compress`` "residual": fp32 zeros like the params}."""
    params = spec.init(generator, device=device)
    for p in params.values():
        p.requires_grad_(True)
    state = {"params": params, "opt": adamw_init(params)}
    if compress:
        state["residual"] = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}
    return state


def build_train_step(spec: ModelSpec, optim: OptimConfig, accum_steps: int = 1) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics), updating the
    state IN PLACE (JAX returns a new one). The global batch is split into
    ``accum_steps`` microbatches of consecutive rows (JAX's reshape); each
    runs ``loss.backward()`` into the params' bf16 ``.grad``, which is added
    to an fp32 sum and cleared (JAX's ``g_acc + g.astype(f32)``). The sum
    over ``accum_steps``, through error feedback with ``compress_grads``,
    goes to AdamW at the rate ``cosine_schedule`` gives for the step BEFORE
    the increment (JAX's order: with ``warmup_steps > 0`` the first update
    has rate 0). Metrics: loss, grad_norm (before the clip), lr, step.
    ``train_step.grads_and_loss(params, batch)`` is the accumulation alone."""

    def grads_and_loss(params: Tensors, batch: Dict[str, torch.Tensor]) -> Tuple[Tensors, torch.Tensor]:
        B = batch["tokens"].shape[0]
        if B % accum_steps:
            raise ValueError(f"global batch {B} does not split into {accum_steps} microbatches")
        mb = B // accum_steps
        g_sum = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        for i in range(accum_steps):
            loss, metrics = spec.loss(params, {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()})
            loss.backward()
            for n, p in params.items():
                if p.grad is not None:  # a leaf the loss does not reach has grad 0, as in JAX
                    g_sum[n].add_(p.grad)
                    p.grad = None
            loss_sum = loss_sum + metrics["loss"].detach()
        for g in g_sum.values():
            g.div_(accum_steps)
        return g_sum, loss_sum / accum_steps

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        grads, loss = grads_and_loss(params, batch)
        if optim.compress_grads:
            for n in sorted(grads):  # leaf by leaf: each fp32 sum is freed as its compressed grad replaces it
                grads[n] = error_feedback_leaf(grads[n], state["residual"][n])
        lr = cosine_schedule(optim, state["opt"].step)
        _, state["opt"], gnorm = adamw_update(optim, state["opt"], grads, lr, params)
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr, "step": state["opt"].step}

    train_step.grads_and_loss = grads_and_loss
    return train_step


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
