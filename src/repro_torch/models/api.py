"""Model API facade (port of ``repro/models/api.py``): one front over the
family modules.

``ModelSpec(cfg)`` provides ``schema`` / ``init`` / ``abstract_params`` /
``param_count``, ``loss`` (next-token cross entropy plus the MoE aux),
``forward`` / ``prefill`` / ``decode_step`` / ``init_cache``, the dry
run's stand-ins (``input_specs``, ``cache_specs``, ``cache_pspec``: meta
tensors and partition specs, no allocation) and ``smoke_batch``. The step
builders (train, prefill, serve) live in ``repro_torch.launch.steps``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.models import common, dense, encdec, mamba2, rwkv6, zamba2
from repro_torch.models.layers import split_model

_FAMILY = {
    "dense": dense,
    "moe": dense,
    "vlm": dense,
    "encdec": encdec,
    "ssm": rwkv6,
    "hybrid": mamba2,
    "zamba2": zamba2,
}


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    cfg: ModelConfig

    @property
    def mod(self):
        if self.cfg.family not in _FAMILY:
            raise ValueError(f"{self.cfg.name}: unknown family {self.cfg.family!r}; known: {sorted(_FAMILY)}")
        return _FAMILY[self.cfg.family]

    # ---- parameters ----
    def schema(self) -> Dict[str, Any]:
        return self.mod.schema(self.cfg)

    def init(self, generator: torch.Generator, device="cuda") -> common.Params:
        return common.init_params(generator, self.schema(), resolve_device(device))

    def abstract_params(self) -> common.Params:
        return common.abstract_params(self.schema())

    def param_count(self) -> int:
        return common.param_count(self.schema())

    # ---- compute ----
    def forward(self, params, tokens, frontend: Optional[torch.Tensor] = None, *, remat: bool = True, **kw):
        return self.mod.forward(self.cfg, params, tokens, frontend, remat=remat, **kw)

    def loss(self, params, batch: Dict[str, torch.Tensor], *, remat: bool = True):
        """Mean next-token cross entropy over ``log_softmax`` of the fp32
        logits, plus the MoE aux. Returns (loss, {"ce", "aux", "loss"}), 0-d
        fp32 tensors. A vlm's logits at positions [nf - 1, nf - 1 + S)
        predict its S text tokens; the start is clamped into the logits as
        ``jax.lax.dynamic_slice_in_dim`` clamps it (without a frontend it is
        0, and each position then scores its own token, as in JAX). In a
        split train step with the logits split over "model" by vocab, the
        cross entropy is vocab-parallel, in fp32 (``ModelParallel
        .cross_entropy``)."""
        cfg, tokens = self.cfg, batch["tokens"]
        logits, aux, _ = self.forward(params, tokens, batch.get("frontend"), remat=remat)
        S = tokens.shape[1]
        if cfg.family == "vlm" and cfg.n_frontend_tokens:
            start = min(max(cfg.n_frontend_tokens - 1, 0), logits.shape[1] - S)
            pred, targets = logits[:, start:start + S], tokens
        else:
            pred, targets = logits[:, :-1], tokens[:, 1:]
        split = dense.logits_split(cfg)
        if split is None:
            logp = torch.log_softmax(pred.float(), dim=-1)
            ce = -torch.mean(logp.gather(-1, targets.long()[..., None])[..., 0])
        else:
            ce = torch.mean(split[0].cross_entropy(pred, targets, split[1]))
        aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
        loss = ce + aux
        return loss, {"ce": ce, "aux": aux, "loss": loss}

    def prefill(self, params, tokens, frontend: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Full-context forward collecting decode state. Returns
        (last_logits (B, V), cache); the cache's ``length`` is the token
        count S, as in JAX. In a split step (``layers.split_compute``) the
        logits are this rank's vocab columns where the vocab is split, and
        the cache holds the rows given and this rank's KV heads."""
        logits, _, collected = self.forward(params, tokens, frontend, remat=False, collect_kv=True,
                                            unembed_last_only=True)
        return logits[:, -1], self._assemble_cache(collected, tokens.shape[1])

    def _assemble_cache(self, collected, S: int) -> Dict[str, Any]:
        """The family's collected state under its cache names (JAX's). In a
        split step with more than one "model" rank the entries the family
        computes by heads (a GQA family's and an encdec's K/V, the shared
        block's K/V, rwkv6's WKV state) hold this rank's heads, and
        ``heads`` maps each to (its heads dim, each rank's [start, stop))
        for ``launch/steps.py::decode_cache`` to gather them."""
        fam = self.cfg.family
        if fam in ("dense", "moe", "vlm"):
            names = ("k", "v")
        elif fam == "encdec":
            names = ("k", "v", "ck", "cv")
        elif fam == "ssm":
            names = ("tm_prev", "cm_prev", "wkv")
        elif fam == "zamba2":  # the sites' K/V, then each layer's conv window and SSM state
            names = ("k", "v", "conv", "ssm")
        else:  # hybrid; the attention caches only with a shared block
            names = ("conv", "ssm", "attn_k", "attn_v")[:len(collected)]
        cache = {**dict(zip(names, collected)), "length": S}
        if split_model() is not None:
            cache["heads"] = self.mod.cache_heads(self.cfg)
        return cache

    def decode_step(self, params, cache, tokens, pos: int):
        return self.mod.decode_step(self.cfg, params, cache, tokens, pos)

    def init_cache(self, batch: int, max_len: int, device="cuda"):
        return self.mod.init_cache(self.cfg, batch, max_len, device=resolve_device(device))

    def cache_specs(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """``init_cache``'s entries on the meta device, ``length`` a 0-d
        int32 (JAX's ``cache_specs``)."""
        cache = self.init_cache(batch, max_len, device="meta")
        return {k: v if isinstance(v, torch.Tensor) else torch.empty((), dtype=torch.int32, device="meta")
                for k, v in cache.items()}

    def cache_pspec(self):
        spec = self.mod.cache_pspec()
        if self.cfg.family == "hybrid" and not self.cfg.shared_attn_every:
            spec = {k: v for k, v in spec.items() if not k.startswith("attn_")}
        return spec

    # ---- input specs (dry-run stand-ins; no allocation) ----
    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """Every input of the step ``shape.kind`` selects, as meta tensors of
        JAX's shapes and dtypes: tokens (B, S) int32 and a vlm's patch or an
        encdec's frame embeddings (train, prefill); tokens (B, 1), pos and
        the cache (decode)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        meta = lambda *dims, dtype=torch.int32: torch.empty(dims, dtype=dtype, device="meta")  # noqa: E731
        if shape.kind in ("train", "prefill"):
            specs: Dict[str, Any] = {"tokens": meta(B, S)}
            if cfg.family == "vlm":
                specs["frontend"] = meta(B, cfg.n_frontend_tokens, cfg.d_model, dtype=torch.bfloat16)
            elif cfg.family == "encdec":
                specs["frontend"] = meta(B, S // 4, cfg.d_model, dtype=torch.bfloat16)
            return specs
        if shape.kind == "decode":
            return {"tokens": meta(B, 1), "pos": meta(), "cache": self.cache_specs(B, S)}
        raise ValueError(shape.kind)

    # ---- smoke-test helper ----
    def smoke_batch(self, generator: torch.Generator, batch: int = 2, seq: int = 32, device="cuda"):
        """Random tokens (B, S) int32 and, for a vlm, patch embeddings
        (B, n_frontend_tokens, d), for an encdec frame embeddings
        (B, max(S // 4, 1), d), both bf16."""
        cfg, dev = self.cfg, resolve_device(device)
        out = {"tokens": torch.randint(0, cfg.vocab, (batch, seq), generator=generator, device=dev,
                                       dtype=torch.int32)}
        n_front = {"vlm": cfg.n_frontend_tokens, "encdec": max(seq // 4, 1)}.get(cfg.family)
        if n_front is not None:
            out["frontend"] = torch.randn((batch, n_front, cfg.d_model), generator=generator,
                                          device=dev).to(torch.bfloat16)
        return out
