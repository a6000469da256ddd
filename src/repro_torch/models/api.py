"""Model API facade (port of ``repro/models/api.py``) for the dense, moe
and vlm families.

``ModelSpec(cfg)`` provides ``schema`` / ``init`` / ``param_count`` and
``forward`` / ``prefill`` / ``decode_step`` / ``init_cache``. Other families
(encdec, ssm, hybrid) raise ``NotImplementedError`` until their slice of the
port lands; so does training's ``loss``, not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.models import common, dense


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    cfg: ModelConfig

    @property
    def mod(self):
        if self.cfg.family not in dense.FAMILIES:
            raise NotImplementedError(
                f"{self.cfg.name}: family {self.cfg.family!r} is not ported yet "
                "(ROADMAP.md §1 item 7)"
            )
        return dense

    # ---- parameters ----
    def schema(self) -> Dict[str, Any]:
        return self.mod.schema(self.cfg)

    def init(self, generator: torch.Generator, device="cuda") -> common.Params:
        return common.init_params(generator, self.schema(), resolve_device(device))

    def param_count(self) -> int:
        return common.param_count(self.schema())

    # ---- compute ----
    def forward(self, params, tokens, frontend: Optional[torch.Tensor] = None, **kw):
        return self.mod.forward(self.cfg, params, tokens, frontend, **kw)

    def prefill(self, params, tokens, frontend: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Full-context forward collecting decode state. Returns
        (last_logits (B, V), cache with k/v (L, B, Sf + S, KV, hd)); the
        cache's ``length`` is the token count S, as in JAX."""
        logits, _, (k, v) = self.forward(
            params, tokens, frontend, collect_kv=True, unembed_last_only=True
        )
        return logits[:, -1], {"k": k, "v": v, "length": tokens.shape[1]}

    def decode_step(self, params, cache, tokens, pos: int):
        return self.mod.decode_step(self.cfg, params, cache, tokens, pos)

    def init_cache(self, batch: int, max_len: int, device="cuda"):
        return self.mod.init_cache(self.cfg, batch, max_len, device=resolve_device(device))
