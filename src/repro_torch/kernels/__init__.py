"""Hand-written CUDA kernels of the tiered-KV serving path, one package each.

Each package has:
  ops.py — the wrapper: launches the CUDA kernel (``csrc/<name>.cu``) for
           CUDA tensors, raising on any build, shape or launch error; takes
           the plain version only for CPU tensors. Its launch count is the
           integer ``<wrapper>.launches``.
  ref.py — the plain PyTorch version (port of the JAX ``ref.py`` oracle):
           what the CPU and the tests run, and what the card compares with.

Kernels (each replaces one Pallas TPU kernel of ``repro.kernels``):
  paged_attention — decode attention over the fast page pool (read path)
  kv_log_append   — token append into the KV write-log ring (write path)
  log_compact     — newest-wins coalescing of log tokens into pages
  flash_attention — tiled causal attention for prefill
"""
from __future__ import annotations

from typing import Dict


def _wrappers():
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.kv_log_append.ops import kv_log_append
    from repro_torch.kernels.log_compact.ops import log_compact
    from repro_torch.kernels.paged_attention.ops import paged_attention_pages

    return {
        "paged_attention": paged_attention_pages,
        "log_compact": log_compact,
        "kv_log_append": kv_log_append,
        "flash_attention": flash_attention,
    }


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
