"""Hand-written CUDA kernels of the tiered-KV serving path, one package each.

Each package has:
  ops.py — the wrapper: launches the CUDA kernel(s) (``csrc/<name>.cu``) for
           CUDA tensors, raising on any build, shape or launch error; takes
           the plain version only for CPU tensors. Its launch count is the
           integer ``<wrapper>.launches``.
  ref.py — the plain PyTorch version (port of the JAX ``ref.py`` oracle):
           what the CPU and the tests run, and what the card compares with.

Kernels (each replaces one Pallas TPU kernel of ``repro.kernels``):
  paged_attention — decode attention over the fast page pool and the write
                    log (read path): a page pass split over pages, then the
                    log pass fused into the combine; two launches a call
  kv_log_append   — token append into the KV write-log ring (write path);
                    on the decode path it also does the K/V epilogue (bias,
                    qk-norm, RoPE) of the q/k/v projections: one launch a
                    layer (``qkv_log_append``)
  log_compact     — newest-wins coalescing of log tokens into pages, both
                    tiers in one launch (``log_compact_tiers``)
  flash_attention — tiled causal attention for prefill: wgmma tensor-core
                    route for bf16, CUDA-core route for fp32
  moe_routing     — replaces no Pallas kernel: the capacity MoE's routing,
                    slots, dispatch, SwiGLU epilogue and combine around the
                    expert GEMMs, five launches a ``moe_ffn`` call; where
                    autograd records a graph, a plain-op backward
  mamba_step      — replaces no Pallas kernel: one decode token of a Mamba2
                    layer (conv, decay, state update, C.S + D x, gate, group
                    norm) over per-request state slots, in place; one launch
                    a layer
  ssd_scan        — replaces no Pallas kernel: a Mamba2 layer's prefill scan
                    (the chunked SSD from a zero state, and D x), one launch
                    a layer
"""
from __future__ import annotations

from typing import Dict


def _wrappers():
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.kv_log_append.ops import kv_log_append
    from repro_torch.kernels.log_compact.ops import log_compact
    from repro_torch.kernels.mamba_step.ops import mamba_step, rms_norm_rows
    from repro_torch.kernels.moe_routing import ops as moe_routing
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    return {
        "paged_attention": paged_decode_attention,
        "log_compact": log_compact,
        "kv_log_append": kv_log_append,
        "flash_attention": flash_attention,
        "moe_routing": moe_routing.counts,
        "mamba_step": mamba_step,
        "rms_norm_rows": rms_norm_rows,
        "ssd_scan": ssd_scan,
    }


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name (paged attention: calls of the
    op, two launches each; kv_log_append and log_compact: launches of either
    entry point; moe_routing: launches of its five kernels; mamba_step: its
    launches, one a Mamba layer a decode step; rms_norm_rows: its launches,
    the "zamba2" decode step's norms; ssd_scan: its launches, one a Mamba
    layer a "zamba2" prefill)."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def route_counts() -> Dict[str, int]:
    """Flash attention's launches by route (``tensor_core``, ``cuda_core``)."""
    return dict(_wrappers()["flash_attention"].route_launches)


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
    routes = _wrappers()["flash_attention"].route_launches
    for route in routes:
        routes[route] = 0
