"""A Mamba2 layer's prefill scan: wrapper of ``csrc/ssd_scan.cu``.

Replaces no Pallas kernel: the JAX package scans in jnp, which eager
PyTorch runs as ~40 launches a layer that write and read each chunk's C x C
fp32 decay tile a head several times over. One launch a layer (after the
within-chunk cumulative sum of the log decay, a few small ops): y = the
chunked SSD + D x and the state at the sequence's end, each head's chunks in
order in one block, in fp32.

CUDA tensors take the kernel, CPU and meta tensors the plain version
(``ref.py``); no path falls back. Shapes, dtypes and contiguity are checked
once per (shapes, strides, dtypes, device) key. ``ssd_scan.launches``
counts its launches.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

_ARGS = [_build.P] * 6 + [_build.I] * 9 + [_build.P]
_TILE = 64  # P, N, and the chunk's multiple


def ssd_scan(xbc, dt, loga, D, *, heads: int, groups: int, state_dim: int, chunk: int):
    """(y (B, S, H x P) fp32, state (B, H, P, N) fp32); see ``ref.py``."""
    if _build.plain(xbc, "ssd_scan"):
        return ssd_scan_ref(xbc, dt, loga, D, heads=heads, groups=groups, state_dim=state_dim, chunk=chunk)
    B, S, ld = xbc.shape
    H, G, N = heads, groups, state_dim
    inner = ld - 2 * G * N
    P = inner // H

    def check():
        if P != _TILE or N != _TILE or chunk % _TILE or H % G or inner != H * P:
            raise ValueError(f"ssd_scan: H={H} P={P} N={N} G={G} chunk={chunk} not supported")
        _build.expect("ssd_scan", xbc.device, ("xbc", xbc, (B, S, ld), torch.bfloat16),
                      ("dt", dt, (B, S, H), torch.float32), ("loga", loga, (B, S, H), torch.float32),
                      ("D", D, (H,), torch.bfloat16))

    _build.validate_once(("ssd_scan", H, G, N, chunk), (xbc, dt, loga, D), check)
    pad = (-S) % chunk
    # the log decay's inclusive cumulative sum within each chunk (padded positions decay nothing)
    cum = F.pad(loga, (0, 0, 0, pad)).view(B, -1, chunk, H).cumsum(dim=2).view(B, S + pad, H)
    y = torch.empty((B, S, inner), dtype=torch.float32, device=xbc.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=xbc.device)
    err = _build.function("repro_ssd_scan", _ARGS)(
        _build.ptr(xbc), _build.ptr(dt), _build.ptr(cum), _build.ptr(D), _build.ptr(y), _build.ptr(state),
        B, S, S + pad, H, G, P, N, ld, chunk, _build.stream(xbc.device),
    )
    _build.check(err, "ssd_scan kernel")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
