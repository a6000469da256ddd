#!/usr/bin/env python3
"""Does the fused K/V epilogue kernel round exactly as its plain version does?

    PYTHONPATH=src python3 scripts/rmsnorm_order_probe.py      (on a CUDA card)

The kernel (``csrc/kv_log_append.cu``) sums the rmsnorm's squares in the
order it expects torch's CUDA reduction to use for a contiguous row of D
floats. Part 1 holds ``torch.mean(x, -1)`` on the card against four
emulations of that sum in numpy float32 (each add rounded on its own):
each thread adding its elements strided by the block width ("strided") or
as float4 vectors ("vec4"), then the per-thread sums combined by a tree of
adjacent pairs ("asc") or by halving ("desc"). It prints the rows that
differ from torch for each, per row length D and row count M. The kernel
takes "strided-desc" below D = 128 (where it is a halving of the row) and
"vec4-desc" at 128. Part 2 runs the fused op and its plain version over a
sweep of head dims, shapes, biases and qk-norm and prints the largest
distance in bf16 ulps on q and the log rows.
"""
from __future__ import annotations

import itertools
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def last_pow2(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def block_width(D: int, M: int) -> int:
    """Threads across a row (ATen Reduce.cuh set_block_dimension, 512 a block)."""
    d0, d1 = min(last_pow2(D), 512), min(last_pow2(M), 512)
    return min(d0, 512 // min(d1, 512 // min(d0, 32)))


def per_thread(sq: np.ndarray, D: int, bw: int, vec: int) -> np.ndarray:
    """(..., bw) per-thread sums: four accumulators, combined in turn."""
    acc = np.zeros(sq.shape[:-1] + (bw, 4), np.float32)
    for T in range(bw):
        if vec == 1:  # elements T + bw*i; accumulator i
            for n, e in enumerate(range(T, D, bw)):
                acc[..., T, n % 4] += sq[..., e]
        else:  # float4 vectors T + bw*k; accumulator j takes component j
            for base in range(4 * T, D, 4 * bw):
                for j in range(4):
                    acc[..., T, j] += sq[..., base + j]
    v = acc[..., 0]
    for j in range(1, 4):
        v = v + acc[..., j]
    return v


def across_threads(v: np.ndarray, desc: bool) -> np.ndarray:
    while v.shape[-1] > 32:  # shared-memory halving above a warp
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:] if desc else v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def order_probe(dev, reps: int = 200) -> None:
    print("part 1: rows of torch.mean(x*x, -1) on the card that differ from each emulated order")
    for D in (8, 16, 32, 64, 128):
        for M in (4, 8, 12, 24, 32, 64, 128):
            x = torch.randn(reps, M, D, device=dev) * 3
            sq = x * x
            want = torch.stack([torch.mean(sq[r], dim=-1) for r in range(reps)]).cpu().numpy()
            s = sq.cpu().numpy()
            inv = np.float32(1.0) / np.float32(D)
            out = []
            for name, vec in (("strided", 1), ("vec4", 4)):
                v = per_thread(s, D, block_width(D // vec, M), vec)
                for desc in (False, True):
                    got = across_threads(v, desc) * inv
                    out.append(f"{name}-{'desc' if desc else 'asc'} {int((got != want).sum())}")
            print(f"  D={D:3d} M={M:3d} of {want.size}: " + ", ".join(out), flush=True)


def ulp_sweep(dev, reps: int = 40) -> None:
    from repro_torch.configs import ModelConfig
    from repro_torch.kernels.kv_log_append.ops import qkv_log_append
    from repro_torch.kernels.kv_log_append.ref import qkv_log_append_ref
    from repro_torch.models.layers import AttnParams

    def line(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    print("part 2: the fused epilogue against its plain version (bf16 ulps on q and the log rows)")
    worst = 0
    shapes = ((4, 16, 8), (1, 4, 2), (3, 8, 4), (4, 32, 8), (2, 6, 2))
    for hd, (B, H, KV), bias, norm in itertools.product((8, 16, 32, 64, 128), shapes, (0, 1), (0, 1)):
        cfg = ModelConfig(name="probe", family="dense", n_layers=1, d_model=H * hd, n_heads=H, n_kv_heads=KV,
                          d_ff=64, vocab=64, head_dim=hd, rope_theta=1e6, norm_eps=1e-6)
        case_ulps, case_elems = 0, 0
        for rep in range(reps):
            g = torch.Generator(device=dev).manual_seed(rep)

            def r(*shape):
                return (torch.randn(shape, generator=g, device=dev) * 3).to(torch.bfloat16)

            raw = [r(B, 1, n * hd) for n in (H, KV, KV)]
            kw = {}
            if bias:
                kw.update(bq=r(H * hd), bk=r(KV * hd), bv=r(KV * hd))
            if norm:
                kw.update({n: (1 + 0.1 * r(hd).float()).to(torch.bfloat16) for n in ("q_norm", "k_norm")})
            p = AttnParams(wq=None, wk=None, wv=None, wo=None, **kw)
            pos = torch.randint(0, 4000, (B,), generator=g, device=dev, dtype=torch.int32)
            req = torch.arange(B, device=dev, dtype=torch.int32)
            outs = []
            for fn in (qkv_log_append, qkv_log_append_ref):
                lk = torch.zeros(16, KV, hd, device=dev, dtype=torch.bfloat16)
                lv = lk.clone()
                meta = torch.full((16, 2), -1, device=dev, dtype=torch.int32)
                q, _ = fn(cfg, p, *raw, pos, lk, lv, meta, 3, req, pos)
                outs.append((q, lk, lv, meta))
            torch.cuda.synchronize()
            if not torch.equal(outs[0][3], outs[1][3]):
                raise AssertionError("meta rows differ")
            for a, b in zip(outs[0][:3], outs[1][:3]):
                d = (line(a) - line(b)).abs()
                case_ulps, case_elems = max(case_ulps, int(d.max())), case_elems + int((d > 0).sum())
        worst = max(worst, case_ulps)
        if case_elems:
            print(f"  hd={hd} B={B} H={H} KV={KV} bias={bias} qk-norm={norm}: {case_elems} elements differ, "
                  f"up to {case_ulps} ulps")
    print(f"  {5 * len(shapes) * 4} cases x {reps} draws: largest distance {worst} ulps")


def main() -> int:
    if not torch.cuda.is_available():
        print("rmsnorm_order_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} on {torch.cuda.get_device_name(0)}")
    order_probe(dev)
    ulp_sweep(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
