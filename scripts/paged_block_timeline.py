#!/usr/bin/env python3
"""Per-block timeline of the paged-attention page pass on the card.

    python3 scripts/paged_block_timeline.py [--pages-per-split 2 4]

Copies the port's package into src/repro_torch/_build/timeline/ (listed in
.gitignore), inserts a %globaltimer stamp at each stage of
``paged_split_kernel`` (entry, page table read, K landed, scores, softmax and
V landed, p.v), builds that copy and runs it at chip_smoke.py's phase-3
shapes (q (4,16,128) bf16, pool (96,16,8,128), table (4,40), watermarks
400/496/288/0). Prints, per pages-a-split, the start spread of the blocks,
when the last block ends, and the median and p90 of each stage over the
blocks that read pages. The shipped kernels carry no timers; needs a CUDA
card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
COPY = PKG / "_build" / "timeline"
STAGES = ["page table", "K landed", "scores", "softmax + V landed", "p.v"]

# (anchor in paged_attention.cu, text inserted after it)
TIMERS = [
    ("constexpr int PA_MAX_G = 8;  // query heads per KV head\n",
     "__device__ unsigned long long* g_trace = nullptr;\n"
     "#define TR(k) do { if (threadIdx.x == 0 && g_trace) { unsigned long long t_;"
     " asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t_));"
     " g_trace[((size_t)blockIdx.x + gridDim.x * (blockIdx.y + (size_t)gridDim.y * blockIdx.z)) * 8 + (k)] = t_; } } while (0)\n"
     "extern \"C\" int repro_set_trace(void* p) { return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p)); }\n"),
    ("  const int b = blockIdx.x, kv = blockIdx.y, sp = blockIdx.z;\n", "  TR(0);\n"),
    ("    resident = slot >= 0;\n  }\n", "  TR(1);\n"),
    ("  __syncthreads();    // ... for every thread, and ok_s is written\n", "  TR(2);\n"),
    ("  score_rows(k_s, tile, ok_s, q_s, p_s, tile, g, hd, sqrtf((float)hd));\n  __syncthreads();\n", "  TR(3);\n"),
    ("  cp_async_wait<0>();  // V has landed\n  __syncthreads();\n", "  TR(4);\n"),
    ("  weighted_sum(v_s, tile, p_s, tile, g, hd, red, acc + part * g * hd);  // un-normalised p.v\n", "  TR(5);\n"),
]


def instrumented_copy() -> Path:
    if COPY.exists():
        shutil.rmtree(COPY)
    shutil.copytree(PKG, COPY / "repro_torch", ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = COPY / "repro_torch" / "csrc" / "paged_attention.cu"
    text = src.read_text()
    for anchor, timer in TIMERS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in paged_attention.cu: {anchor!r}")
        text = text.replace(anchor, anchor + timer)
    src.write_text(text)
    return COPY


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pages-per-split", type=int, nargs="+", default=[2, 4])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("paged_block_timeline: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(instrumented_copy()))
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention.ops import _paged_attention_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, KV, hd, page, P, N = 4, 16, 8, 128, 16, 96, 40

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, pool_k, pool_v = randn(B, H, hd), randn(P, page, KV, hd), randn(P, page, KV, hd)
    plen = torch.tensor([400, 496, 288, 0], dtype=torch.int32, device=dev)
    perm = torch.randperm(P, generator=gen, device=dev).tolist()
    table = torch.full((B, N), -1, dtype=torch.int32)
    used = 0
    for b in range(3):
        npg = -(-int(plen[b]) // page)
        table[b, :npg] = torch.tensor(perm[used:used + npg])
        used += npg
    table = table.to(dev)
    lib = _build.library()
    print(torch.cuda.get_device_name(0))
    for pps in args.pages_per_split:
        n_blocks = B * KV * -(-N // pps)
        trace = torch.zeros(n_blocks * 8, dtype=torch.int64, device=dev)
        for _ in range(5):  # warm up without timers
            _paged_attention_cuda(q, pool_k, pool_v, table, plen, pages_per_split=pps)
        torch.cuda.synchronize()
        lib.repro_set_trace(ctypes.c_void_p(trace.data_ptr()))
        _paged_attention_cuda(q, pool_k, pool_v, table, plen, pages_per_split=pps)
        torch.cuda.synchronize()
        lib.repro_set_trace(ctypes.c_void_p(0))
        t = trace.view(n_blocks, 8).cpu().numpy().astype(np.float64)
        rel = (t - t[:, 0].min()) / 1e3  # µs from the first block's start
        full = t[:, 5] > 0  # blocks that read pages
        last = np.where(full, rel[:, 5], rel[:, 1]).max()
        print(f"pages a split {pps}: {n_blocks} blocks ({int(full.sum())} read pages); "
              f"starts spread over {rel[:, 0].max():.2f} us; last block ends at {last:.2f} us")
        f = rel[full]
        for k, name in enumerate(STAGES, start=1):
            d = f[:, k] - f[:, k - 1]
            print(f"  {name:20s} median {np.median(d):.2f} us  p90 {np.percentile(d, 90):.2f} us")
        print(f"  {'block':20s} median {np.median(f[:, 5] - f[:, 0]):.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
