#!/usr/bin/env python3
"""Two ways to move the rows of a two-tier log compaction, timed on the card.

    PYTHONPATH=src python3 scripts/compact_copy_variants.py      (needs a CUDA card and nvcc)

At chip_smoke.py's phase-3 shapes (28 layers, a full log of 64 slots for 4
requests, 8 dirty pages each resident in the fast pool (96 pages) and in
the host pool (320 pages), rows of 8 x 128 bf16) it times:

  bulk     — the port's kernel (csrc/log_compact.cu, log_compact_tiers): a
             Hopper bulk copy (cp.async.bulk) of each 2 KB row into shared
             memory, completed on an mbarrier, and one bulk store of it per
             pool;
  register — the same resolution of the newest slot of each offset, then
             every thread issues its 16-byte loads of the page's rows before
             its stores, each loaded vector stored to both pools (the
             kernel's first form). Built here from the source below into
             src/repro_torch/_build/variants/ (listed in .gitignore).

Both are called through their C entry points and must leave the pools bit-equal
to the plain version. Prints the mean device time a launch (torch.profiler
kernel spans over 50 launches), in the order register, bulk, bulk,
register, and the bound (the matched rows read once and written twice over
3.35 TB/s).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

REGISTER_SRC = r'''
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int THREADS = 256, UNROLL = 8, MAX_PAGE = 64, MAX_SLOTS = 256;

__global__ void __launch_bounds__(THREADS)
    register_compact(uint4* a_k, uint4* a_v, uint4* b_k, uint4* b_v, const uint4* log_k, const uint4* log_v,
                     const int2* meta, const int* targets, int PA, int PB, int page, int S, int row_vec) {
  __shared__ int2 sm_meta[MAX_SLOTS];
  __shared__ int sm_part[THREADS > MAX_PAGE ? THREADS : MAX_PAGE];
  __shared__ int sm_src[MAX_PAGE];
  const int f = blockIdx.x, l = blockIdx.y, z = blockIdx.z, tid = threadIdx.x;
  const int r = targets[4 * f], logical = targets[4 * f + 1], sa = targets[4 * f + 2], sb = targets[4 * f + 3];
  if (r < 0 || (sa < 0 && sb < 0)) return;
  for (int s = tid; s < S; s += THREADS) sm_meta[s] = meta[s];
  __syncthreads();
  const int parts = page < THREADS ? THREADS / page : 1, per = (S + parts - 1) / parts;
  for (int idx = tid; idx < parts * page; idx += THREADS) {
    const int part = idx / page, o = idx % page, end = min(S, (part + 1) * per);
    int last = -1;
    for (int s = part * per; s < end; ++s) {
      const int2 m = sm_meta[s];
      if (m.x == r && m.y >= 0 && m.y / page == logical && m.y % page == o) last = s;
    }
    sm_part[idx] = last;
  }
  __syncthreads();
  for (int o = tid; o < page; o += THREADS) {
    int last = -1;
    for (int p = 0; p < parts; ++p) last = max(last, sm_part[p * page + o]);
    sm_src[o] = last;
  }
  __syncthreads();
  const uint4* src = (z == 0 ? log_k : log_v) + (size_t)l * S * row_vec;
  uint4* da = sa >= 0 ? (z == 0 ? a_k : a_v) + ((size_t)l * PA + sa) * page * row_vec : nullptr;
  uint4* db = sb >= 0 ? (z == 0 ? b_k : b_v) + ((size_t)l * PB + sb) * page * row_vec : nullptr;
  const int total = page * row_vec;
  for (int base = 0; base < total; base += THREADS * UNROLL) {  // every load of a round before its stores
    uint4 v[UNROLL];
    int at[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS + tid;
      const int s = i < total ? sm_src[i / row_vec] : -1;
      at[u] = s >= 0 ? i : -1;
      if (s >= 0) v[u] = src[(size_t)s * row_vec + i % row_vec];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (at[u] < 0) continue;
      if (da) da[at[u]] = v[u];
      if (db) db[at[u]] = v[u];
    }
  }
}

extern "C" int register_log_compact(void* a_k, void* a_v, void* b_k, void* b_v, const void* log_k, const void* log_v,
                                    const void* meta, const void* targets, int L, int PA, int PB, int page, int S,
                                    int F, int row_bytes, void* stream) {
  if (page > MAX_PAGE || S > MAX_SLOTS || row_bytes % 16) return (int)cudaErrorInvalidValue;
  register_compact<<<dim3(F, L, 2), THREADS, 0, (cudaStream_t)stream>>>(
      (uint4*)a_k, (uint4*)a_v, (uint4*)b_k, (uint4*)b_v, (const uint4*)log_k, (const uint4*)log_v,
      (const int2*)meta, (const int*)targets, PA, PB, page, S, row_bytes / 16);
  return (int)cudaGetLastError();
}
'''


def build_register() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / "register_compact.cu").write_text(REGISTER_SRC)
    lib = out / "libregister_compact.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(out / "register_compact.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    print("\n".join(line for line in res.stdout.splitlines() + res.stderr.splitlines() if "Used" in line))
    so = ctypes.CDLL(str(lib))
    so.register_log_compact.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    so.register_log_compact.restype = ctypes.c_int
    return so


def device_us(fn, iters=50) -> float:
    """Mean device time of the one kernel ``fn`` launches (torch.profiler
    kernel spans, without the host's dispatch)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if len(spans) != iters:
        raise AssertionError(f"the profiler saw {len(spans)} kernels for {iters} launches")
    return sum(spans) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("compact_copy_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.kernels.log_compact.ref import log_compact_tiers_ref

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    L, P, HP, page, KV, hd, S = 28, 96, 320, 16, 8, 128, 64

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    pools = [randn(L, P, page, KV, hd), randn(L, P, page, KV, hd), randn(L, HP, page, KV, hd), randn(L, HP, page, KV, hd)]
    lk, lv = randn(L, S, KV, hd), randn(L, S, KV, hd)
    starts = [405, 218, 333, 470]  # chip_smoke.py's phase-3 log: 16 tokens each
    meta_rows = [[r, starts[r] + i] for i in range(16) for r in range(4)]
    pages = sorted({(r, p // page) for r, p in meta_rows})
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(0)).tolist()
    targets = [[r, lp, perm[j], r * 40 + lp] for j, (r, lp) in enumerate(pages)]
    meta = torch.tensor(meta_rows, dtype=torch.int32, device=dev)
    tgt = torch.tensor(targets, dtype=torch.int32, device=dev)
    from repro_torch.kernels import _build

    stream = torch.cuda.current_stream().cuda_stream
    args = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    entries = {"bulk": _build.function("repro_log_compact", args), "register": build_register().register_log_compact}

    def caller(name):  # through the C entry point, no wrapper in between
        def run(ps):
            err = entries[name](*[t.data_ptr() for t in ps], lk.data_ptr(), lv.data_ptr(), meta.data_ptr(),
                                tgt.data_ptr(), L, P, HP, page, S, len(targets), KV * hd * 2, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        return run

    want = [t.clone() for t in pools]
    log_compact_tiers_ref(*want, lk, lv, meta, tgt)
    variants = {name: caller(name) for name in ("register", "bulk")}
    for name, fn in variants.items():
        got = [t.clone() for t in pools]
        fn(got)
        torch.cuda.synchronize()
        if not all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: pools differ from the plain version")
        del got
    print("both variants bit-equal to the plain version")
    times = {name: [] for name in variants}
    for name in ("register", "bulk", "bulk", "register"):
        times[name].append(device_us(lambda: variants[name](want)))
    moved = L * len(meta_rows) * KV * hd * 2 * 2
    print(f"bound {3 * moved / 3.35e12 * 1e6:.2f} us ({moved * 3 / 1e6:.2f} MB moved)")
    for name, ts in times.items():
        print(f"{name:9s} device us a launch (profiler, 50 launches): " + ", ".join(f"{t:.2f}" for t in ts))
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
