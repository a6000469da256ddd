// Write-log compaction: coalesce log tokens into whole pages.
//
// Replaces src/repro/kernels/log_compact/kernel.py::log_compact_pallas
// (pallas_call at kernel.py:86, body _kernel at :22, scatter at :109-118).
//
// For each flush target (request r, logical page p, pool slot s) and each
// layer: every log slot whose (owner, pos // page) is (r, p) overwrites the
// page row at pos % page; later slots win. Targets with r < 0 or s < 0
// write nothing. Bound: bytes — it moves only the matched log rows (reads
// and writes each once). Design: one block per (target, layer). Each of the
// first `page` threads owns one in-page offset and scans the (small) meta
// table for the LAST matching slot, so "later slot wins" needs no atomics;
// then the block copies the winning rows with 16-byte loads, in place.
// Precondition (engine-guaranteed, as in the JAX oracle): target slots are
// distinct, so no two blocks write the same page. Pure copies: bit-exact.
#include "common.cuh"

constexpr int LC_MAX_PAGE = 1024;

__global__ void log_compact_kernel(uint4* __restrict__ k_pages, uint4* __restrict__ v_pages,
                                   const uint4* __restrict__ log_k, const uint4* __restrict__ log_v,
                                   const int* __restrict__ meta, const int* __restrict__ targets,
                                   int P, int page, int S, int row_vec) {
  __shared__ int src[LC_MAX_PAGE];
  const int f = blockIdx.x, l = blockIdx.y;
  const int r = targets[3 * f], logical = targets[3 * f + 1], slot = targets[3 * f + 2];
  if (r < 0 || slot < 0) return;  // uniform over the block
  for (int o = threadIdx.x; o < page; o += blockDim.x) {
    int last = -1;
    for (int s = 0; s < S; ++s) {
      const int owner = meta[2 * s], lpos = meta[2 * s + 1];
      if (owner == r && lpos >= 0 && lpos / page == logical && lpos % page == o) last = s;
    }
    src[o] = last;
  }
  __syncthreads();
  for (int o = 0; o < page; ++o) {
    const int s = src[o];
    if (s < 0) continue;
    const size_t dst = (((size_t)l * P + slot) * page + o) * row_vec;
    const size_t from = ((size_t)l * S + s) * row_vec;
    for (int i = threadIdx.x; i < row_vec; i += blockDim.x) {
      k_pages[dst + i] = log_k[from + i];
      v_pages[dst + i] = log_v[from + i];
    }
  }
}

extern "C" int repro_log_compact(void* k_pages, void* v_pages, const void* log_k, const void* log_v,
                                 const void* meta, const void* targets, int L, int P, int page,
                                 int S, int F, int row_bytes, void* stream) {
  if (page > LC_MAX_PAGE) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(F, L);
  log_compact_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(k_pages), static_cast<uint4*>(v_pages), static_cast<const uint4*>(log_k),
      static_cast<const uint4*>(log_v), static_cast<const int*>(meta),
      static_cast<const int*>(targets), P, page, S, row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}
