// KV write-log append: the decode write path.
//
// Replaces src/repro/kernels/kv_log_append/kernel.py::kv_log_append_pallas
// (pallas_call at kernel.py:45, body _kernel at :20).
//
// In place, store the B new K/V rows of each layer at `tail` in the
// (L, S, KV, hd) log ring and write the (request, position) meta rows.
// Bound: bytes — it reads the B new rows and writes them once (a few KB a
// layer), so on the card it costs about one launch. Design: one block per
// (row, layer), 16-byte copies, no read of the surrounding log (the paper's
// cacheline append: no page fetch on the critical write path). The tail is
// a host-side integer the engine already knows; the wrapper checks that
// tail + B <= S.
#include "common.cuh"

__global__ void kv_log_append_kernel(uint4* __restrict__ log_k, uint4* __restrict__ log_v,
                                     int* __restrict__ log_meta, const uint4* __restrict__ k_new,
                                     const uint4* __restrict__ v_new, const int* __restrict__ req_ids,
                                     const int* __restrict__ positions, int S, int B, int row_vec,
                                     int tail) {
  const int b = blockIdx.x, l = blockIdx.y;
  const size_t dst = ((size_t)l * S + tail + b) * row_vec;
  const size_t src = ((size_t)l * B + b) * row_vec;
  for (int i = threadIdx.x; i < row_vec; i += blockDim.x) {
    log_k[dst + i] = k_new[src + i];
    log_v[dst + i] = v_new[src + i];
  }
  if (l == 0 && threadIdx.x == 0) {
    log_meta[2 * (tail + b)] = req_ids[b];
    log_meta[2 * (tail + b) + 1] = positions[b];
  }
}

extern "C" int repro_kv_log_append(void* log_k, void* log_v, void* log_meta, const void* k_new,
                                   const void* v_new, const void* req_ids, const void* positions,
                                   int L, int S, int B, int row_bytes, int tail, void* stream) {
  const int row_vec = row_bytes / 16;
  dim3 grid(B, L);
  kv_log_append_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(log_k), static_cast<uint4*>(log_v), static_cast<int*>(log_meta),
      static_cast<const uint4*>(k_new), static_cast<const uint4*>(v_new),
      static_cast<const int*>(req_ids), static_cast<const int*>(positions), S, B, row_vec, tail);
  return static_cast<int>(cudaGetLastError());
}
