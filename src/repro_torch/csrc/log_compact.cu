// Write-log compaction: coalesce log tokens into whole pages of both tiers
// in one pass.
//
// Replaces src/repro/kernels/log_compact/kernel.py::log_compact_pallas
// (pallas_call at kernel.py:86, body _kernel at :22, scatter at :109-118),
// which the JAX runtime calls once per tier (core/tiering.py::compact_log).
//
// A target is (request r, logical page p, slot in pool A, slot in pool B);
// a slot < 0 means the page has no copy in that pool (pool B is absent for
// the one-pool call). For each target and layer, every log slot whose
// (owner, pos // page) is (r, p) overwrites the page row at pos % page in
// each pool that holds the page; later slots win. Targets with r < 0 write
// nothing. Bound: bytes — the matched log rows are read once and written
// once per pool that holds their page. Design: one block per (target,
// layer, K or V). The block stages the meta rows in shared memory with one
// coalesced load and resolves the newest slot of every in-page offset in
// parallel (each thread scans a share of the slots for one offset, then a
// max over the shares: "later slot wins" needs no atomics). Then warp 0
// moves the page: one Hopper bulk copy (cp.async.bulk) of each matched row
// into shared memory, all in flight at once and completed on one mbarrier,
// and one bulk store of each row into each pool that holds the page. On an
// H100 this took 7.8 µs for the 22 MB of a full log at full width, against
// 8.6 µs for a register copy with all of a thread's 16-byte loads issued
// before its stores (scripts/compact_copy_variants.py). Precondition
// (engine-guaranteed, as in the JAX oracle): the slots of one pool are
// distinct across targets, so no two blocks write the same page. Pure
// copies: bit-exact.
#include "common.cuh"
#include "hopper.cuh"

constexpr int LC_THREADS = 128;

// Dynamic shared memory: the page's rows, then the meta rows, the partial
// scans and the newest slot of each offset.
__host__ __device__ constexpr int lc_parts(int page) { return page < LC_THREADS ? LC_THREADS / page : 1; }
__host__ __device__ constexpr size_t lc_smem(int page, int S, int row_bytes) {
  return (size_t)page * row_bytes + (size_t)S * 8 + (size_t)lc_parts(page) * page * 4 + (size_t)page * 4;
}

__global__ void __launch_bounds__(LC_THREADS)
    log_compact_kernel(char* __restrict__ a_k, char* __restrict__ a_v, char* __restrict__ b_k,
                       char* __restrict__ b_v, const char* __restrict__ log_k,
                       const char* __restrict__ log_v, const int2* __restrict__ meta,
                       const int* __restrict__ targets, int ncols, int PA, int PB, int page, int S,
                       int row_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bar;
  unsigned char* rows = smem;
  int2* sm_meta = reinterpret_cast<int2*>(smem + (size_t)page * row_bytes);
  int* sm_part = reinterpret_cast<int*>(sm_meta + S);
  const int parts = lc_parts(page);
  int* sm_src = sm_part + parts * page;

  const int f = blockIdx.x, l = blockIdx.y, z = blockIdx.z, tid = threadIdx.x;
  const int* t = targets + (size_t)f * ncols;
  const int r = t[0], logical = t[1], sa = t[2], sb = ncols > 3 ? t[3] : -1;
  if (r < 0 || (sa < 0 && sb < 0)) return;  // uniform over the block

  for (int s = tid; s < S; s += LC_THREADS) sm_meta[s] = meta[s];
  if (tid == 0) {
    mbar_init(smem_u32(&bar), 1);
    mbar_fence_init();
  }
  __syncthreads();
  // newest matching slot of each offset: parts x page candidates, then a max
  const int per = (S + parts - 1) / parts;
  for (int idx = tid; idx < parts * page; idx += LC_THREADS) {
    const int part = idx / page, o = idx % page;
    const int end = min(S, (part + 1) * per);
    int last = -1;
    for (int s = part * per; s < end; ++s) {
      const int2 m = sm_meta[s];
      if (m.x == r && m.y >= 0 && m.y / page == logical && m.y % page == o) last = s;
    }
    sm_part[idx] = last;
  }
  __syncthreads();
  for (int o = tid; o < page; o += LC_THREADS) {
    int last = -1;
    for (int p = 0; p < parts; ++p) last = max(last, sm_part[p * page + o]);
    sm_src[o] = last;
  }
  __syncthreads();
  if (tid >= 32) return;  // warp 0 moves the rows: lane o the rows at o, o + 32, ...

  const char* src = (z == 0 ? log_k : log_v) + (size_t)l * S * row_bytes;
  char* da = sa >= 0 ? (z == 0 ? a_k : a_v) + ((size_t)l * PA + sa) * page * row_bytes : nullptr;
  char* db = sb >= 0 ? (z == 0 ? b_k : b_v) + ((size_t)l * PB + sb) * page * row_bytes : nullptr;
  int n = 0;
  for (int o = 0; o < page; ++o) n += sm_src[o] >= 0;
  const uint32_t b = smem_u32(&bar);
  if (tid == 0) mbar_expect_tx(b, (uint32_t)n * row_bytes);
  __syncwarp();
  for (int o = tid; o < page; o += 32)
    if (sm_src[o] >= 0)
      bulk_load(smem_u32(rows + (size_t)o * row_bytes), src + (size_t)sm_src[o] * row_bytes, row_bytes, b);
  mbar_wait(b, 0);
  fence_proxy_async_smem();
  for (int o = tid; o < page; o += 32) {
    if (sm_src[o] < 0) continue;
    const uint32_t from = smem_u32(rows + (size_t)o * row_bytes);
    if (da) bulk_store(da + (size_t)o * row_bytes, from, row_bytes);
    if (db) bulk_store(db + (size_t)o * row_bytes, from, row_bytes);
  }
  bulk_commit_and_wait();
}

// Pool B (b_k, b_v) may be NULL: then targets are (F, 3) rows and only pool
// A is written (the one-pool log_compact).
extern "C" int repro_log_compact(void* a_k, void* a_v, void* b_k, void* b_v, const void* log_k,
                                 const void* log_v, const void* meta, const void* targets, int L,
                                 int PA, int PB, int page, int S, int F, int row_bytes,
                                 void* stream) {
  const size_t smem = lc_smem(page, S, row_bytes);
  if (row_bytes % 16 || smem > 227 * 1024 || (size_t)page * row_bytes >= (1u << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  static int granted = 0;
  cudaError_t err = ensure_smem(log_compact_kernel, (int)smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ncols = b_k ? 4 : 3;
  dim3 grid(F, L, 2);
  log_compact_kernel<<<grid, LC_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(a_k), static_cast<char*>(a_v), static_cast<char*>(b_k),
      static_cast<char*>(b_v), static_cast<const char*>(log_k), static_cast<const char*>(log_v),
      static_cast<const int2*>(meta), static_cast<const int*>(targets), ncols, PA, PB, page, S,
      row_bytes);
  return static_cast<int>(cudaGetLastError());
}
