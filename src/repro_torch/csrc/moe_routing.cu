// The capacity MoE's routing glue: the router's softmax and top k, the
// capacity slots, the dispatch into the experts' buffers, the SwiGLU
// epilogue between the expert GEMMs, and the gated combine.
//
// Replaces no Pallas kernel: the JAX package's moe_ffn
// (src/repro/models/layers.py) is plain jnp that XLA fuses. Eager PyTorch
// ran it as ~37 launches a call, and the slot claim as an int64 scan down a
// (T x k, E) one-hot. These five kernels are the whole call but for the
// router's matmul and the three expert GEMMs (cuBLAS). Bound: launches and
// latency at decode (a few KB each); at a 2048-token prefill, bytes (the
// dispatch writes the (E, cap, d) buffer, ~84 MB at olmoe's widths).
//
// Each kernel repeats the plain version's rounding points (the `ref.py` of
// kernels/moe_routing), so the routing decisions are the plain version's:
//   route    — one warp a token. Lane l holds columns l + 32 i, as torch's
//              persistent softmax (ATen PersistentSoftmax.cuh) lays them; the
//              max and the sum of expf(x - max) go down the warp by xor
//              shuffles (a lane past torch's narrower warp holds 0, which
//              adds nothing), then p = e / sum. The top k are k rounds of a
//              warp argmax on (p desc, id asc): the stable descending sort's
//              first k. The gates' sum adds in the order of torch's CUDA
//              reduction of a short contiguous row (halving), then clamp and
//              an IEEE divide.
//   slots    — one block an expert; the pairs in token-major, choice-minor
//              order in chunks, each chunk's matches ranked by a block scan:
//              pos is the pair's claim number, keep pos < cap. A pair whose
//              id lies outside [0, E) gets pos -1, keep false.
//   dispatch — one block a run of one expert's slots: it finds the kept
//              pairs that claimed them (one read of the ids), then writes
//              every slot's row as 16-byte vectors, zeros where none did.
//   swiglu   — silu(h) in fp32 (x / (1 + expf(-x))), rounded to the storage
//              type, times u, rounded.
//   combine  — one block a token: the fp32 sum over its k choices of the
//              gate times keep, rounded to the storage type, times the
//              expert's output row at clip(pos); rounded once.
#include "common.cuh"

constexpr int RT_WARPS = 4;
constexpr int SLOT_VPT = 4;  // consecutive pairs a thread, per chunk
constexpr int DISPATCH_ROWS = 64;
constexpr int DISPATCH_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// --------------------------------------------------------------------------
// route
// --------------------------------------------------------------------------
template <typename Tin, int ITER>
__global__ void __launch_bounds__(RT_WARPS * 32)
    moe_route_kernel(const Tin* __restrict__ raw, float* __restrict__ logits,
                     float* __restrict__ probs, float* __restrict__ gates,
                     int64_t* __restrict__ ids, int T, int E, int k, int kw) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * RT_WARPS + (threadIdx.x >> 5);
  if (t >= T) return;  // uniform over the warp
  const Tin* row = raw + (size_t)t * E;
  float x[ITER];
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const int c = lane + 32 * i;
    x[i] = c < E ? to_f(row[c]) : __int_as_float(0xff800000);  // -inf: expf gives 0
    if (c < E) logits[(size_t)t * E + c] = x[i];
  }
  float mx = x[0];
#pragma unroll
  for (int i = 1; i < ITER; ++i) mx = mx > x[i] ? mx : x[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(FULL, mx, o);
    mx = mx > y ? mx : y;
  }
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    x[i] = expf(x[i] - mx);
    sum += x[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const int c = lane + 32 * i;
    x[i] = x[i] / sum;
    if (c < E) probs[(size_t)t * E + c] = x[i];
  }
  // k rounds of a warp argmax; lane r keeps round r's (value, id)
  unsigned taken = 0;
  float mine = 0.0f;
  int mine_id = 0;
  for (int r = 0; r < k; ++r) {
    float bv = -1.0f;  // below every probability
    int bi = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < ITER; ++i) {
      const int c = lane + 32 * i;
      if (c < E && !((taken >> i) & 1u) && x[i] > bv) {
        bv = x[i];
        bi = c;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, o);
      const int oi = __shfl_xor_sync(FULL, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (bi < E && (bi & 31) == lane) taken |= 1u << (bi >> 5);
    if (lane == r) {
      mine = bv;
      mine_id = bi;
    }
  }
  // the gates' sum: lane l < kw adds its value and the one kw above it,
  // then the kw partial sums are halved down to lane 0
  const float above = __shfl_down_sync(FULL, mine, kw);
  float s = lane < kw ? mine : 0.0f;
  if (lane + kw < k) s += above;
  for (int o = kw >> 1; o > 0; o >>= 1) s += __shfl_down_sync(FULL, s, o);
  s = __shfl_sync(FULL, s, 0);
  s = s < 1e-9f ? 1e-9f : s;  // clamp(min=1e-9); a NaN stays NaN
  if (lane < k) {
    gates[(size_t)t * k + lane] = mine / s;
    ids[(size_t)t * k + lane] = mine_id;
  }
}

template <typename Tin>
static cudaError_t launch_route(const void* raw, float* logits, float* probs, float* gates,
                                int64_t* ids, int T, int E, int k, int kw, cudaStream_t s) {
  const dim3 grid((T + RT_WARPS - 1) / RT_WARPS), block(RT_WARPS * 32);
  const Tin* x = static_cast<const Tin*>(raw);
  const int iter = E <= 32 ? 1 : (E + 31) / 32;
#define ROUTE(N)                                                                     \
  moe_route_kernel<Tin, N><<<grid, block, 0, s>>>(x, logits, probs, gates, ids, T, E, k, kw); \
  break;
  switch (iter <= 1 ? 1 : iter <= 2 ? 2 : iter <= 4 ? 4 : iter <= 8 ? 8 : iter <= 16 ? 16 : 32) {
    case 1: ROUTE(1)
    case 2: ROUTE(2)
    case 4: ROUTE(4)
    case 8: ROUTE(8)
    case 16: ROUTE(16)
    default: ROUTE(32)
  }
#undef ROUTE
  return cudaGetLastError();
}

// raw: the router's (T, E) logits in the storage type; kw: the largest
// power of two <= k (the width torch's reduction halves from).
extern "C" int repro_moe_route(const void* raw, void* logits, void* probs, void* gates, void* ids,
                               int T, int E, int k, int kw, int dtype, void* stream) {
  if (T <= 0 || E <= 0 || E > 1024 || k <= 0 || k > E || k > 32 || kw <= 0 || kw > k ||
      2 * kw <= k)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *l = static_cast<float*>(logits), *p = static_cast<float*>(probs), *g = static_cast<float*>(gates);
  int64_t* i = static_cast<int64_t*>(ids);
  if (dtype == REPRO_BF16) return static_cast<int>(launch_route<__nv_bfloat16>(raw, l, p, g, i, T, E, k, kw, s));
  if (dtype == REPRO_F32) return static_cast<int>(launch_route<float>(raw, l, p, g, i, T, E, k, kw, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// --------------------------------------------------------------------------
// slots
// --------------------------------------------------------------------------
__global__ void moe_slots_kernel(const int64_t* __restrict__ ids, int64_t* __restrict__ pos,
                                 bool* __restrict__ keep, int N, int E, int cap) {
  __shared__ int warp_incl[32];
  const int e = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5, chunk = blockDim.x * SLOT_VPT;
  int base = 0;
  for (int c0 = 0; c0 < N; c0 += chunk) {
    const int p0 = c0 + tid * SLOT_VPT;
    unsigned match = 0;
    int n = 0;
#pragma unroll
    for (int j = 0; j < SLOT_VPT; ++j) {
      const int p = p0 + j;
      if (p >= N) break;
      const int64_t id = ids[p];
      if (id == e) {
        match |= 1u << j;
        ++n;
      } else if (e == 0 && (id < 0 || id >= E)) {
        pos[p] = -1;
        keep[p] = false;
      }
    }
    // block-wide inclusive scan of n: in the warp, then over the warps
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_incl[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = lane < n_warps ? warp_incl[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, w, o);
        if (lane >= o) w += y;
      }
      if (lane < n_warps) warp_incl[lane] = w;
    }
    __syncthreads();
    int claim = base + (warp ? warp_incl[warp - 1] : 0) + incl - n;
    for (int j = 0; j < SLOT_VPT; ++j) {
      if (!((match >> j) & 1u)) continue;
      pos[p0 + j] = claim;
      keep[p0 + j] = claim < cap;
      ++claim;
    }
    base += warp_incl[n_warps - 1];
    __syncthreads();  // warp_incl is rewritten by the next chunk
  }
}

extern "C" int repro_moe_slots(const void* ids, void* pos, void* keep, int N, int E, int cap,
                               int threads, void* stream) {
  if (N <= 0 || E <= 0 || threads <= 0 || threads > 1024 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  moe_slots_kernel<<<E, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ids), static_cast<int64_t*>(pos), static_cast<bool*>(keep), N, E, cap);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------------
// dispatch
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(DISPATCH_THREADS)
    moe_dispatch_kernel(const char* __restrict__ xt, const int64_t* __restrict__ ids,
                        const int64_t* __restrict__ pos, const bool* __restrict__ keep,
                        char* __restrict__ buf, int N, int k, int cap, int row_bytes) {
  __shared__ int src[DISPATCH_ROWS];
  const int e = blockIdx.x, s0 = blockIdx.y * DISPATCH_ROWS, tid = threadIdx.x;
  const int rows = min(DISPATCH_ROWS, cap - s0);
  for (int r = tid; r < DISPATCH_ROWS; r += DISPATCH_THREADS) src[r] = -1;
  __syncthreads();
  for (int p = tid; p < N; p += DISPATCH_THREADS) {
    if (ids[p] != e || !keep[p]) continue;
    const int64_t s = pos[p] - s0;
    if (s >= 0 && s < rows) src[s] = p / k;
  }
  __syncthreads();
  const int vecs = row_bytes / 16;
  uint4* out = reinterpret_cast<uint4*>(buf + ((size_t)e * cap + s0) * row_bytes);
  for (int i = tid; i < rows * vecs; i += DISPATCH_THREADS) {
    const int r = i / vecs, c = i - r * vecs;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (src[r] >= 0) v = reinterpret_cast<const uint4*>(xt + (size_t)src[r] * row_bytes)[c];
    out[i] = v;
  }
}

extern "C" int repro_moe_dispatch(const void* xt, const void* ids, const void* pos, const void* keep,
                                  void* buf, int N, int k, int E, int cap, int row_bytes,
                                  void* stream) {
  if (N <= 0 || k <= 0 || E <= 0 || cap <= 0 || row_bytes <= 0 || row_bytes % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(E, (cap + DISPATCH_ROWS - 1) / DISPATCH_ROWS);
  moe_dispatch_kernel<<<grid, DISPATCH_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(xt), static_cast<const int64_t*>(ids), static_cast<const int64_t*>(pos),
      static_cast<const bool*>(keep), static_cast<char*>(buf), N, k, cap, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------------
// SwiGLU epilogue
// --------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ T swiglu_one(T h, T u) {
  const float x = to_f(h);
  const T s = from_f<T>(x / (1.0f + expf(-x)));
  return from_f<T>(to_f(s) * to_f(u));
}

template <typename T>
__global__ void moe_swiglu_kernel(T* __restrict__ out, const T* __restrict__ h, const T* __restrict__ u,
                                  size_t n) {
  constexpr int V = 16 / sizeof(T);
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t n_vec = n / V;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec; i += stride) {
    uint4 hv = reinterpret_cast<const uint4*>(h)[i];
    const uint4 uv = reinterpret_cast<const uint4*>(u)[i];
    T* he = reinterpret_cast<T*>(&hv);
    const T* ue = reinterpret_cast<const T*>(&uv);
#pragma unroll
    for (int j = 0; j < V; ++j) he[j] = swiglu_one(he[j], ue[j]);
    reinterpret_cast<uint4*>(out)[i] = hv;
  }
  for (size_t i = n_vec * V + (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    out[i] = swiglu_one(h[i], u[i]);
}

extern "C" int repro_moe_swiglu(void* out, const void* h, const void* u, long long n, int blocks,
                                int dtype, void* stream) {
  if (n <= 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16)
    moe_swiglu_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<__nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(h),
        static_cast<const __nv_bfloat16*>(u), (size_t)n);
  else if (dtype == REPRO_F32)
    moe_swiglu_kernel<float><<<blocks, 256, 0, s>>>(static_cast<float*>(out), static_cast<const float*>(h),
                                                    static_cast<const float*>(u), (size_t)n);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------------
// combine
// --------------------------------------------------------------------------
template <typename T>
__global__ void moe_combine_kernel(const T* __restrict__ eo, const int64_t* __restrict__ ids,
                                   const int64_t* __restrict__ pos, const float* __restrict__ gates,
                                   const bool* __restrict__ keep, T* __restrict__ out, int k, int E,
                                   int cap, int d) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float g[32];
  __shared__ long long row[32];
  const int t = blockIdx.x, tid = threadIdx.x;
  if (tid < k) {
    const size_t p = (size_t)t * k + tid;
    g[tid] = to_f(from_f<T>(gates[p] * (keep[p] ? 1.0f : 0.0f)));  // the gate in the storage type
    const int64_t e = ids[p];
    const int64_t s = pos[p] < 0 ? 0 : pos[p] >= cap ? cap - 1 : pos[p];
    row[tid] = (e >= 0 && e < E) ? ((long long)e * cap + s) * d : -1;
  }
  __syncthreads();
  for (int c = tid * V; c < d; c += blockDim.x * V) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    for (int j = 0; j < k; ++j) {
      if (row[j] < 0) continue;
      float x[V];
      load16_f32(eo + row[j] + c, x);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(g[j], x[v], acc[v]);
    }
    uint4 o;
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int v = 0; v < V; ++v) oe[v] = from_f<T>(acc[v]);
    *reinterpret_cast<uint4*>(out + (size_t)t * d + c) = o;
  }
}

extern "C" int repro_moe_combine(const void* eo, const void* ids, const void* pos, const void* gates,
                                 const void* keep, void* out, int T, int k, int E, int cap, int d,
                                 int threads, int dtype, void* stream) {
  if (!keep || T <= 0 || k <= 0 || k > 32 || E <= 0 || cap <= 0 || d <= 0 || threads < 32 ||
      threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t *i = static_cast<const int64_t*>(ids), *p = static_cast<const int64_t*>(pos);
  const float* g = static_cast<const float*>(gates);
  const bool* kp = static_cast<const bool*>(keep);
  if (dtype == REPRO_BF16) {
    if (d % 8) return static_cast<int>(cudaErrorInvalidValue);
    moe_combine_kernel<__nv_bfloat16><<<T, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(eo), i, p, g, kp, static_cast<__nv_bfloat16*>(out), k, E, cap, d);
  } else if (dtype == REPRO_F32) {
    if (d % 4) return static_cast<int>(cudaErrorInvalidValue);
    moe_combine_kernel<float><<<T, threads, 0, s>>>(static_cast<const float*>(eo), i, p, g, kp,
                                                    static_cast<float*>(out), k, E, cap, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
