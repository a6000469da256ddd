// Paged decode attention with the write log: the decode read path.
//
// Replaces src/repro/kernels/paged_attention/kernel.py::paged_decode_attention_pallas
// (pallas_call at kernel.py:117, body _kernel at :27) and the write-log pass
// and flash-decoding combine that JAX runs around it in jnp
// (src/repro/kernels/paged_attention/ops.py:28-95).
//
// One-token GQA attention of each request row over (a) its pages below the
// compaction watermark `page_lengths[b]` and (b) the write-log slots it owns
// (owner == request >= 0, 0 <= position < lengths[b]). The runtime keeps the
// two disjoint (append-only KV), so nothing is shadowed here.
//
// Bound: bytes. Decode does about one FLOP per byte, so the least time is
// every valid K/V byte read once at the memory rate; the tensor cores buy
// nothing and the arithmetic is fp32 on the CUDA cores. Design, two launches
// a call and no other device op:
//
// 1. paged_split_kernel, grid (B, KV, n_split): the pages of a row are split
//    into runs of `pps` whole pages (n_split chosen on the host so that the
//    grid covers the card about twice), so the B x KV (row, KV head) pairs of
//    a decode step become hundreds of blocks. A block whose pages all lie at
//    or beyond ceil(page_len / page), or are non-resident, writes the empty
//    partial (m = -1e30, l = 0, acc = 0) and exits. Otherwise K and V of its
//    pages stream into shared memory as two cp.async groups (16-byte copies,
//    masked rows zero-filled, nothing read for them), so V is in flight while
//    the scores are computed; K/V stay in the cache dtype there. Eight lanes
//    score a token against all g query heads of the KV head (a 3-step
//    shuffle reduction); a warp per head takes the split's max and sum; a
//    thread per pair of head dims forms the un-normalised p.v over a group
//    of tokens, reading each V pair once for all g heads. Output: fp32
//    partials acc (B, KV, n_split, g, hd), m and l (B, KV, n_split, g).
// 2. paged_combine_kernel, grid (B, KV): the write-log pass (the row's valid
//    slots compacted in slot order by a warp ballot, their K/V rows staged by
//    cp.async and scored as in 1.) and the flash-decoding combine of every
//    split and the log, normalised by max(l, 1e-30), written in q's dtype.
//
// What bounds it in practice: each kernel is a chain of dependent memory
// round trips (page table, then K/V; log meta, then log rows, then the
// partials), not bandwidth.
//
// Numerics: fp32 scores q.k / sqrt(hd) and fp32 p.v (as the Pallas kernel;
// the jnp oracle rounds the softmax weights to bf16 first). Masked positions
// take the finite -1e30 and weight exactly 0, so a row with no valid key (a
// padded batch row, req_ids = -1) gives a finite 0, never NaN.
#include "common.cuh"

constexpr int PA_THREADS = 256;
constexpr int PA_WARPS = PA_THREADS / 32;
constexpr int PA_LPT = 8;    // lanes per token row in the score pass
constexpr int PA_MAX_G = 8;  // query heads per KV head

__device__ __forceinline__ void load2_f32(const float* p, float& x, float& y) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x = v.x;
  y = v.y;
}
__device__ __forceinline__ void load2_f32(const __nv_bfloat16* p, float& x, float& y) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  x = v.x;
  y = v.y;
}

// Scores of n staged rows (row r at rows + r * hd, shared memory) against
// the g query heads of q_s (fp32): 8 lanes a row, 16-byte chunks, a 3-step
// shuffle reduction, 4 rows a warp at a time. Row r whose ok[r] == 0 (or
// r >= n) scores the finite -1e30. s_out[h * s_ld + r].
template <typename T>
__device__ __forceinline__ void score_rows(const T* rows, int n, const int* ok, const float* q_s,
                                           float* s_out, int s_ld, int g, int hd, float rsq) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % PA_LPT, grp = lane / PA_LPT;
  constexpr int VEC = 16 / (int)sizeof(T);
  const int cpr = hd / VEC;
  for (int r0 = warp * (32 / PA_LPT); r0 < n; r0 += PA_THREADS / PA_LPT) {
    const int r = r0 + grp;
    const bool live = r < n && (ok == nullptr || ok[r]);
    float dot[PA_MAX_G];
#pragma unroll
    for (int h = 0; h < PA_MAX_G; ++h) dot[h] = 0.f;
    if (live) {
      for (int c = sub; c < cpr; c += PA_LPT) {
        float kf[VEC];
        load16_f32(rows + (size_t)r * hd + c * VEC, kf);
#pragma unroll
        for (int h = 0; h < PA_MAX_G; ++h) {
          if (h < g) {
            const float* qh = q_s + h * hd + c * VEC;
#pragma unroll
            for (int e = 0; e < VEC; ++e) dot[h] = fmaf(qh[e], kf[e], dot[h]);
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < PA_MAX_G; ++h) {
      if (h < g) {
        float d = dot[h];
#pragma unroll
        for (int o = PA_LPT / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        if (sub == 0 && r < n) s_out[h * s_ld + r] = live ? d / rsq : REPRO_NEG_INF;
      }
    }
  }
}

// out[h * hd + d] = sum_r p[h * p_ld + r] * rows[r * hd + d] for h < g,
// d < hd. A thread takes two neighbouring dims of every head (each V pair
// read once for all g heads) over one of `groups` interleaved token groups;
// the groups are summed through red (groups * g * hd floats). Ends with
// out written; every thread of the block must call it.
template <typename T>
__device__ __forceinline__ void weighted_sum(const T* rows, int n, const float* p, int p_ld, int g,
                                             int hd, float* red, float* out) {
  const int pairs = hd / 2;
  const int groups = max(1, PA_THREADS / pairs);
  const int t = threadIdx.x, dp = t % pairs, tg = t / pairs;
  if (tg < groups) {
    float a[PA_MAX_G][2];
#pragma unroll
    for (int h = 0; h < PA_MAX_G; ++h) a[h][0] = a[h][1] = 0.f;
    for (int r = tg; r < n; r += groups) {
      float x, y;
      load2_f32(rows + (size_t)r * hd + 2 * dp, x, y);
#pragma unroll
      for (int h = 0; h < PA_MAX_G; ++h) {
        if (h < g) {
          const float w = p[h * p_ld + r];
          a[h][0] = fmaf(w, x, a[h][0]);
          a[h][1] = fmaf(w, y, a[h][1]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < PA_MAX_G; ++h) {
      if (h < g) {
        red[(tg * g + h) * hd + 2 * dp] = a[h][0];
        red[(tg * g + h) * hd + 2 * dp + 1] = a[h][1];
      }
    }
  }
  __syncthreads();
  for (int i = t; i < g * hd; i += PA_THREADS) {
    float s = 0.f;
    for (int k = 0; k < groups; ++k) s += red[k * g * hd + i];
    out[i] = s;
  }
}

// Softmax statistics of each head's n scores (a warp per head): m = max,
// weights exp(s - m) (exactly 0 where ok[r] == 0), l = their sum.
__device__ __forceinline__ void softmax_rows(float* s, int s_ld, int n, const int* ok, int g,
                                             float* m_s, float* l_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int h = warp; h < g; h += PA_WARPS) {
    float mx = REPRO_NEG_INF;
    for (int r = lane; r < n; r += 32) mx = fmaxf(mx, s[h * s_ld + r]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float p = (ok == nullptr || ok[r]) ? expf(s[h * s_ld + r] - mx) : 0.f;
      s[h * s_ld + r] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[h] = mx;
      l_s[h] = sum;
    }
  }
}

__host__ __device__ inline int pa_red_floats(int g, int hd) {
  const int pairs = hd / 2;
  return (PA_THREADS / pairs > 1 ? PA_THREADS / pairs : 1) * g * hd;
}

template <typename T>
__global__ void __launch_bounds__(PA_THREADS)
    paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages, const int* __restrict__ page_table,
                       const int* __restrict__ page_lengths, float* __restrict__ acc,
                       float* __restrict__ m_out, float* __restrict__ l_out, int H, int KV, int hd,
                       int page, int N, int pps, int n_split) {
  const int b = blockIdx.x, kv = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x;
  const int g = H / KV, tile = pps * page;
  const int plen = page_lengths[b];
  const int n_valid = min(N, (plen + page - 1) / page);
  const int n0 = sp * pps;
  const size_t part = ((size_t)b * KV + kv) * n_split + sp;
  extern __shared__ __align__(16) uint8_t smem[];
  T* k_s = reinterpret_cast<T*>(smem);                            // tile * hd
  T* v_s = k_s + (size_t)tile * hd;                                // tile * hd
  float* q_s = reinterpret_cast<float*>(v_s + (size_t)tile * hd);  // g * hd
  float* p_s = q_s + g * hd;                                       // g * tile: scores, then weights
  float* m_s = p_s + g * tile;                                     // g
  float* l_s = m_s + g;                                            // g
  float* red = l_s + g;                                            // pa_red_floats(g, hd)
  int* slot_s = reinterpret_cast<int*>(red + pa_red_floats(g, hd));  // pps: pool slot, -1 = skipped
  int* ok_s = slot_s + pps;                                        // tile: token valid

  int resident = 0;
  if (tid < pps) {
    const int n = n0 + tid;
    const int raw = n < N ? page_table[(size_t)b * N + n] : -1;  // in flight beside page_lengths[b]
    const int slot = n < n_valid ? raw : -1;
    slot_s[tid] = slot;
    resident = slot >= 0;
  }
  if (!__syncthreads_or(resident)) {  // nothing to read: the empty partial
    for (int i = tid; i < g * hd; i += PA_THREADS) acc[part * g * hd + i] = 0.f;
    if (tid < g) {
      m_out[part * g + tid] = REPRO_NEG_INF;
      l_out[part * g + tid] = 0.f;
    }
    return;
  }
  // K, then V: two groups of 16-byte copies in flight together; a token is
  // valid if its page is resident and its position below the watermark
  constexpr int VEC = 16 / (int)sizeof(T);
  const int cpr = hd / VEC;  // copies per token row
  for (int i = tid; i < tile * cpr; i += PA_THREADS) {
    const int r = i / cpr, c = (i % cpr) * VEC;
    const bool ok = slot_s[r / page] >= 0 && (n0 + r / page) * page + r % page < plen;
    if (c == 0) ok_s[r] = ok;
    const size_t off = ok ? (((size_t)slot_s[r / page] * page + r % page) * KV + kv) * hd + c : 0;
    cp_async16(k_s + (size_t)r * hd + c, k_pages + off, ok ? 16 : 0);
  }
  cp_async_commit();
  for (int i = tid; i < tile * cpr; i += PA_THREADS) {
    const int r = i / cpr, c = (i % cpr) * VEC;
    const bool ok = slot_s[r / page] >= 0 && (n0 + r / page) * page + r % page < plen;
    const size_t off = ok ? (((size_t)slot_s[r / page] * page + r % page) * KV + kv) * hd + c : 0;
    cp_async16(v_s + (size_t)r * hd + c, v_pages + off, ok ? 16 : 0);
  }
  cp_async_commit();
  for (int i = tid; i < g * hd; i += PA_THREADS) q_s[i] = to_f(q[((size_t)b * H + kv * g) * hd + i]);
  cp_async_wait<1>();  // K has landed
  __syncthreads();    // ... for every thread, and ok_s is written

  score_rows(k_s, tile, ok_s, q_s, p_s, tile, g, hd, sqrtf((float)hd));
  __syncthreads();
  softmax_rows(p_s, tile, tile, ok_s, g, m_s, l_s);
  cp_async_wait<0>();  // V has landed
  __syncthreads();
  weighted_sum(v_s, tile, p_s, tile, g, hd, red, acc + part * g * hd);  // un-normalised p.v
  if (tid < g) {
    m_out[part * g + tid] = m_s[tid];
    l_out[part * g + tid] = l_s[tid];
  }
}

template <typename T>
__global__ void __launch_bounds__(PA_THREADS)
    paged_combine_kernel(const T* __restrict__ q, const T* __restrict__ log_k,
                         const T* __restrict__ log_v, const int* __restrict__ log_meta,
                         const int* __restrict__ lengths, const int* __restrict__ req_ids,
                         const float* __restrict__ acc, const float* __restrict__ m_in,
                         const float* __restrict__ l_in, T* __restrict__ out, int H, int KV, int hd,
                         int n_split, int S_log) {
  const int b = blockIdx.x, kv = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = H / KV;
  const size_t part0 = ((size_t)b * KV + kv) * n_split;
  extern __shared__ __align__(16) uint8_t smem[];
  T* k_l = reinterpret_cast<T*>(smem);                            // S_log * hd: valid log rows
  T* v_l = k_l + (size_t)S_log * hd;                               // S_log * hd
  float* q_s = reinterpret_cast<float*>(v_l + (size_t)S_log * hd);  // g * hd
  float* ps = q_s + g * hd;                                        // g * S_log: scores, then weights
  float* w_s = ps + g * S_log;                                     // g * n_split: split weights
  float* ml_s = w_s + g * n_split;                                 // g: the log's m
  float* ll_s = ml_s + g;                                          // g: the log's l
  float* wl_s = ll_s + g;                                          // g: the log's weight
  float* inv_s = wl_s + g;                                         // g: 1 / denominator
  float* ol_s = inv_s + g;                                         // g * hd: the log's p.v
  float* red = ol_s + g * hd;                                      // pa_red_floats(g, hd)
  int* list = reinterpret_cast<int*>(red + pa_red_floats(g, hd));  // S_log: valid slots, in order
  int* n_log_s = list + S_log;

  // 1. the log slots this row owns (a warp ballot keeps slot order)
  if (warp == 0) {
    const int req = req_ids != nullptr ? req_ids[b] : b;
    const int len = S_log > 0 ? lengths[b] : 0;
    int cnt = 0;
    for (int base = 0; base < S_log; base += 32) {
      const int i = base + lane;
      bool ok = false;
      if (i < S_log && req >= 0) {
        const int owner = log_meta[2 * i], pos = log_meta[2 * i + 1];
        ok = owner == req && pos >= 0 && pos < len;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, ok);
      if (ok) list[cnt + __popc(bal & ((1u << lane) - 1u))] = i;
      cnt += __popc(bal);
    }
    if (lane == 0) *n_log_s = cnt;
  }
  for (int i = tid; i < g * hd; i += PA_THREADS) q_s[i] = to_f(q[((size_t)b * H + kv * g) * hd + i]);
  __syncthreads();
  const int nl = *n_log_s;

  // 2. the valid log rows into shared memory, K then V, all in flight
  constexpr int VEC = 16 / (int)sizeof(T);
  const int cpr = hd / VEC;
  for (int i = tid; i < nl * cpr; i += PA_THREADS) {
    const int j = i / cpr, c = (i % cpr) * VEC;
    cp_async16(k_l + (size_t)j * hd + c, log_k + ((size_t)list[j] * KV + kv) * hd + c, 16);
  }
  cp_async_commit();
  for (int i = tid; i < nl * cpr; i += PA_THREADS) {
    const int j = i / cpr, c = (i % cpr) * VEC;
    cp_async16(v_l + (size_t)j * hd + c, log_v + ((size_t)list[j] * KV + kv) * hd + c, 16);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // 3. the log pass: scores, then its (m, l) per head
  score_rows(k_l, nl, nullptr, q_s, ps, S_log, g, hd, sqrtf((float)hd));
  __syncthreads();
  softmax_rows(ps, S_log, nl, nullptr, g, ml_s, ll_s);
  __syncthreads();
  // 4. flash-decoding weights of every split and of the log, a warp per head
  for (int h = warp; h < g; h += PA_WARPS) {
    const float ml = ml_s[h];
    float M = ml;
    for (int s = lane; s < n_split; s += 32) M = fmaxf(M, m_in[(part0 + s) * g + h]);
    M = warp_max(M);
    float den = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const float w = expf(m_in[(part0 + s) * g + h] - M);
      w_s[h * n_split + s] = w;
      den = fmaf(w, l_in[(part0 + s) * g + h], den);
    }
    den = warp_sum(den);
    if (lane == 0) {
      const float wl = expf(ml - M);
      wl_s[h] = wl;
      inv_s[h] = 1.f / fmaxf(den + wl * ll_s[h], 1e-30f);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  weighted_sum(v_l, nl, ps, S_log, g, hd, red, ol_s);
  __syncthreads();
  // 5. merge and normalise
  for (int i = tid; i < g * hd; i += PA_THREADS) {
    const int h = i / hd;
    float o = 0.f;
    for (int s0 = 0; s0 < n_split; s0 += 8) {  // 8 partial loads in flight at a time
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = s0 + u < n_split ? acc[(part0 + s0 + u) * g * hd + i] : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (s0 + u < n_split) o = fmaf(w_s[h * n_split + s0 + u], v[u], o);
    }
    out[((size_t)b * H + kv * g) * hd + i] = from_f<T>((o + wl_s[h] * ol_s[i]) * inv_s[h]);
  }
}

template <typename T>
static int launch(const void* q, const void* k_pages, const void* v_pages, const void* page_table,
                  const void* page_lengths, const void* log_k, const void* log_v,
                  const void* log_meta, const void* lengths, const void* req_ids, void* acc,
                  void* m, void* l, void* out, int B, int H, int KV, int hd, int page, int N,
                  int pps, int n_split, int S_log, int smem_split, int smem_combine,
                  cudaStream_t stream) {
  static int granted_split = 0, granted_combine = 0;
  cudaError_t err = ensure_smem(paged_split_kernel<T>, smem_split, granted_split);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = ensure_smem(paged_combine_kernel<T>, smem_combine, granted_combine);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_split_kernel<T><<<dim3(B, KV, n_split), PA_THREADS, smem_split, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const int*>(page_table), static_cast<const int*>(page_lengths),
      static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l), H, KV, hd, page, N,
      pps, n_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_combine_kernel<T><<<dim3(B, KV), PA_THREADS, smem_combine, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(log_k), static_cast<const T*>(log_v),
      static_cast<const int*>(log_meta), static_cast<const int*>(lengths),
      static_cast<const int*>(req_ids), static_cast<const float*>(acc),
      static_cast<const float*>(m), static_cast<const float*>(l), static_cast<T*>(out), H, KV, hd,
      n_split, S_log);
  return static_cast<int>(cudaGetLastError());
}

// Both launches of one call. S_log = 0: no write log (log_k, log_v,
// log_meta and lengths unused); req_ids null: row b serves request b.
extern "C" int repro_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                     const void* page_table, const void* page_lengths,
                                     const void* log_k, const void* log_v, const void* log_meta,
                                     const void* lengths, const void* req_ids, void* acc, void* m,
                                     void* l, void* out, int B, int H, int KV, int hd, int page,
                                     int N, int pps, int n_split, int S_log,
                                     int smem_split, int smem_combine, int dtype, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > PA_MAX_G || hd > 256 || pps <= 0 || n_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, page_lengths, log_k, log_v,
                                 log_meta, lengths, req_ids, acc, m, l, out, B, H, KV, hd, page, N,
                                 pps, n_split, S_log, smem_split, smem_combine, s);
  if (dtype == REPRO_F32)
    return launch<float>(q, k_pages, v_pages, page_table, page_lengths, log_k, log_v, log_meta,
                         lengths, req_ids, acc, m, l, out, B, H, KV, hd, page, N, pps, n_split,
                         S_log, smem_split, smem_combine, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
