// Paged decode attention: the decode read path over the fast page pool.
//
// Replaces src/repro/kernels/paged_attention/kernel.py::paged_decode_attention_pallas
// (pallas_call at kernel.py:117, body _kernel at :27).
//
// One-token GQA attention of each request row over its pages below the
// compaction watermark `page_lengths[b]`; returns the normalised output and
// the softmax statistics (m, l) that the write-log pass is merged with
// (kernels/paged_attention/ops.py, the flash-decoding combine).
//
// Bound: bytes. Decode does about one FLOP per byte read, so the least time
// is every valid K/V byte read once at the memory rate. Design: one block
// per (row b, KV head); the TPU's sequential page grid axis becomes a loop
// inside the block over tiles of a few whole pages. Only pages holding a
// valid position are visited (n < ceil(page_len / page) and table entry
// >= 0): non-resident and beyond-watermark pages are never read. A tile is
// brought in with 16-byte loads issued by all 128 threads at once, and the
// g query heads that share the KV head reuse it from shared memory. With
// B x KV blocks only (32 at full width) the card is far from full; splitting
// the pages over more blocks is later work.
//
// Numerics: fp32 scores q.k / sqrt(hd); masked positions take the finite
// -1e30 and weight exactly 0, so a row without any valid key (a padded
// batch row) gives a finite 0 with m = -1e30 and l = 0, never NaN. The
// value contraction p.v is fp32, as the Pallas kernel (the jnp oracle
// rounds the final softmax weights to bf16 first).
#include "common.cuh"

constexpr int PA_THREADS = 128;
constexpr int PA_MAX_G = 8;    // query heads per KV head
constexpr int PA_MAX_DPT = 2;  // head dims per thread: hd <= 256

template <typename T>
__global__ void __launch_bounds__(PA_THREADS)
    paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                           const T* __restrict__ v_pages, const int* __restrict__ page_table,
                           const int* __restrict__ page_lengths, T* __restrict__ out,
                           float* __restrict__ m_out, float* __restrict__ l_out, int H, int KV,
                           int hd, int page, int N, int tile_pages) {
  const int b = blockIdx.x, kv = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = H / KV;
  const int tile = tile_pages * page;
  const int kld = hd + 1;  // padded K rows: a thread per row reads conflict-free
  extern __shared__ float smem[];
  float* q_s = smem;                  // g * hd
  float* k_s = q_s + g * hd;          // tile * (hd + 1)
  float* v_s = k_s + tile * kld;      // tile * hd
  float* p_s = v_s + tile * hd;       // g * tile: scores, then weights
  float* m_s = p_s + g * tile;        // g
  float* l_s = m_s + g;               // g
  float* a_s = l_s + g;               // g: rescale factor of this tile
  int* row_s = (int*)(a_s + g);       // tile: pool row of each token, -1 = masked

  const int plen = page_lengths[b];
  const int n_end = min(N, (plen + page - 1) / page);
  const float rsq = sqrtf((float)hd);
  constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16-byte load
  const int vpr = hd / VEC;

  for (int i = tid; i < g * hd; i += PA_THREADS)
    q_s[i] = to_f(q[((size_t)b * H + kv * g) * hd + i]);
  if (tid < g) {
    m_s[tid] = REPRO_NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[PA_MAX_G][PA_MAX_DPT];
#pragma unroll
  for (int h = 0; h < PA_MAX_G; ++h)
#pragma unroll
    for (int j = 0; j < PA_MAX_DPT; ++j) acc[h][j] = 0.f;

  for (int n0 = 0; n0 < n_end; n0 += tile_pages) {
    // 1. which tokens of the tile are valid, and where they live
    for (int i = tid; i < tile; i += PA_THREADS) {
      const int n = n0 + i / page, o = i % page;
      const int slot = n < n_end ? page_table[b * N + n] : -1;
      row_s[i] = (slot >= 0 && n * page + o < plen) ? slot * page + o : -1;
    }
    __syncthreads();
    // 2. K/V tile into shared memory (zeros for masked tokens)
    for (int i = tid; i < tile * vpr; i += PA_THREADS) {
      const int r = i / vpr, c = (i % vpr) * VEC;
      const int row = row_s[r];
      float kf[VEC], vf[VEC];
      if (row >= 0) {
        const size_t off = ((size_t)row * KV + kv) * hd + c;
        load16_f32(k_pages + off, kf);
        load16_f32(v_pages + off, vf);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        k_s[r * kld + c + e] = kf[e];
        v_s[r * hd + c + e] = vf[e];
      }
    }
    __syncthreads();
    // 3. scores, one (head, token) pair per thread
    for (int i = tid; i < g * tile; i += PA_THREADS) {
      const int h = i / tile, r = i % tile;
      float s = REPRO_NEG_INF;
      if (row_s[r] >= 0) {
        const float* qh = q_s + h * hd;
        const float* kr = k_s + r * kld;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qh[d], kr[d], dot);
        s = dot / rsq;
      }
      p_s[i] = s;
    }
    __syncthreads();
    // 4. online softmax, one warp per head
    for (int h = warp; h < g; h += PA_THREADS / 32) {
      float mx = REPRO_NEG_INF;
      for (int r = lane; r < tile; r += 32) mx = fmaxf(mx, p_s[h * tile + r]);
      mx = warp_max(mx);
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < tile; r += 32) {
        const float p = row_s[r] >= 0 ? expf(p_s[h * tile + r] - m_new) : 0.f;
        p_s[h * tile + r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        m_s[h] = m_new;
        l_s[h] = l_s[h] * alpha + sum;
        a_s[h] = alpha;
      }
    }
    __syncthreads();
    // 5. acc = acc * alpha + p . v, one head dim per thread
#pragma unroll
    for (int h = 0; h < PA_MAX_G; ++h) {
      if (h < g) {
        const float alpha = a_s[h];
#pragma unroll
        for (int j = 0; j < PA_MAX_DPT; ++j) {
          const int d = tid + j * PA_THREADS;
          if (d < hd) {
            float a = acc[h][j] * alpha;
            for (int r = 0; r < tile; ++r) a = fmaf(p_s[h * tile + r], v_s[r * hd + d], a);
            acc[h][j] = a;
          }
        }
      }
    }
    __syncthreads();
  }
  // 6. normalise and store
#pragma unroll
  for (int h = 0; h < PA_MAX_G; ++h) {
    if (h < g) {
      const float denom = fmaxf(l_s[h], 1e-30f);
#pragma unroll
      for (int j = 0; j < PA_MAX_DPT; ++j) {
        const int d = tid + j * PA_THREADS;
        if (d < hd) out[((size_t)b * H + kv * g + h) * hd + d] = from_f<T>(acc[h][j] / denom);
      }
    }
  }
  if (tid < g) {
    m_out[((size_t)b * KV + kv) * g + tid] = m_s[tid];
    l_out[((size_t)b * KV + kv) * g + tid] = l_s[tid];
  }
}

template <typename T>
static int launch(const void* q, const void* k_pages, const void* v_pages, const void* page_table,
                  const void* page_lengths, void* out, void* m_out, void* l_out, int B, int H,
                  int KV, int hd, int page, int N, int tile_pages, int smem_bytes,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(paged_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B, KV);
  paged_attention_kernel<T><<<grid, PA_THREADS, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const int*>(page_table), static_cast<const int*>(page_lengths),
      static_cast<T*>(out), static_cast<float*>(m_out), static_cast<float*>(l_out), H, KV, hd,
      page, N, tile_pages);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                     const void* page_table, const void* page_lengths, void* out,
                                     void* m_out, void* l_out, int B, int H, int KV, int hd,
                                     int page, int N, int tile_pages, int smem_bytes, int dtype,
                                     void* stream) {
  const int g = H / KV;
  if (g > PA_MAX_G || hd > PA_MAX_DPT * PA_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, page_lengths, out, m_out, l_out,
                                 B, H, KV, hd, page, N, tile_pages, smem_bytes, s);
  if (dtype == REPRO_F32)
    return launch<float>(q, k_pages, v_pages, page_table, page_lengths, out, m_out, l_out, B, H,
                         KV, hd, page, N, tile_pages, smem_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
