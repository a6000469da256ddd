// Tiled causal GQA attention: the prefill hot path.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (pallas_call at kernel.py:107, body _kernel at :21).
//
// q (B, S, H, hd), k/v (B, S_kv, KV, hd) -> out (B, S, H, hd); query head h
// reads KV head h / (H / KV). Online softmax in fp32; key tiles above a
// query tile's causal diagonal are skipped. Unlike the Pallas kernel
// (kernel.py:100) the lengths need not be multiples of the tile: the ragged
// edge is masked here, since prompt lengths are arbitrary.
//
// Bound: at the card's bf16 tensor rate, bytes below S ~ 900 (GQA 16/8
// does about S/3 FLOPs per byte moved; the card needs ~295). This kernel
// runs on the fp32 CUDA cores (67 TFLOP/s), which bound it in practice.
// Design: one block per
// (32-query tile, head, batch), a loop over 32-key tiles inside it (the
// TPU's sequential k grid axis). Q, K and V tiles are widened to fp32 in
// shared memory; each thread computes a 2x4 block of scores and owns a 4x8
// block of the output accumulator, so every shared-memory value it loads
// feeds several FMAs. A tensor-core (wgmma/TMA) version is later work.
#include "common.cuh"

constexpr int FA_THREADS = 128;
constexpr int FA_BQ = 32;  // query rows per block
constexpr int FA_BK = 32;  // keys per tile (= warp size: one key per lane in the softmax)
constexpr int FA_MAX_HD = 128;
constexpr int FA_DPT = FA_MAX_HD / 16;  // accumulator columns per thread

template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int S, int S_kv, int H,
                           int KV, int hd, int causal) {
  const int q0 = blockIdx.x * FA_BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = hd + 1;         // padded rows: conflict-free column walks
  constexpr int SLD = FA_BK + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                 // BQ * ld
  float* k_s = q_s + FA_BQ * ld;     // BK * ld
  float* v_s = k_s + FA_BK * ld;     // BK * hd
  float* s_s = v_s + FA_BK * hd;     // BQ * SLD: scores, then weights
  float* m_s = s_s + FA_BQ * SLD;    // BQ
  float* l_s = m_s + FA_BQ;          // BQ
  float* a_s = l_s + FA_BQ;          // BQ: rescale factor of this tile
  constexpr int VEC = 16 / (int)sizeof(T);
  const int vpr = hd / VEC;
  const float rsq = sqrtf((float)hd);

  for (int i = tid; i < FA_BQ * vpr; i += FA_THREADS) {
    const int r = i / vpr, c = (i % vpr) * VEC;
    float f[VEC];
    if (q0 + r < S) {
      load16_f32(q + (((size_t)b * S + q0 + r) * H + h) * hd + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) q_s[r * ld + c + e] = f[e];
  }
  if (tid < FA_BQ) {
    m_s[tid] = REPRO_NEG_INF;
    l_s[tid] = 0.f;
  }
  // score block: rows sr0 + {0,1}, keys sc0 + {0..3}
  const int sr0 = (tid >> 3) * 2, sc0 = (tid & 7) * 4;
  // accumulator block: rows r0 + {0..3}, head dims dc + 16 * j
  const int r0 = (tid >> 4) * 4, dc = tid & 15;
  float acc[4][FA_DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < FA_DPT; ++j) acc[i][j] = 0.f;

  // keys past the tile's last query row are masked for every row (causal)
  const int k_end = causal ? min(S_kv, q0 + FA_BQ) : S_kv;
  for (int k0 = 0; k0 < k_end; k0 += FA_BK) {
    __syncthreads();  // previous tile fully consumed (and q_s / m_s written)
    for (int i = tid; i < FA_BK * vpr; i += FA_THREADS) {
      const int r = i / vpr, c = (i % vpr) * VEC;
      float kf[VEC], vf[VEC];
      if (k0 + r < S_kv) {
        const size_t off = (((size_t)b * S_kv + k0 + r) * KV + kvh) * hd + c;
        load16_f32(k + off, kf);
        load16_f32(v + off, vf);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        k_s[r * ld + c + e] = kf[e];
        v_s[r * hd + c + e] = vf[e];
      }
    }
    __syncthreads();
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qa[2], kb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) qa[i] = q_s[(sr0 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = k_s[(sc0 + j) * ld + d];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q0 + sr0 + i, kj = k0 + sc0 + j;
        const bool ok = kj < S_kv && (!causal || kj <= qi);
        s_s[(sr0 + i) * SLD + sc0 + j] = ok ? s[i][j] / rsq : REPRO_NEG_INF;
      }
    __syncthreads();
    // online softmax: each warp takes 8 rows, one key per lane
    for (int rr = 0; rr < FA_BQ / 4; ++rr) {
      const int r = warp * (FA_BQ / 4) + rr;
      const int qi = q0 + r, kj = k0 + lane;
      const bool ok = kj < S_kv && (!causal || kj <= qi);
      const float sv = s_s[r * SLD + lane];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(sv));
      const float p = ok ? expf(sv - m_new) : 0.f;
      s_s[r * SLD + lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[r0 + i];
#pragma unroll
      for (int j = 0; j < FA_DPT; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < FA_BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_s[(r0 + i) * SLD + c];
#pragma unroll
      for (int j = 0; j < FA_DPT; ++j) {
        if (dc + 16 * j < hd) {
          const float vv = v_s[c * hd + dc + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + i;
    if (q0 + r < S) {
      const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < FA_DPT; ++j) {
        const int d = dc + 16 * j;
        if (d < hd) out[(((size_t)b * S + q0 + r) * H + h) * hd + d] = from_f<T>(acc[i][j] / denom);
      }
    }
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int S_kv,
                  int H, int KV, int hd, int causal, cudaStream_t stream) {
  const int smem = (FA_BQ * (hd + 1) + FA_BK * (hd + 1) + FA_BK * hd + FA_BQ * (FA_BK + 1) +
                    3 * FA_BQ) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + FA_BQ - 1) / FA_BQ, H, B);
  flash_attention_kernel<T><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, S_kv, H, KV, hd, causal);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                                     int S, int S_kv, int H, int KV, int hd, int causal, int dtype,
                                     void* stream) {
  if (hd > FA_MAX_HD || hd % 16 != 0 || S <= 0 || S_kv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(q, k, v, out, B, S, S_kv, H, KV, hd, causal, s);
  if (dtype == REPRO_F32) return launch<float>(q, k, v, out, B, S, S_kv, H, KV, hd, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
