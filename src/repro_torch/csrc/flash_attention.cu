// Tiled causal GQA attention: the prefill hot path.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (pallas_call at kernel.py:107, body _kernel at :21).
//
// q (B, S, H, hd), k/v (B, S_kv, KV, hd) -> out (B, S, H, hd); query head h
// reads KV head h / (H / KV). Online softmax in fp32 with the finite -1e30
// mask; key tiles above a query tile's causal diagonal are skipped. Unlike
// the Pallas kernel (kernel.py:100) the lengths need not be multiples of the
// tile: the ragged edge is masked here, since prompt lengths are arbitrary.
//
// Two kernels, chosen by dtype (the wrapper names the route; a call the
// chosen kernel refuses raises, nothing falls back):
//
// * bf16 -> flash_attention_wgmma_kernel, the tensor-core route. Bound: at
//   the card's bf16 tensor rate, bytes below S ~ 900 (GQA 16/8 does about
//   S/3 FLOPs per byte; the card needs ~295), so the design keeps the
//   tensor cores fed and every byte read once from device memory:
//   - one block per (64-query tile, query head, batch row), the heaviest
//     causal tiles handed out first; the g query heads of a KV head are
//     neighbouring blocks and share its K/V through L2;
//   - a producer warp whose one thread brings Q and a 6-stage ring of 64-key
//     K and V tiles into shared memory by TMA (4-D tensor maps, swizzle from
//     hd * 2 bytes), completion on mbarriers; the ragged tail is zero-filled
//     by TMA and masked here;
//   - three consumer warpgroups that take the key tiles of the query tile in
//     turn, each with its own online softmax, merged through shared memory
//     at the end: the heaviest causal tile's chain of dependent key tiles is
//     cut by three, and one warpgroup's softmax overlaps another's wgmma;
//   - S = Q.K^T by wgmma m64n64k16 (bf16 in, fp32 accumulators in
//     registers, Q resident in shared memory), online softmax in registers
//     (quad shuffles over the accumulator layout), O += P.V by wgmma with P
//     in registers as the A operand and V the transposed (MN-major) B.
//   Numerics: P is rounded to bf16 before P.V (the Pallas kernel keeps it in
//   fp32, kernel.py:68-72); the row sums l are taken from the fp32 P.
// * fp32 -> flash_attention_kernel, the CUDA-core route: a tolerance of
//   3e-5 does not survive TF32 or bf16 rounding. One block per (32-query
//   tile, head, batch), a loop over 32-key tiles inside it (the TPU's
//   sequential k grid axis); tiles in fp32 shared memory, each thread a 2x4
//   block of scores and a 4x8 block of the output accumulator.
#include "common.cuh"
#include "hopper.cuh"

// ---- fp32: CUDA cores -------------------------------------------------------

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


// ---- bf16: tensor cores (wgmma + TMA) ---------------------------------------

namespace tc {
constexpr int BQ = 64;        // query rows per block (one wgmma M)
constexpr int BK = 64;        // keys per K/V tile

// HD 256 (hd 224 on zero-filled columns: Zamba2-7B's shared attention)
// holds a 64 x 256 fp32 accumulator a warpgroup: two consumer warpgroups keep
// it in registers (three would cap a thread at 152 and spill), and two
// stages of 32 KB K and V tiles fit the shared memory beside Q.
template <int HD>
struct Cfg {
  static constexpr int NWG = HD > 128 ? 2 : 3;            // consumer warpgroups, taking key tiles in turn
  static constexpr int THREADS = NWG * 128 + 32;          // consumer warpgroups, then the producer warp
  static constexpr int STAGES = HD > 128 ? 2 : 2 * NWG;   // K/V ring depth
  static constexpr int W = HD * 2 < 128 ? HD * 2 : 128;  // swizzle span (bytes of a row block)
  static constexpr int E = W / 2;                         // bf16 elements of a row block
  static constexpr int CB = HD / E;                       // row blocks of a head vector
  static constexpr int TILE = 64 * HD * 2;                // bytes of a 64-row tile
  static constexpr int LAYOUT = W == 128 ? 1 : (W == 64 ? 2 : 3);  // descriptor swizzle
  static constexpr int SMEM = (1 + 2 * STAGES) * TILE + 256 + 1024;  // Q, K and V rings, barriers, alignment
  static_assert((NWG - 1) * (HD / 2 + 4) * 128 * 4 <= 2 * STAGES * TILE, "merge area exceeds the ring");
};

// A 64-row tile lies in shared memory as CB blocks of [64 rows][W bytes],
// each swizzled by TMA. K-major operand (Q, K) at k step kk (16 columns).
template <int HD>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  using C = Cfg<HD>;
  const uint32_t off = (kk * 32 / C::W) * (64 * C::W) + (kk * 32) % C::W;
  return wgmma_desc(tile + off, 16, 8 * C::W, C::LAYOUT);
}

// V as the MN-major (transposed) B operand of P.V at k step kk (16 keys):
// leading offset = the next block of E head dims, stride = the next 8 keys.
template <int HD>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  using C = Cfg<HD>;
  return wgmma_desc(tile + kk * 16 * C::W, 64 * C::W, 8 * C::W, C::LAYOUT);
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a, uint64_t db) {
  if constexpr (HD == 256) {  // two n128 halves: head dims 128.. start two row blocks on
    wgmma_rs_n128(o, a, db);
    wgmma_rs_n128(o + 64, a, db + ((2 * 64 * Cfg<HD>::W) >> 4));
  } else if constexpr (HD == 128) wgmma_rs_n128(o, a, db);
  else if constexpr (HD == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (HD == 32) wgmma_rs_n32(o, a, db);
  else wgmma_rs_n16(o, a, db);
}

// S = Q.K^T of one K tile into sc: issued and committed, not waited for.
template <int HD>
__device__ __forceinline__ void issue_qk(float* sc, uint32_t q_tile, uint32_t k_tile) {
  fence_regs<32>(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss_n64(sc, kmajor_desc<HD>(q_tile, kk), kmajor_desc<HD>(k_tile, kk), kk);
  wgmma_commit();
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 __nv_bfloat16* __restrict__ out, int S, int S_kv, int H, int KV,
                                 int hd, int causal, float scale_log2) {
  using C = Cfg<HD>;
  constexpr int NWG = C::NWG, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023u) & ~1023u;  // swizzled tiles need 1024-byte alignment
  const uint32_t k_s = q_s + C::TILE, v_s = q_s + (1 + STAGES) * C::TILE;
  const uint32_t bar = q_s + (1 + 2 * STAGES) * C::TILE;  // q_full, kfull[], vfull[], empty[]
  const uint32_t q_full = bar;
#define KFULL(s) (bar + 8 + 8 * (s))
#define VFULL(s) (bar + 8 + 8 * STAGES + 8 * (s))
#define EMPTY(s) (bar + 8 + 16 * STAGES + 8 * (s))

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int kvh = h / (H / KV);
  const int k_end = causal ? min(S_kv, q0 + BQ) : S_kv;
  const int n_kt = (k_end + BK - 1) / BK;
  const int tid = threadIdx.x, lane = tid & 31;

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(KFULL(s), 1);
      mbar_init(VFULL(s), 1);
      mbar_init(EMPTY(s), 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NWG * 128) {  // producer warp: one thread issues every copy
    if (tid == NWG * 128) {
      mbar_expect_tx(q_full, C::TILE);
#pragma unroll
      for (int cb = 0; cb < C::CB; ++cb)
        tma_load_4d(q_s + cb * 64 * C::W, &tq, q_full, cb * C::E, h, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(EMPTY(s), (j / STAGES - 1) & 1);  // tile j - STAGES consumed
        mbar_expect_tx(KFULL(s), C::TILE);
#pragma unroll
        for (int cb = 0; cb < C::CB; ++cb)
          tma_load_4d(k_s + s * C::TILE + cb * 64 * C::W, &tk, KFULL(s), cb * C::E, kvh, j * BK, b);
        mbar_expect_tx(VFULL(s), C::TILE);
#pragma unroll
        for (int cb = 0; cb < C::CB; ++cb)
          tma_load_4d(v_s + s * C::TILE + cb * 64 * C::W, &tv, VFULL(s), cb * C::E, kvh, j * BK, b);
      }
    }
    return;
  }

  // NWG consumer warpgroups split the key tiles of the query tile between
  // them (tile j to warpgroup j % NWG), which cuts the chain of dependent
  // tiles of the heaviest causal tiles by NWG; while one warpgroup runs its
  // softmax another's wgmma keeps the tensor cores busy. Warpgroups 1.. hand
  // their (m, l, O) to warpgroup 0 through shared memory at the end.
  // A thread holds rows rA, rB = rA + 8 of the 64-row tile, in the wgmma
  // accumulator layout (register i: row (i >> 1) & 1, column
  // (i >> 2) * 8 + (lane & 3) * 2 + (i & 1)).
  const int wg = tid >> 7, t = tid & 127, wwarp = t >> 5;
  const int rA = q0 + wwarp * 16 + (lane >> 2), rB = rA + 8;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = REPRO_NEG_INF, m1 = REPRO_NEG_INF, l0 = 0.f, l1 = 0.f;
  float sc[32];
  mbar_wait(q_full, 0);

  for (int j = wg; j < n_kt; j += NWG) {
    const int s = j % STAGES;
    const uint32_t ph = (j / STAGES) & 1;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    mbar_wait(KFULL(s), ph);
    issue_qk<HD>(sc, q_s, k_s + s * C::TILE);
    wgmma_wait<0>();
    fence_regs<32>(sc);

    // mask, scale (log2 domain) and the online softmax, in registers
    const int k0 = j * BK;
    uint32_t ok = 0;
    float mx0 = REPRO_NEG_INF, mx1 = REPRO_NEG_INF;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = k0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
      const int r = (i & 2) ? rB : rA;
      const bool valid = c < S_kv && (!causal || c <= r);
      sc[i] = valid ? sc[i] * scale_log2 : REPRO_NEG_INF;
      ok |= (valid ? 1u : 0u) << i;
      if (i & 2) mx1 = fmaxf(mx1, sc[i]);
      else mx0 = fmaxf(mx0, sc[i]);
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {  // the 4 lanes of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      // masked weights are exactly 0: a fully masked row stays a finite 0
      const float p = ((ok >> i) & 1u) ? exp2f(sc[i] - ((i & 2) ? mn1 : mn0)) : 0.f;
      sc[i] = p;
      if (i & 2) ps1 += p;
      else ps0 += p;
    }
    l0 = l0 * al0 + ps0;  // per-thread partial sums; the row sum is taken at the end
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= (i & 2) ? al1 : al0;
    // P as the A operand: the accumulator layout of 16 key columns is the
    // register-A fragment layout of one k16 step
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      a[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      a[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      a[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    mbar_wait(VFULL(s), ph);
    fence_regs<HD / 2>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_pv<HD>(o, a[kk], mnmajor_desc<HD>(v_s + s * C::TILE, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<HD / 2>(o);
    mbar_arrive(EMPTY(s));
  }
#undef KFULL
#undef VFULL
#undef EMPTY

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  // warpgroups 1.. -> warpgroup 0 through the K/V ring, which no copy writes
  // any more once every warpgroup has consumed its tiles; [value][thread]
  constexpr int X = (HD / 2 + 4) * 128;  // floats a warpgroup hands over
  float* xs = reinterpret_cast<float*>(smem_raw + (k_s - raw));
  asm volatile("bar.sync 1, %0;\n" ::"n"(NWG * 128) : "memory");
  if (wg > 0) {
    float* x = xs + (wg - 1) * X + t;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) x[i * 128] = o[i];
    x[(HD / 2 + 0) * 128] = m0;
    x[(HD / 2 + 1) * 128] = m1;
    x[(HD / 2 + 2) * 128] = l0;
    x[(HD / 2 + 3) * 128] = l1;
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(NWG * 128) : "memory");
  if (wg > 0) return;
  float M0 = m0, M1 = m1;
  for (int w = 1; w < NWG; ++w) {
    M0 = fmaxf(M0, xs[(w - 1) * X + (HD / 2 + 0) * 128 + t]);
    M1 = fmaxf(M1, xs[(w - 1) * X + (HD / 2 + 1) * 128 + t]);
  }
  const float a0 = exp2f(m0 - M0), a1 = exp2f(m1 - M1);
  float L0 = a0 * l0, L1 = a1 * l1;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] *= (i & 2) ? a1 : a0;
  for (int w = 1; w < NWG; ++w) {
    const float* x = xs + (w - 1) * X + t;
    const float b0 = exp2f(x[(HD / 2 + 0) * 128] - M0), b1 = exp2f(x[(HD / 2 + 1) * 128] - M1);
    L0 += b0 * x[(HD / 2 + 2) * 128];
    L1 += b1 * x[(HD / 2 + 3) * 128];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = fmaf((i & 2) ? b1 : b0, x[i * 128], o[i]);
  }
  const float inv0 = 1.f / fmaxf(L0, 1e-30f), inv1 = 1.f / fmaxf(L1, 1e-30f);
  // columns hd .. HD - 1 (hd < HD: a head narrower than the instantiation)
  // hold zeros from the zero-filled K/V columns; only the hd are stored
#pragma unroll
  for (int jj = 0; jj < HD / 8; ++jj) {
    const int col = jj * 8 + (lane & 3) * 2;
    if (col >= hd) continue;
    if (rA < S)
      *reinterpret_cast<__nv_bfloat162*>(out + (((size_t)b * S + rA) * H + h) * hd + col) =
          __floats2bfloat162_rn(o[4 * jj] * inv0, o[4 * jj + 1] * inv0);
    if (rB < S)
      *reinterpret_cast<__nv_bfloat162*>(out + (((size_t)b * S + rB) * H + h) * hd + col) =
          __floats2bfloat162_rn(o[4 * jj + 2] * inv1, o[4 * jj + 3] * inv1);
  }
}

// Head dims below HD (hd = 112 on Cfg<128>): the tensor maps' inner dimension
// is the logical hd, so TMA zero-fills columns hd .. HD - 1 of every tile
// (the row stride hd * 2 bytes must be a multiple of 16); those columns add
// 0 to Q.K^T and give 0 in O. The scale is 1 / sqrt(hd).
template <int HD>
static int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int S_kv,
                  int H, int KV, int hd, int causal, cudaStream_t stream) {
  using C = Cfg<HD>;
  const CUtensorMapSwizzle swz = C::W == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : C::W == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tq, tk, tv;
  if (hd > HD || hd % 8 != 0 ||
      !encode_bf16_4d(&tq, q, hd, H, S, B, C::E, BQ, swz) ||
      !encode_bf16_4d(&tk, k, hd, KV, S_kv, B, C::E, BK, swz) ||
      !encode_bf16_4d(&tv, v, hd, KV, S_kv, B, C::E, BK, swz))
    return static_cast<int>(cudaErrorInvalidValue);
  static int granted = 0;
  cudaError_t err = ensure_smem(flash_attention_wgmma_kernel<HD>, C::SMEM, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, (S + BQ - 1) / BQ, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)hd);
  flash_attention_wgmma_kernel<HD><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), S, S_kv, H, KV, hd, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace tc

// ---- entry points ------------------------------------------------------------

// fp32 on the CUDA cores.
extern "C" int repro_flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                         int B, int S, int S_kv, int H, int KV, int hd, int causal,
                                         void* stream) {
  if (hd > FA_MAX_HD || hd % 16 != 0 || S <= 0 || S_kv <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (FA_BQ * (hd + 1) + FA_BK * (hd + 1) + FA_BK * hd + FA_BQ * (FA_BK + 1) +
                    3 * FA_BQ) * (int)sizeof(float);
  static int granted = 0;
  cudaError_t err = ensure_smem(flash_attention_kernel<float>, smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + FA_BQ - 1) / FA_BQ, H, B);
  flash_attention_kernel<float><<<grid, FA_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), S, S_kv, H, KV, hd, causal);
  return static_cast<int>(cudaGetLastError());
}

// bf16 on the tensor cores; hd in {16, 32, 64, 112, 128, 224} (112: the
// hybrid zamba2-7b's shared attention, on the 128 instantiation; 224:
// Zamba2-7B-Instruct's, on the 256 one).
extern "C" int repro_flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                          int B, int S, int S_kv, int H, int KV, int hd,
                                          int causal, void* stream) {
  if (S <= 0 || S_kv <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return tc::launch<16>(q, k, v, out, B, S, S_kv, H, KV, hd, causal, s);
    case 32: return tc::launch<32>(q, k, v, out, B, S, S_kv, H, KV, hd, causal, s);
    case 64: return tc::launch<64>(q, k, v, out, B, S, S_kv, H, KV, hd, causal, s);
    case 112:
    case 128: return tc::launch<128>(q, k, v, out, B, S, S_kv, H, KV, hd, causal, s);
    case 224: return tc::launch<256>(q, k, v, out, B, S, S_kv, H, KV, hd, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
