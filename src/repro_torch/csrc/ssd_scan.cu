// The chunked SSD scan of a Mamba2 layer's prefill: y and the final state
// of every head over a whole sequence, from a zero state.
//
// Replaces no Pallas kernel (the JAX package scans in jnp). The plain
// version is kernels/ssd_scan/ref.py (models/mamba2.py::ssd_chunked and the
// D x term): per head h of group g, cum the inclusive cumulative log decay
// within each chunk of C positions,
//   y_i = sum_{j <= i in i's chunk} exp(cum_i - cum_j) (C_i . B_j) dt_j x_j
//         + exp(cum_i) C_i . S_entering + D_h x_i,
//   S_end = exp(cum_last) S_entering + sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j,
// the same sums in fp32 in another order (FMA contraction allowed).
//
// Bound: operations (fp32 on the CUDA cores); the eager version writes and
// reads a C x C fp32 decay tile a head a chunk several times over. Design:
//   - one block per (head, row), 256 threads; the chunks in order, the state
//     entering a chunk in shared memory ([n][p]);
//   - a chunk in tiles of 64 positions: for each row tile, the inter-chunk
//     term from the state, then for each column tile up to the diagonal the
//     64 x 64 weights W = (C B^T) masked and decayed (a 4 x 4 block a
//     thread), kept in shared memory, and y += W (dt x); then the row tile's
//     share of the state at the chunk's end;
//   - B and C read from the conv's bf16 output, widened once a tile; C and
//     the column tile's B stored transposed so each thread's 4 x 4 block
//     takes two float4 loads a term.
// P and N are 64; C a multiple of 64.
#include "common.cuh"

constexpr int SS_T = 64;  // tile positions, and P and N
constexpr int SS_THREADS = 256;
constexpr int SS_SMEM = (6 * SS_T * SS_T + 2 * SS_T) * (int)sizeof(float);

struct ScanArgs {
  const __nv_bfloat16* xbc;  // (B, S, ld): x (H x P) | B (G x N) | C (G x N)
  const float* dt;           // (B, S, H), after the softplus
  const float* cum;          // (B, S_pad, H): cumulative log decay within each chunk
  const __nv_bfloat16* D;    // (H,)
  float* y;                  // (B, S, H x P)
  float* state;              // (B, H, P, N)
  int S, S_pad, H, G, ld, chunk;
};

__global__ void __launch_bounds__(SS_THREADS) ssd_scan_kernel(ScanArgs a) {
  extern __shared__ float4 ss_smem4[];
  float* smem = reinterpret_cast<float*>(ss_smem4);
  float* sCt = smem;                   // [n][i]: C of the row tile
  float* sBt = sCt + SS_T * SS_T;      // [n][j]: B of the column tile
  float* sB = sBt + SS_T * SS_T;       // [j][n]: B of the row tile (the state's share)
  float* sX = sB + SS_T * SS_T;        // [j][p]: dt x of the column tile
  float* sW = sX + SS_T * SS_T;        // [i][j]: the weights of a tile pair
  float* sSt = sW + SS_T * SS_T;       // [n][p]: the state entering the chunk
  float* sCumI = sSt + SS_T * SS_T;
  float* sCumJ = sCumI + SS_T;

  const int h = blockIdx.x, b = blockIdx.y;
  const int H = a.H, S = a.S;
  const int g = h / (H / a.G);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t row0 = (size_t)b * S;  // this row's first position in xbc, dt, y
  const int xcol = h * SS_T, bcol = H * SS_T + g * SS_T, ccol = H * SS_T + a.G * SS_T + g * SS_T;
  const float Dh = __bfloat162float(a.D[h]);

  for (int e = tid; e < SS_T * SS_T; e += SS_THREADS) sSt[e] = 0.f;

  // 8 bf16 of position `pos` from column `col` (zeros past the sequence)
  auto load8 = [&](int pos, int col, float* dst) {
    if (pos < S) {
      load16_f32(a.xbc + (row0 + pos) * a.ld + col, dst);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) dst[k] = 0.f;
    }
  };

  for (int c0 = 0; c0 < a.S_pad; c0 += a.chunk) {
    const float total = a.cum[((size_t)b * a.S_pad + c0 + a.chunk - 1) * H + h];
    float ns[4][4] = {};  // this chunk's share of the new state: p = ty*4 + r, n = tx*4 + c
    for (int i0 = c0; i0 < c0 + a.chunk; i0 += SS_T) {
      __syncthreads();  // the previous tile's readers are done
      for (int e = tid; e < SS_T * 8; e += SS_THREADS) {
        float v[8];
        const int i = e & (SS_T - 1), n8 = (e >> 6) * 8;  // transposed: positions across the lanes
        load8(i0 + i, ccol + n8, v);
#pragma unroll
        for (int k = 0; k < 8; ++k) sCt[(n8 + k) * SS_T + i] = v[k];
        const int i2 = e >> 3, m8 = (e & 7) * 8;  // as laid out: columns across the lanes
        load8(i0 + i2, bcol + m8, v);
        *reinterpret_cast<float4*>(sB + i2 * SS_T + m8) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(sB + i2 * SS_T + m8 + 4) = make_float4(v[4], v[5], v[6], v[7]);
      }
      if (tid < SS_T) sCumI[tid] = a.cum[((size_t)b * a.S_pad + i0 + tid) * H + h];
      __syncthreads();

      // the state's share: acc[i][p] = exp(cum_i) C_i . S_p
      float acc[4][4] = {};
#pragma unroll 8
      for (int n = 0; n < SS_T; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(sCt + n * SS_T + ty * 4);
        const float4 sv = *reinterpret_cast<const float4*>(sSt + n * SS_T + tx * 4);
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w}, sc[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cr[r], sc[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float d = expf(sCumI[ty * 4 + r]);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= d;
      }

      for (int j0 = c0; j0 <= i0; j0 += SS_T) {
        __syncthreads();  // sBt, sX and sW free
        for (int e = tid; e < SS_T * 8; e += SS_THREADS) {
          float v[8];
          const int j = e & (SS_T - 1), k8 = (e >> 6) * 8;
          load8(j0 + j, bcol + k8, v);
#pragma unroll
          for (int k = 0; k < 8; ++k) sBt[(k8 + k) * SS_T + j] = v[k];
          const int j2 = e >> 3, m8 = (e & 7) * 8;
          load8(j0 + j2, xcol + m8, v);
          const float dtj = j0 + j2 < S ? a.dt[(row0 + j0 + j2) * H + h] : 0.f;
          *reinterpret_cast<float4*>(sX + j2 * SS_T + m8) =
              make_float4(dtj * v[0], dtj * v[1], dtj * v[2], dtj * v[3]);
          *reinterpret_cast<float4*>(sX + j2 * SS_T + m8 + 4) =
              make_float4(dtj * v[4], dtj * v[5], dtj * v[6], dtj * v[7]);
        }
        if (tid < SS_T) sCumJ[tid] = a.cum[((size_t)b * a.S_pad + j0 + tid) * H + h];
        __syncthreads();

        // W[i][j] = exp(cum_i - cum_j) C_i . B_j for j <= i, else 0: i = ty*4 + r, j = tx*4 + c
        float w[4][4] = {};
#pragma unroll 8
        for (int n = 0; n < SS_T; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(sCt + n * SS_T + ty * 4);
          const float4 bv = *reinterpret_cast<const float4*>(sBt + n * SS_T + tx * 4);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w}, bc[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) w[r][c] = fmaf(cr[r], bc[c], w[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ty * 4 + r;
          float4 out;
          float* o = reinterpret_cast<float*>(&out);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = tx * 4 + c;
            o[c] = j0 + j <= i0 + i ? w[r][c] * expf(sCumI[i] - sCumJ[j]) : 0.f;
          }
          *reinterpret_cast<float4*>(sW + i * SS_T + tx * 4) = out;
        }
        __syncthreads();

        // acc[i][p] += sum_j W[i][j] (dt x)_j[p]: p = tx*4 + c
#pragma unroll 2
        for (int j = 0; j < SS_T; j += 4) {
          float wr[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 v = *reinterpret_cast<const float4*>(sW + (ty * 4 + r) * SS_T + j);
            wr[r][0] = v.x; wr[r][1] = v.y; wr[r][2] = v.z; wr[r][3] = v.w;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float4 xv = *reinterpret_cast<const float4*>(sX + (j + k) * SS_T + tx * 4);
            const float xc[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(wr[r][k], xc[c], acc[r][c]);
          }
        }
      }

      // y = acc + D x (the last column tile was the diagonal: sX holds dt x of these rows)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        if (i < S) {
          const __nv_bfloat16* xr = a.xbc + (row0 + i) * a.ld + xcol + tx * 4;
          float4 out;
          out.x = fmaf(Dh, __bfloat162float(xr[0]), acc[r][0]);
          out.y = fmaf(Dh, __bfloat162float(xr[1]), acc[r][1]);
          out.z = fmaf(Dh, __bfloat162float(xr[2]), acc[r][2]);
          out.w = fmaf(Dh, __bfloat162float(xr[3]), acc[r][3]);
          *reinterpret_cast<float4*>(a.y + (row0 + i) * (size_t)(H * SS_T) + xcol + tx * 4) = out;
        }
      }

      // the row tile's share of the state at the chunk's end: p = ty*4 + r, n = tx*4 + c
#pragma unroll 4
      for (int j = 0; j < SS_T; ++j) {
        const float u = expf(total - sCumI[j]);
        const float4 xv = *reinterpret_cast<const float4*>(sX + j * SS_T + ty * 4);
        const float4 bv = *reinterpret_cast<const float4*>(sB + j * SS_T + tx * 4);
        const float xr[4] = {u * xv.x, u * xv.y, u * xv.z, u * xv.w}, bc[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) ns[r][c] = fmaf(xr[r], bc[c], ns[r][c]);
      }
    }
    __syncthreads();  // every reader of the entering state is done
    const float carry = expf(total);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float* s = sSt + (tx * 4 + c) * SS_T + ty * 4 + r;
        *s = fmaf(*s, carry, ns[r][c]);
      }
  }
  __syncthreads();
  float* out = a.state + ((size_t)b * H + h) * SS_T * SS_T;
  for (int e = tid; e < SS_T * SS_T; e += SS_THREADS) out[e] = sSt[(e & (SS_T - 1)) * SS_T + (e >> 6)];
}

// bf16 xbc, fp32 dt / cum / y / state. P = N = 64; chunk a multiple of 64
// dividing S_pad; ld a multiple of 8.
extern "C" int repro_ssd_scan(const void* xbc, const void* dt, const void* cum, const void* D, void* y, void* state,
                              int B, int S, int S_pad, int H, int G, int P, int N, int ld, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0 || P != SS_T || N != SS_T || chunk <= 0 || chunk % SS_T != 0 ||
      S_pad % chunk != 0 || S_pad < S || ld % 8 != 0 || ld < H * P + 2 * G * N)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SS_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  ScanArgs a{static_cast<const __nv_bfloat16*>(xbc), static_cast<const float*>(dt), static_cast<const float*>(cum),
             static_cast<const __nv_bfloat16*>(D), static_cast<float*>(y), static_cast<float*>(state),
             S, S_pad, H, G, ld, chunk};
  ssd_scan_kernel<<<dim3(H, B), SS_THREADS, SS_SMEM, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
