// One decode token of a Mamba2 layer for B rows, each reading and writing
// its request's conv window and SSM state in place in a slot.
//
// Replaces no Pallas kernel (the JAX package decodes Mamba2 in jnp). The
// plain version is kernels/mamba_step/ref.py; the arithmetic rounds where it
// does: the conv taps in fp32 in tap order (each product and sum rounded on
// its own), the bias, silu, rounded to bf16; softplus, the decay and the
// state update S = S dA + (dt x) B with every product and sum rounded (no
// FMA contraction), so the new state matches the plain version bit for bit
// where expf / log1pf match torch's; y = C.S + D x, the gate and the group
// norm differ from it only in the order of their sums.
//
// Bound: bytes. A row a layer reads and writes its SSM state (H x P x N
// fp32: 1.84 MB at Zamba2-7B's widths) and conv window once; the work is a
// few FLOPs a state element. Design, one launch a layer:
//   - one block per (head, row): 128 threads, warp w takes P / 4 state rows,
//     8 at a time with all 8 loads in flight, each lane N / 32 neighbouring
//     state columns (float2 loads and stores, every row read once, coalesced); the block first computes
//     the conv of its P x channels and of its group's B and C channels, and
//     writes the new window of its x channels (no other block owns them);
//   - y_p = C.S_p by a warp reduction, then D x, the gate y silu(z), kept in
//     an fp32 scratch row with the head's sum of squares;
//   - the group norm and the B/C windows need every head of a group: the
//     last block of a (row, group) to finish (an atomic ticket after a
//     fence, the counter reset by that block) sums the group's squares in
//     head order, normalises the group's channels into the output, and
//     shifts the group's B and C windows, which every block of the group
//     has read by then.
// A padded row (req -1) takes the last slot, which no request owns.
//
// Beside it, rms_norm_rows_kernel: the RMSNorm of each row, one launch.
#include "common.cuh"

constexpr int MS_THREADS = 128;
constexpr int MS_WARPS = MS_THREADS / 32;
constexpr int MS_MAX_P = 128;
constexpr int MS_MAX_W = 8;
constexpr int MS_BATCH = 8;  // state rows a warp loads before it computes any

struct StepArgs {
  const __nv_bfloat16* zxbcdt;  // (B, 2 inner + 2 G N + H): [z | x B C | dt]
  __nv_bfloat16* conv_state;    // (slots, W - 1, C)
  float* ssm_state;             // (slots, H, P, N)
  const __nv_bfloat16* conv_w;  // (C, W)
  const __nv_bfloat16* conv_b;  // (C,) or NULL
  const __nv_bfloat16* dt_bias;  // (H,)
  const __nv_bfloat16* A_log;    // (H,)
  const __nv_bfloat16* D;        // (H,)
  const __nv_bfloat16* norm_w;   // (inner,)
  const int* req;                // (B,)
  float* ybuf;                   // (B, inner) scratch: the gated y
  float* part;                   // (B, H) scratch: each head's sum of squares
  int* count;                    // (B, G) tickets, zero between launches
  __nv_bfloat16* out;            // (B, inner)
  int H, P, N, G, W, slots;
  float eps;
};

__device__ __forceinline__ float silu_f(float x) { return x / (1.f + expf(-x)); }

// The conv output of channel c of row b (its window in `win`, the new input
// in `row`), rounded to bf16 as the plain version stores it.
__device__ __forceinline__ float conv_out(const StepArgs& a, const __nv_bfloat16* win, const __nv_bfloat16* xbc,
                                          int C, int c, float* taps) {
  float acc = 0.f;
  for (int i = 0; i < a.W; ++i) {
    const float v = i < a.W - 1 ? to_f(win[(size_t)i * C + c]) : to_f(xbc[c]);
    if (taps) taps[i] = v;
    acc = __fadd_rn(acc, __fmul_rn(v, to_f(a.conv_w[(size_t)c * a.W + i])));
  }
  if (a.conv_b) acc = __fadd_rn(acc, to_f(a.conv_b[c]));
  return to_f(__float2bfloat16(silu_f(acc)));
}

template <int NPL>  // state columns a lane: N = 32 * NPL
__global__ void __launch_bounds__(MS_THREADS) mamba_step_kernel(StepArgs a) {
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int H = a.H, P = a.P, N = a.N, G = a.G;
  const int inner = H * P, C = inner + 2 * G * N, row_len = 2 * inner + 2 * G * N + H;
  const int hpg = H / G, g = h / hpg;
  const int r = a.req[b];
  const int slot = r >= 0 ? r : a.slots - 1;
  const __nv_bfloat16* zrow = a.zxbcdt + (size_t)b * row_len;
  const __nv_bfloat16* xbc = zrow + inner;
  __nv_bfloat16* win = a.conv_state + (size_t)slot * (a.W - 1) * C;

  __shared__ float xs[MS_MAX_P];       // conv'd x of the head
  __shared__ float dtx_s[MS_MAX_P];    // dt x
  __shared__ float bs[32 * NPL], cs[32 * NPL];
  __shared__ float ys[MS_MAX_P];
  __shared__ float dt_s, da_s;
  __shared__ int last_s;

  // conv of the head's x channels (their window written here) and of the
  // group's B and C channels (read only; the group's last block shifts them)
  for (int i = tid; i < P + 2 * N; i += MS_THREADS) {
    if (i < P) {
      const int c = h * P + i;
      float taps[MS_MAX_W];
      xs[i] = conv_out(a, win, xbc, C, c, taps);
      for (int j = 0; j < a.W - 1; ++j) win[(size_t)j * C + c] = __float2bfloat16(taps[j + 1]);
    } else if (i < P + N) {
      bs[i - P] = conv_out(a, win, xbc, C, inner + g * N + (i - P), nullptr);
    } else {
      cs[i - P - N] = conv_out(a, win, xbc, C, inner + G * N + g * N + (i - P - N), nullptr);
    }
  }
  if (tid == 0) {
    const float x = __fadd_rn(to_f(zrow[inner + C + h]), to_f(a.dt_bias[h]));
    const float dt = x > 20.f ? x : log1pf(expf(x));  // softplus, threshold 20
    dt_s = dt;
    da_s = expf(__fmul_rn(dt, -expf(to_f(a.A_log[h]))));
  }
  __syncthreads();
  const float dt = dt_s, dA = da_s, Dh = to_f(a.D[h]);
  for (int p = tid; p < P; p += MS_THREADS) dtx_s[p] = __fmul_rn(dt, xs[p]);
  __syncthreads();

  // the state: warp w takes rows w, w + 4, ...; lane the columns NPL * lane ..
  float* S = a.ssm_state + ((size_t)slot * H + h) * P * N;
  float bl[NPL], cl[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    bl[j] = bs[NPL * lane + j];
    cl[j] = cs[NPL * lane + j];
  }
  // MS_BATCH rows a warp at a time, all their loads issued before any use
  for (int p0 = warp; p0 < P; p0 += MS_WARPS * MS_BATCH) {
    float s[MS_BATCH][NPL], acc[MS_BATCH];
#pragma unroll
    for (int u = 0; u < MS_BATCH; ++u) {
      const int p = p0 + u * MS_WARPS;
      if (p >= P) continue;
      const float* sp = S + (size_t)p * N + NPL * lane;
      if constexpr (NPL == 2) {
        const float2 v = *reinterpret_cast<const float2*>(sp);
        s[u][0] = v.x;
        s[u][1] = v.y;
      } else {
#pragma unroll
        for (int j = 0; j < NPL; ++j) s[u][j] = sp[j];
      }
    }
#pragma unroll
    for (int u = 0; u < MS_BATCH; ++u) {
      const int p = p0 + u * MS_WARPS;
      acc[u] = 0.f;
      if (p >= P) continue;
      float* sp = S + (size_t)p * N + NPL * lane;
      const float dtx = dtx_s[p];
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        s[u][j] = __fadd_rn(__fmul_rn(s[u][j], dA), __fmul_rn(dtx, bl[j]));
        acc[u] = __fadd_rn(acc[u], __fmul_rn(s[u][j], cl[j]));
      }
      if constexpr (NPL == 2) {
        *reinterpret_cast<float2*>(sp) = make_float2(s[u][0], s[u][1]);
      } else {
#pragma unroll
        for (int j = 0; j < NPL; ++j) sp[j] = s[u][j];
      }
    }
#pragma unroll
    for (int u = 0; u < MS_BATCH; ++u) {
      const int p = p0 + u * MS_WARPS;
      const float sum = warp_sum(acc[u]);  // every lane takes part, p < P or not
      if (lane == 0 && p < P) {
        const float y = __fadd_rn(sum, __fmul_rn(Dh, xs[p]));
        ys[p] = __fmul_rn(y, silu_f(to_f(zrow[h * P + p])));
      }
    }
  }
  __syncthreads();
  for (int p = tid; p < P; p += MS_THREADS) a.ybuf[(size_t)b * inner + h * P + p] = ys[p];
  if (tid == 0) {
    float ss = 0.f;
    for (int p = 0; p < P; ++p) ss = __fadd_rn(ss, __fmul_rn(ys[p], ys[p]));
    a.part[(size_t)b * H + h] = ss;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(a.count + b * G + g, 1) == hpg - 1;
  __syncthreads();
  if (!last_s) return;

  // the group's last block: every head of (b, g) has written ybuf and part,
  // and has read the group's B and C windows
  __threadfence();
  __shared__ float rs_s;
  if (tid == 0) {
    float ss = 0.f;
    for (int k = 0; k < hpg; ++k) ss = __fadd_rn(ss, __ldcg(a.part + (size_t)b * H + g * hpg + k));
    const int width = inner / G;
    rs_s = rsqrtf(__fadd_rn(ss / (float)width, a.eps));
    a.count[b * G + g] = 0;
  }
  __syncthreads();
  const float rs = rs_s;
  const int width = inner / G, c0 = g * width;
  for (int c = c0 + tid; c < c0 + width; c += MS_THREADS) {
    const float y = __ldcg(a.ybuf + (size_t)b * inner + c);
    a.out[(size_t)b * inner + c] = __float2bfloat16(__fmul_rn(__fmul_rn(y, rs), to_f(a.norm_w[c])));
  }
  for (int i = tid; i < 2 * N; i += MS_THREADS) {
    const int c = i < N ? inner + g * N + i : inner + G * N + g * N + (i - N);
    float taps[MS_MAX_W];
    for (int j = 0; j < a.W; ++j) taps[j] = j < a.W - 1 ? to_f(win[(size_t)j * C + c]) : to_f(xbc[c]);
    for (int j = 0; j < a.W - 1; ++j) win[(size_t)j * C + c] = __float2bfloat16(taps[j + 1]);
  }
}

// RMSNorm of each row of x (rows, d) bf16: (x * rsqrt(mean(x^2) + eps)) * g,
// each product rounded to fp32 as the plain recipe (models/layers.py::rmsnorm)
// rounds it, then to bf16; the squares summed in another order (a block
// reduction), so within a bf16 ulp of it. One block a row, 16-byte loads. The
// decode step's norms of the "zamba2" family (one launch for ~8 eager ops).
constexpr int RN_THREADS = 256;

__global__ void __launch_bounds__(RN_THREADS)
    rms_norm_rows_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                         __nv_bfloat16* __restrict__ out, int d, float eps) {
  const __nv_bfloat16* row = x + (size_t)blockIdx.x * d;
  __nv_bfloat16* dst = out + (size_t)blockIdx.x * d;
  __shared__ float part[RN_THREADS / 32];
  __shared__ float rs_s;
  float ss = 0.f;
  for (int c = 8 * threadIdx.x; c < d; c += 8 * RN_THREADS) {
    float f[8];
    load16_f32(row + c, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) ss = __fadd_rn(ss, __fmul_rn(f[e], f[e]));
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < RN_THREADS / 32; ++w) t += part[w];
    rs_s = rsqrtf(__fadd_rn(t / (float)d, eps));
  }
  __syncthreads();
  const float rs = rs_s;
  for (int c = 8 * threadIdx.x; c < d; c += 8 * RN_THREADS) {
    float f[8], w[8];
    load16_f32(row + c, f);
    load16_f32(g + c, w);
    uint4 packed;
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(__fmul_rn(__fmul_rn(f[e], rs), w[e]));
    *reinterpret_cast<uint4*>(dst + c) = packed;
  }
}

extern "C" int repro_rms_norm_rows(const void* x, const void* g, void* out, int rows, int d, float eps,
                                   void* stream) {
  if (rows <= 0 || d <= 0 || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  rms_norm_rows_kernel<<<rows, RN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
      static_cast<__nv_bfloat16*>(out), d, eps);
  return static_cast<int>(cudaGetLastError());
}

// bf16 only. N must be 32, 64 or 128; P at most 128; W at most 8; H a
// multiple of G. `count` holds B x G zeros and is left so.
extern "C" int repro_mamba_step(const void* zxbcdt, void* conv_state, void* ssm_state, const void* conv_w,
                                const void* conv_b, const void* dt_bias, const void* A_log, const void* D,
                                const void* norm_w, const void* req, void* ybuf, void* part, void* count,
                                void* out, int B, int H, int P, int N, int G, int W, int slots, float eps,
                                void* stream) {
  if (B <= 0 || G <= 0 || H % G != 0 || P > MS_MAX_P || W < 2 || W > MS_MAX_W || slots < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  StepArgs a{static_cast<const __nv_bfloat16*>(zxbcdt), static_cast<__nv_bfloat16*>(conv_state),
             static_cast<float*>(ssm_state), static_cast<const __nv_bfloat16*>(conv_w),
             static_cast<const __nv_bfloat16*>(conv_b), static_cast<const __nv_bfloat16*>(dt_bias),
             static_cast<const __nv_bfloat16*>(A_log), static_cast<const __nv_bfloat16*>(D),
             static_cast<const __nv_bfloat16*>(norm_w), static_cast<const int*>(req), static_cast<float*>(ybuf),
             static_cast<float*>(part), static_cast<int*>(count), static_cast<__nv_bfloat16*>(out),
             H, P, N, G, W, slots, eps};
  dim3 grid(H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 32: mamba_step_kernel<1><<<grid, MS_THREADS, 0, st>>>(a); break;
    case 64: mamba_step_kernel<2><<<grid, MS_THREADS, 0, st>>>(a); break;
    case 128: mamba_step_kernel<4><<<grid, MS_THREADS, 0, st>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
