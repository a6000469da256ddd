// KV write-log append (the decode write path), with the K/V epilogue of the
// decode step fused in front of it.
//
// Replaces src/repro/kernels/kv_log_append/kernel.py::kv_log_append_pallas
// (pallas_call at kernel.py:45, body _kernel at :20), and on the decode path
// also the eager ops between the q/k/v matmuls and the append
// (models/layers.py::qkv_epilogue: bias, qk-norm, RoPE; the casts and copies
// of core/tiering.py).
//
// In place, store B new K/V rows at `tail` in the log ring and write the
// (request, position) meta rows. With the epilogue (one layer, L = 1), the
// rows are the raw projections x @ wq, x @ wk, x @ wv: add the bias, apply
// qk-norm and RoPE, write q as (B, H, hd) for the paged attention kernel and
// store the finished k and v rows in the log. Without it (the standalone
// append, L layers), the rows are copied bit for bit.
//
// Bound: a decode step's layer moves ~64 KB, so the kernel costs about one
// launch; its gain is the ~57 eager ops a layer it replaces. Design: one
// group of `lanes` = min(hd, 32) lanes per head row (q heads, then k heads,
// then v heads, of each batch row), N = hd / lanes elements a lane. The
// arithmetic repeats the plain recipe's rounding points: the bias add,
// rmsnorm and RoPE round to the storage type where the eager ops do, every
// fp32 product and sum is rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn: no FMA contraction), cosf/sinf of one fp32 product pos * freq,
// rsqrtf as torch's CUDA rsqrt. The rmsnorm's sum of squares is added in
// the order of torch's CUDA reduction of a contiguous row of hd <= 128
// floats (ATen Reduce.cuh): a row of 128 is read as float4 vectors, one a
// thread, each summed in turn, then the 32 partial sums are halved down
// (offsets 16, 8, ..., 1); a shorter row is halved down directly. So a lane
// holds elements 4t..4t+3 for hd = 128 and t + 32j otherwise, and the
// kernel matches the plain version bit for bit where torch sums that way;
// the stated tolerance is 1 ulp of the storage type. A RoPE pair (e,
// e + hd/2) sits in one lane for hd = 64 and in lanes t, t ^ lanes/2
// otherwise. Without the epilogue (the standalone append) rows are copied
// as 16-byte vectors. The tail is a host integer the engine already knows;
// the wrappers check that tail + B <= S.
#include "common.cuh"

struct AppendArgs {
  void* log_k;  // (L, S, nkv, seg) ring buffers
  void* log_v;
  int* meta;  // (S, 2) int32
  void* q_out;  // (L, B, nq, seg)
  const void* q_in;  // (L, B, nq, seg); nq = 0 for the standalone append
  const void* k_in;  // (L, B, nkv, seg)
  const void* v_in;
  const void* bq;  // optional biases (nq * seg,), (nkv * seg,)
  const void* bk;
  const void* bv;
  const void* q_gain;  // optional qk-norm gains (seg,)
  const void* k_gain;
  const float* freqs;  // RoPE frequencies (seg / 2,); NULL: no epilogue (copies)
  const int* positions;  // (B,) RoPE positions
  const int* req_ids;  // (B,) meta column 0
  const int* meta_pos;  // (B,) meta column 1
  int L, S, B, nq, nkv, seg, tail;
  float eps;
};

// fp32 -> storage type -> fp32: where an eager op would write its result.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// N = hd / lanes elements a lane with the epilogue; N = 0: copies only.
template <typename T, int N>
__global__ void __launch_bounds__(128) kv_log_append_kernel(AppendArgs a) {
  constexpr int COPY_LANES = 128;  // one 16-byte vector a thread for a 2 KB row
  const int lanes = N == 0 ? COPY_LANES : a.seg / N;
  const int per_row = a.nq + 2 * a.nkv;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int unit = gid / lanes, t = gid % lanes;
  if (unit >= a.L * a.B * per_row) return;  // whole groups: lanes divides 32 where they talk
  const int h = unit % per_row, row = unit / per_row;  // row = l * B + b
  const int b = row % a.B, l = row / a.B;

  const T* src;
  T* dst;
  const T* bias = nullptr;
  const T* gain = nullptr;
  bool rope = N > 0;
  if (h < a.nq) {
    const size_t off = ((size_t)row * a.nq + h) * a.seg;
    src = static_cast<const T*>(a.q_in) + off;
    dst = static_cast<T*>(a.q_out) + off;
    if (a.bq) bias = static_cast<const T*>(a.bq) + (size_t)h * a.seg;
    gain = static_cast<const T*>(a.q_gain);
  } else {
    const bool is_k = h < a.nq + a.nkv;
    const int kh = h - a.nq - (is_k ? 0 : a.nkv);
    src = static_cast<const T*>(is_k ? a.k_in : a.v_in) + ((size_t)row * a.nkv + kh) * a.seg;
    dst = static_cast<T*>(is_k ? a.log_k : a.log_v) +
          (((size_t)l * a.S + a.tail + b) * a.nkv + kh) * a.seg;
    const void* bb = is_k ? a.bk : a.bv;
    if (bb) bias = static_cast<const T*>(bb) + (size_t)kh * a.seg;
    if (is_k) gain = static_cast<const T*>(a.k_gain);
    rope = rope && is_k;
  }
  if (l == 0 && h == 0 && t == 0) {
    a.meta[2 * (a.tail + b)] = a.req_ids[b];
    a.meta[2 * (a.tail + b) + 1] = a.meta_pos[b];
  }
  if constexpr (N == 0) {  // the standalone append: the row bit for bit
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int j = t; j < a.seg * (int)sizeof(T) / 16; j += lanes) d4[j] = s4[j];
  } else {
    int e[N];  // this lane's elements of the row
#pragma unroll
    for (int j = 0; j < N; ++j) e[j] = N == 4 ? 4 * t + j : t + lanes * j;
    // every load first: the row, its bias and gain, positions and freqs
    float x[N], bx[N], g[N], f[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      x[j] = to_f(src[e[j]]);
      bx[j] = bias ? to_f(bias[e[j]]) : 0.f;
      g[j] = gain ? to_f(gain[e[j]]) : 0.f;
      f[j] = a.freqs[e[j] % (a.seg / 2)];
    }
    const float pos = (float)a.positions[b];
    const int lane = threadIdx.x & 31;
    const unsigned mask = lanes == 32 ? 0xffffffffu : ((1u << lanes) - 1) << (lane & ~(lanes - 1));
    if (bias) {  // q + bq in the storage type
#pragma unroll
      for (int j = 0; j < N; ++j) x[j] = round_to<T>(__fadd_rn(x[j], bx[j]));
    }
    if (gain) {  // rmsnorm: (x * rsqrt(mean(x*x) + eps)) * gain, rounded
      float ss = __fmul_rn(x[0], x[0]);
#pragma unroll
      for (int j = 1; j < N; ++j) ss = __fadd_rn(ss, __fmul_rn(x[j], x[j]));
      for (int o = lanes / 2; o > 0; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(mask, ss, o));
      const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.0f / (float)a.seg), a.eps));
#pragma unroll
      for (int j = 0; j < N; ++j) x[j] = round_to<T>(__fmul_rn(__fmul_rn(x[j], r), g[j]));
    }
    if (rope) {  // [x1*cos - x2*sin, x2*cos + x1*sin] on the halves of the row
      float y[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float p = N == 2 ? x[1 - j] : __shfl_xor_sync(mask, x[j], lanes / 2);
        const float ang = __fmul_rn(pos, f[j]);
        const float c = cosf(ang), s = sinf(ang);
        y[j] = e[j] < a.seg / 2 ? __fsub_rn(__fmul_rn(x[j], c), __fmul_rn(p, s))
                                : __fadd_rn(__fmul_rn(x[j], c), __fmul_rn(p, s));
      }
#pragma unroll
      for (int j = 0; j < N; ++j) x[j] = y[j];
    }
#pragma unroll
    for (int j = 0; j < N; ++j) dst[e[j]] = from_f<T>(x[j]);
  }
}

template <typename T>
static cudaError_t launch(const AppendArgs& a, int n, unsigned grid, cudaStream_t st) {
  switch (n) {
    case 0: kv_log_append_kernel<T, 0><<<grid, 128, 0, st>>>(a); break;
    case 1: kv_log_append_kernel<T, 1><<<grid, 128, 0, st>>>(a); break;
    case 2: kv_log_append_kernel<T, 2><<<grid, 128, 0, st>>>(a); break;
    case 4: kv_log_append_kernel<T, 4><<<grid, 128, 0, st>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// freqs NULL: the standalone append (no epilogue; q_in, q_out, biases and
// gains unused). Otherwise seg = hd must be 8, 16, 32, 64 or 128.
extern "C" int repro_kv_log_append(void* log_k, void* log_v, void* log_meta, void* q_out,
                                   const void* q_in, const void* k_in, const void* v_in,
                                   const void* bq, const void* bk, const void* bv,
                                   const void* q_gain, const void* k_gain, const void* freqs,
                                   const void* positions, const void* req_ids, const void* meta_pos,
                                   int dtype, int L, int S, int B, int nq, int nkv, int seg,
                                   int tail, float eps, void* stream) {
  AppendArgs a{log_k, log_v, static_cast<int*>(log_meta), q_out, q_in, k_in, v_in, bq, bk, bv,
               q_gain, k_gain, static_cast<const float*>(freqs), static_cast<const int*>(positions),
               static_cast<const int*>(req_ids), static_cast<const int*>(meta_pos),
               L, S, B, nq, nkv, seg, tail, eps};
  const int lanes = freqs ? (seg < 32 ? seg : 32) : 128;
  const int n = freqs ? seg / lanes : 0;
  const long threads = (long)L * B * (nq + 2 * nkv) * lanes;
  const unsigned grid = (unsigned)((threads + 127) / 128);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16) return static_cast<int>(launch<__nv_bfloat16>(a, n, grid, st));
  if (dtype == REPRO_F32) return static_cast<int>(launch<float>(a, n, grid, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
