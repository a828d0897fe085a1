// Blocked online-softmax attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_2d` of the JAX reference
// (src/repro/kernels/flash_attention/kernel.py), and its vmap over
// (batch, head) in ops.py: one launch covers every (batch, query head) and
// every query block.  Per query row i and key row j (both counted from 0):
//   s    = (q_i . k_j) * scale                   fp32 products and sums
//   s    = softcap * tanh(s / softcap)           if softcap is set
//   keep = j < Sk && (!causal || i >= j) && (!window || i - j < window)
//   out  = sum_j p_ij v_j / sum_j p_ij,  p = exp(s - running max) on kept j
// with the reference's rules: a row with no kept key outputs 0 (l == 0),
// in bf16 p is rounded to bf16 before the p.v product (the normaliser sums
// the unrounded p), and the output is rounded to q's type.  Query head h
// reads kv head h / (Hq / Hkv) (GQA and MQA) without a materialised repeat.
//
// What bounds it: operations.  4*Sq*Sk*D/2 FLOP per head under a causal
// mask against 2*(Sq+2*Sk)*D bytes: at D = 128 and S = 4096 that is about
// 1,000 FLOP per byte, above the H100's ~295 FLOP/byte ridge in bf16.  This
// first kernel is simple and exact rather than fast: plain fp32 FMA on CUDA
// cores (the f32 path must not round through TF32), no tensor cores, no TMA.
// Its design:
//   * one CTA of 256 threads per (batch*head, block of 64 query rows), the
//     Pallas grid's sequential key axis becoming a loop inside the CTA;
//   * the Q block and one K and one V tile (BK = 64 keys up to D = 64,
//     32 above) staged in shared memory as fp32, zero-padded to the head
//     width DP (32, 64, 128, 192 or 256) and to whole tiles, with one
//     float of row padding against bank conflicts;
//   * S = Q K^T for the tile in a 4 x (BK/16) register micro-tile per
//     thread, scaled, soft-capped and masked there, then written to shared
//     memory; one warp per 8 rows updates the running max m and normaliser
//     l and writes p back; every thread then rescales its 4 x (DP/16)
//     fp32 accumulator by alpha and adds p V.  m, l and the accumulator
//     never leave the SM;
//   * key tiles that the causal or window mask empties for the whole query
//     block are skipped (they would add exactly 0).
// mma.sync / wgmma with TMA are later work.
//
// The entry point launches on the given stream and returns
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int BQ = 64;  // query rows per CTA
constexpr int RM = BQ / 16;  // query rows per thread in the micro-tiles
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF: a masked score

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DP, int BK>
struct Smem {
  static constexpr int LD = DP + 1;  // Q, K, V row pitch in floats
  static constexpr int LDP = BK + 1;  // S / P row pitch
  static constexpr int q = 0;
  static constexpr int k = q + BQ * LD;
  static constexpr int v = k + BK * LD;
  static constexpr int p = v + BK * LD;
  static constexpr int m = p + BQ * LDP;
  static constexpr int l = m + BQ;
  static constexpr int alpha = l + BQ;
  static constexpr int floats = alpha + BQ;
  static constexpr size_t bytes = size_t(floats) * sizeof(float);
};

// rows x DP floats from rows [row0, row0 + rows) of a [n_rows, d] matrix,
// zero outside it.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                                          int64_t row0, int rows, int64_t n_rows, int d) {
  constexpr int LD = DP + 1;
  for (int e = threadIdx.x; e < rows * DP; e += kThreads) {
    const int r = e / DP;
    const int c = e % DP;
    const int64_t g = row0 + r;
    dst[r * LD + c] = (g < n_rows && c < d) ? to_f(src[g * d + c]) : 0.0f;
  }
}

template <typename T, int DP, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int64_t sq, int64_t sk,
                           int d, int hq, int group, float scale, int causal, int has_window,
                           int64_t window, int has_softcap, float softcap) {
  using L = Smem<DP, BK>;
  constexpr int CN = BK / 16;  // key columns per thread in S
  constexpr int DN = DP / 16;  // head-dim columns per thread in the accumulator
  extern __shared__ float smem[];
  float* qs = smem + L::q;
  float* ks = smem + L::k;
  float* vs = smem + L::v;
  float* ps = smem + L::p;
  float* ms = smem + L::m;
  float* ls = smem + L::l;
  float* as = smem + L::alpha;

  const int bh = blockIdx.y;  // b * hq + h
  const int64_t kvh = int64_t(bh / hq) * (hq / group) + (bh % hq) / group;
  const T* qh = q + int64_t(bh) * sq * d;
  const T* kh = k + kvh * sk * d;
  const T* vh = v + kvh * sk * d;
  T* oh = o + int64_t(bh) * sq * d;
  const int64_t q0 = int64_t(blockIdx.x) * BQ;
  const int64_t q1 = min(q0 + BQ, sq);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_tile<T, DP>(qs, qh, q0, BQ, sq, d);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.0f;
  }
  float acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.0f;

  // Keys any row of this block may keep: [k_lo, k_hi).
  int64_t k_hi = sk;
  if (causal) k_hi = min(k_hi, q1);
  int64_t k_lo = 0;
  if (has_window) k_lo = max(int64_t(0), q0 - window + 1);
  const int64_t kb_first = k_lo / BK;
  const int64_t kb_end = k_hi > k_lo ? (k_hi + BK - 1) / BK : kb_first;

  for (int64_t kb = kb_first; kb < kb_end; ++kb) {
    const int64_t k0 = kb * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DP>(ks, kh, k0, BK, sk, d);
    load_tile<T, DP>(vs, vh, k0, BK, sk, d);
    __syncthreads();

    // S = Q K^T for rows ty + 16 i, keys tx + 16 j.
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = qs[(ty + 16 * i) * L::LD + c];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = ks[(tx + 16 * j) * L::LD + c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int64_t qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int64_t ki = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (has_softcap) x = softcap * tanhf(x / softcap);
        bool keep = ki < sk;
        if (causal) keep = keep && qi >= ki;
        if (has_window) keep = keep && qi - ki < window;
        ps[(ty + 16 * i) * L::LDP + tx + 16 * j] = keep ? x : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax, one warp per row.
    for (int r = warp; r < BQ; r += kWarps) {
      float* row = ps + r * L::LDP;
      float mx = kNegInf;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int c = lane; c < BK; c += 32) {
        const float x = row[c];
        const float p = x <= kNegInf ? 0.0f : expf(x - m_new);
        sum += p;
        row[c] = to_f(from_f<T>(p));  // p in v's type for the p.v product
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = m_prev <= kNegInf ? 0.0f : expf(m_prev - m_new);
        as[r] = alpha;
        ls[r] = alpha * ls[r] + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V for rows ty + 16 i, head columns tx + 16 j.
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float a = as[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RM], vv[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = ps[(ty + 16 * i) * L::LDP + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) vv[j] = vs[c * L::LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i;
    const int64_t qi = q0 + r;
    if (qi >= sq) continue;
    const float l = ls[r];
    const float inv = l == 0.0f ? 1.0f : l;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int c = tx + 16 * j;
      if (c < d) oh[qi * d + c] = from_f<T>(acc[i][j] / inv);
    }
  }
}

template <typename T, int DP, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int b, int hq, int group,
           int64_t sq, int64_t sk, int d, float scale, int causal, int has_window,
           int64_t window, int has_softcap, float softcap, cudaStream_t stream) {
  using L = Smem<DP, BK>;
  auto kernel = flash_attention_kernel<T, DP, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned((sq + BQ - 1) / BQ), unsigned(b * hq));
  kernel<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, d, hq, group, scale, causal, has_window, window, has_softcap,
      softcap);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b, int hq, int group,
             int64_t sq, int64_t sk, int d, float scale, int causal, int has_window,
             int64_t window, int has_softcap, float softcap, cudaStream_t stream) {
#define DCI_FA_ARGS q, k, v, o, b, hq, group, sq, sk, d, scale, causal, has_window, window, \
                    has_softcap, softcap, stream
  if (d <= 32) return launch<T, 32, 64>(DCI_FA_ARGS);
  if (d <= 64) return launch<T, 64, 64>(DCI_FA_ARGS);
  if (d <= 128) return launch<T, 128, 32>(DCI_FA_ARGS);
  if (d <= 192) return launch<T, 192, 32>(DCI_FA_ARGS);
  if (d <= 256) return launch<T, 256, 32>(DCI_FA_ARGS);
#undef DCI_FA_ARGS
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q [b, hq, sq, d], k and v [b, hq / group, sk, d], o [b, hq, sq, d], all
// contiguous.  dtype: 0 = float32, 1 = bfloat16.  1 <= d <= 256.
int dci_flash_attention(const void* q, const void* k, const void* v, void* o, int b, int hq,
                        int group, long long sq, long long sk, int d, int dtype, float scale,
                        int causal, int has_window, long long window, int has_softcap,
                        float softcap, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, b, hq, group, sq, sk, d, scale, causal, has_window,
                           window, has_softcap, softcap, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, b, hq, group, sq, sk, d, scale, causal,
                                   has_window, window, has_softcap, softcap, st);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
