// Attention for Hopper (sm_90a): three kernels behind one C entry.
//
// Replaces the Pallas TPU kernel `flash_attention_2d` of the JAX reference
// (src/repro/kernels/flash_attention/kernel.py:94, body `_kernel` at :27)
// and its vmap over (batch, head) in ops.py: one call covers every
// (batch, query head).  Per query row i and key row j (both counted from 0):
//   s    = (q_i . k_j) * scale                   fp32 sums; scale = 1/sqrt(D) in q's type
//   s    = softcap * tanh(s / softcap)           if softcap is set, before the mask
//   keep = j < Sk && (!causal || i >= j) && (!window || i - j < window)
//   out  = sum_j p_ij v_j / sum_j p_ij,  p = exp(s - running max) on kept j
// with the reference's rules: a row with no kept key outputs 0 (l == 0),
// in bf16 p is rounded to bf16 before the p.v product while the
// normaliser sums the unrounded p, and the output is rounded to q's type.
// Query head h reads kv head h / (Hq / Hkv) (GQA, MQA) without a repeat.
// Every grid is one-dimensional (B * Hq, or B * Hkv, times the tiles on
// gridDim.x), so no batch * head count is limited to 65535.
//
// Which kernel a call takes is decided in Python (kernels/flash_attention/
// kernel.py, `plan`) and passed in `design`:
//
// * design 1, "wgmma": bf16 prefill on the tensor cores, FA3-shaped.
//   Bound by operations (4*D FLOP per kept (query, key) pair: at Gemma-2
//   27B's prefill 137 GFLOP against 50 MB, far above the H100's ~295
//   FLOP/byte ridge), so the products go to the tensor cores and the
//   softmax between them is kept short.  One CTA of 288 threads per
//   (batch * head, 128 query rows): two consumer warpgroups of 64 rows and
//   one producer warp.  The producer loads Q once and keeps a ring of two
//   K/V stages full with TMA (3-D tensor maps [B*H, S, D], so a ragged
//   tile is zero-filled and never reads the next head; 128-byte swizzle;
//   mbarrier completion, an empty barrier per stage for the consumers'
//   release).  A consumer warpgroup computes S = Q K^T with
//   wgmma.m64nBKk16 (Q and K from shared memory, S in fp32 registers),
//   then soft-caps, masks and runs the online softmax in registers, in the
//   log2 domain: row max and sum over the quad that holds a row, by
//   shuffles; tanh as 1 - 2 / (1 + exp(2x)), two MUFU operations, where
//   tanh.approx's 2^-11 relative error would show in p.  The softmax is a
//   template on soft-cap and mask, picked once per tile, so it runs as
//   straight-line code (with the flags tested per element, the compiler
//   left a branch every few elements and the softmax took most of the
//   kernel's time).  P is rounded to bf16 in registers
//   and fed as wgmma's A operand for O += P V (V from shared memory
//   through the transpose bit, 64 output columns per instruction).  D is
//   padded in shared memory to a multiple of 64 (the swizzle width) by the
//   TMA's zero fill; BK = 128 keys up to D = 128 and 64 above.  Key tiles
//   the causal or window mask empties for the whole query tile are
//   skipped, masks are computed only on tiles that cut them, and the
//   longest causal query tiles launch first.  D must be a multiple of 8
//   (the TMA's 16-byte row stride); other bf16 calls take design 0.
//   Registers: 288 threads leave 168 a thread; above D = 192 the fp32 O
//   (D / 2 registers) does not fit beside S and P, ptxas serialises the
//   wgmmas and spills, and query tiles stay 128 rows all the same.  Not
//   yet: overlap of a tile's softmax with the tensor cores inside a
//   warpgroup (FA3's intra-warpgroup overlap needs those registers; the
//   two warpgroups and the producer overlap across the CTA).
//
// * design 2, "split": decode (few query rows per kv head), bf16 and f32.
//   Bound by bytes: each K/V row is read once and meets only group * Sq
//   query rows (2 at Gemma-2's Sq 1), so a grid of (B * Hq, Sq / BQ)
//   tiles would leave most SMs idle and read each kv head once per query
//   head.  Pass 1 splits the keys of each (batch, kv head) into chunks
//   sized so that about four CTAs per SM are in flight; one CTA of 128
//   threads serves all query heads of the GQA group for its chunk, stages
//   64-key K and V tiles in shared memory with 16-byte loads, and computes
//   scores, the chunk's max and sum, and p . v in fp32 FMA (bf16 rows are
//   read once; tensor cores would not shorten a bytes-bound pass).  In
//   bf16, p is rounded to bf16 relative to its chunk's max.  It writes
//   the per-chunk partials (m, l, acc[D]) in fp32 to scratch the wrapper
//   allocates.  Pass 2 combines them per output row by exp(m_c - m)
//   rescaling; a chunk with no kept key (m = NEG_INF, l = 0) adds nothing
//   and a row with none outputs 0.  `attention_split_ref` in ref.py states
//   the same arithmetic in torch.
//
// * design 0, "fma": f32 prefill (and bf16 with D not a multiple of 8).
//   fp32 FMA on CUDA cores: tensor cores would round f32 operands through
//   TF32 (about three decimal digits) and break the 3e-4 parity with
//   ref.py that f32 is held to.  One CTA of 256 threads per (batch *
//   head, 64 query rows); the Q block and one K and one V tile staged in
//   shared memory as fp32, zero-padded to the head width; S for the tile
//   in a register micro-tile, the online softmax one warp per row through
//   shared memory, the fp32 accumulator in registers; masked tiles
//   skipped.
//
// The entry point launches on the given stream and returns
// cudaGetLastError() (or a negative code for a tensor map the driver
// refused); the Python wrapper raises if it is not 0.

#include <cuda.h>  // CUtensorMap and its enums; the driver function comes from cudaGetDriverEntryPoint
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF: a masked score
constexpr float kLog2e = 1.4426950408889634f;

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

// ---------------------------------------------------------------------------
// design 0: fp32 FMA
// ---------------------------------------------------------------------------
namespace fma_design {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int BQ = 64;  // query rows per CTA
constexpr int RM = BQ / 16;  // query rows per thread in the micro-tiles

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
    fma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, int64_t sq, int64_t sk, int d, int64_t n_bh, int hq, int group,
               float scale, int causal, int has_window, int64_t window, int has_softcap,
               float softcap) {
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

  const int64_t bh = int64_t(blockIdx.x) % n_bh;  // b * hq + h
  const int64_t kvh = (bh / hq) * (hq / group) + (bh % hq) / group;
  const T* qh = q + bh * sq * d;
  const T* kh = k + kvh * sk * d;
  const T* vh = v + kvh * sk * d;
  T* oh = o + bh * sq * d;
  const int64_t q0 = (int64_t(blockIdx.x) / n_bh) * BQ;
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
  auto kernel = fma_kernel<T, DP, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::bytes));
  if (err != cudaSuccess) return int(err);
  const int64_t n_bh = int64_t(b) * hq;
  const int64_t tiles = (sq + BQ - 1) / BQ * n_bh;
  if (tiles > int64_t(0x7fffffff)) return int(cudaErrorInvalidConfiguration);
  kernel<<<unsigned(tiles), kThreads, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, d, n_bh, hq, group, scale, causal, has_window, window,
      has_softcap, softcap);
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

}  // namespace fma_design

// ---------------------------------------------------------------------------
// design 1: bf16 prefill on the tensor cores (wgmma + TMA)
// ---------------------------------------------------------------------------
namespace wgmma_design {

constexpr int BQ = 128;  // query rows per CTA: two consumer warpgroups of 64
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kStages = 2;  // K/V ring depth
constexpr int kNoDriverEntry = -1;  // cuTensorMapEncodeTiled not found
constexpr int kBadTensorMap = -2;  // the driver refused a tensor map

template <int DP>
struct Cfg {
  static constexpr int NC = DP / 64;  // 64-column (128-byte, one swizzle span) chunks of a row
  static constexpr int BK = DP <= 128 ? 128 : 64;  // keys per tile
  static constexpr uint32_t QCH = BQ * 128;  // bytes of one chunk of the Q tile
  static constexpr uint32_t KCH = BK * 128;  // of one chunk of a K or V tile
  static constexpr uint32_t Q_OFF = 0;
  static constexpr uint32_t K_OFF = Q_OFF + NC * QCH;
  static constexpr uint32_t V_OFF = K_OFF + kStages * NC * KCH;
  static constexpr uint32_t BAR_OFF = V_OFF + kStages * NC * KCH;
  static constexpr uint32_t BYTES = BAR_OFF + 8 * (1 + 2 * kStages) + 1024;  // + base alignment
  static constexpr uint32_t Q_TX = NC * QCH;  // bytes one Q load delivers
  static constexpr uint32_t KV_TX = 2 * NC * KCH;  // one K and one V tile
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Waits until the barrier's phase of the given parity has completed.  A
// wait of more than about ten seconds (a broken pipeline, not a slow tile)
// traps, so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > 20000000000LL) __trap();
  }
}

// One box of a 3-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile whose 1024-byte
// swizzle atoms (8 rows of 128 bytes) lie `sbo` bytes apart.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers across
// the asynchronous window between issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x N, fp32 registers) += A (64 x 16, shared) * B (16 x N, shared), both K-major.

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 64, fp32 registers) += A (64 x 16, bf16 registers) * B (16 x 64,
// shared, MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int BK>
__device__ __forceinline__ void mma_qk(float (&s)[BK / 2], uint64_t a, uint64_t b) {
  if constexpr (BK == 128) {
    wgmma_ss_n128(s, a, b, 1);
  } else {
    wgmma_ss_n64(s, a, b, 1);
  }
}

// One S tile of a warpgroup in registers: soft-cap (kCap) and mask (kMask:
// keep columns lo[i] <= col < hi[i] of row i; only on tiles that cut a
// mask), then the online softmax, in the log2 domain (y = s' * log2(e)).
// In wgmma's accumulator layout a thread holds rows r and r + 8
// (r = 16 * warp + lane / 4) and, in every 8-column group n, columns
// 8n + qc and 8n + qc + 1: register 4n + 2i + j is (row r + 8i, column
// 8n + qc + j); the four threads of a quad share the rows, so row max and
// sum take two shuffles.  Updates m and this thread's part of l, writes P
// in bf16 as wgmma A fragments (for k-step kk: (r, 2kk), (r + 8, 2kk),
// (r, 2kk + 1), (r + 8, 2kk + 1) of the 8-column groups) and returns in
// alpha the factor for the accumulator.  The flags are template
// arguments so that the 64-128 elements run as straight-line code.
template <int BK, bool kCap, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], uint32_t (&pa)[BK / 16][4],
                                             float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             const int (&lo)[2], const int (&hi)[2], int qc,
                                             float scale_log2, float cap_l, float cap_k) {
  const float neg_inf = __int_as_float(0xff800000u);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float s = sc[4 * n + 2 * i + j];
        // c tanh(x / c) as c - 2c / (1 + exp(2x / c)): absolute error near
        // c * 2^-23, where tanh.approx's relative 2^-11 would show in p.
        float y = kCap ? fmaf(-2.0f * cap_l, rcp(1.0f + ex2(s * cap_k)), cap_l) : s * scale_log2;
        if (kMask) {
          const int col = 8 * n + qc + j;
          if (col < lo[i] || col >= hi[i]) y = neg_inf;
        }
        sc[4 * n + 2 * i + j] = y;
        mx[i] = fmaxf(mx[i], y);
      }
  float ms[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    ms[i] = mx[i] == neg_inf ? 0.0f : mx[i];  // a row with nothing kept yet
    alpha[i] = ex2(m[i] - ms[i]);
    m[i] = mx[i];
  }
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 4 * (2 * kk + h) + 2 * i;
        const float p0 = ex2(sc[e] - ms[i]);
        const float p1 = ex2(sc[e + 1] - ms[i]);
        rs[i] += p0 + p1;  // the normaliser sums the unrounded p
        pa[kk][2 * h + i] = pack_bf16(p0, p1);
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = fmaf(l[i], alpha[i], rs[i]);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                 int64_t sq, int64_t sk, int d, int64_t n_bh, int hq, int group, float scale,
                 int causal, int has_window, int64_t window, int has_softcap, float softcap) {
  using C = Cfg<DP>;
  constexpr int BK = C::BK;
  constexpr int NC = C::NC;
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  // 128-byte swizzle repeats every 1024 bytes: tiles start on that boundary.
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t q_s = base + C::Q_OFF;
  const uint32_t k_s = base + C::K_OFF;
  const uint32_t v_s = base + C::V_OFF;
  const uint32_t q_full = base + C::BAR_OFF;  // then full[kStages], then empty[kStages]
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int64_t n_qt = (sq + BQ - 1) / BQ;
  const int64_t x = blockIdx.x;
  const int64_t bh = x % n_bh;  // b * hq + h
  const int64_t qt = causal ? n_qt - 1 - x / n_bh : x / n_bh;  // longest causal tiles first
  const int64_t kvh = (bh / hq) * (hq / group) + (bh % hq) / group;
  const int64_t q0 = qt * BQ;
  // Keys any row of this tile may keep: [k_lo, k_hi).
  int64_t k_hi = sk;
  if (causal) k_hi = min(k_hi, min(q0 + BQ, sq));
  int64_t k_lo = 0;
  if (has_window) k_lo = max(int64_t(0), q0 - window + 1);
  const int64_t kb_first = k_lo / BK;
  const int n_tiles = k_hi > k_lo ? int((k_hi + BK - 1) / BK - kb_first) : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == kConsumers / 32) {  // the producer warp: one thread issues every load
    if (lane == 0) {
      mbar_expect_tx(q_full, C::Q_TX);
      for (int c = 0; c < NC; ++c)
        tma_load(q_s + c * C::QCH, &tm_q, q_full, 64 * c, int(q0), int(bh));
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        // Round r of a stage waits for the consumers' release of round r - 1.
        if (it >= kStages) mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
        const int k0 = int((kb_first + it) * BK);
        mbar_expect_tx(full0 + 8 * s, C::KV_TX);
        for (int c = 0; c < NC; ++c) {
          tma_load(k_s + (s * NC + c) * C::KCH, &tm_k, full0 + 8 * s, 64 * c, k0, int(kvh));
          tma_load(v_s + (s * NC + c) * C::KCH, &tm_v, full0 + 8 * s, 64 * c, k0, int(kvh));
        }
      }
    }
    return;
  }

  // A consumer warpgroup: rows 64 * wgi .. +63 of the tile.
  const int wgi = warp / 4;
  const int qc = 2 * (lane % 4);
  const int64_t wq0 = q0 + 64 * wgi;  // this warpgroup's first row
  int64_t qrow[2];
  qrow[0] = wq0 + 16 * (warp % 4) + lane / 4;
  qrow[1] = qrow[0] + 8;
  const float scale_log2 = scale * kLog2e;
  const float cap_l = has_softcap ? softcap * kLog2e : 0.0f;
  const float cap_k = has_softcap ? 2.0f * scale * kLog2e / softcap : 0.0f;
  const uint32_t qa = q_s + wgi * 64 * 128;  // this warpgroup's rows in each Q chunk

  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.0f;
  float m[2] = {__int_as_float(0xff800000u), __int_as_float(0xff800000u)};
  float l[2] = {0.0f, 0.0f};  // this thread's part of the row sums

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int64_t k0 = (kb_first + it) * BK;
    mbar_wait(full0 + 8 * s, (it / kStages) & 1);

    // S = Q K^T: 4 k-steps of 16 columns (32 bytes) per 64-column chunk.
    float sc[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] = 0.0f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_qk<BK>(sc, desc(qa + c * C::QCH + kk * 32, 16, 1024),
                   desc(k_s + (s * NC + c) * C::KCH + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);

    // Masks only on tiles that cut one for these 64 rows: keep key k0 + col
    // of row i where lo[i] <= col < hi[i].
    const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > wq0) ||
                      (has_window && k0 <= wq0 + 63 - window);
    uint32_t pa[BK / 16][4];
    float alpha[2];
    if (edge) {
      int lo[2], hi[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int64_t top = causal ? min(sk, qrow[i] + 1) : sk;
        const int64_t bottom = has_window ? qrow[i] - window + 1 : k0;
        hi[i] = int(max(int64_t(0), min(int64_t(BK), top - k0)));
        lo[i] = int(max(int64_t(0), min(int64_t(BK), bottom - k0)));
      }
      if (has_softcap)
        softmax_tile<BK, true, true>(sc, pa, m, l, alpha, lo, hi, qc, scale_log2, cap_l, cap_k);
      else
        softmax_tile<BK, false, true>(sc, pa, m, l, alpha, lo, hi, qc, scale_log2, cap_l, cap_k);
    } else {
      const int lo[2] = {0, 0}, hi[2] = {BK, BK};
      if (has_softcap)
        softmax_tile<BK, true, false>(sc, pa, m, l, alpha, lo, hi, qc, scale_log2, cap_l, cap_k);
      else
        softmax_tile<BK, false, false>(sc, pa, m, l, alpha, lo, hi, qc, scale_log2, cap_l, cap_k);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[c][4 * n + 2 * i] *= alpha[i];
          acc[c][4 * n + 2 * i + 1] *= alpha[i];
        }

    // O += P V: V rows are the k dimension, 16 keys (2048 bytes) per k-step;
    // each instruction covers 64 output columns.
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        wgmma_rs_n64(acc[c], pa[kk], desc(v_s + (s * NC + c) * C::KCH + kk * 2048, 1024, 1024));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);  // this warp is done with the stage
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = l[i] == 0.0f ? 0.0f : 1.0f / l[i];  // a row with no kept key outputs 0
  }
  __nv_bfloat16* oh = o + bh * sq * d;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = 64 * c + 8 * n + qc;
        if (qrow[i] < sq && col < d)
          *reinterpret_cast<__nv_bfloat162*>(oh + qrow[i] * d + col) = __floats2bfloat162_rn(
              acc[c][4 * n + 2 * i] * inv[i], acc[c][4 * n + 2 * i + 1] * inv[i]);
      }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found once through the runtime, so
// the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 [heads, rows, d] tensor as boxes of 64 columns x box_rows rows of
// one head, 128-byte swizzled; reads past rows or d are zero-filled.
int make_map(CUtensorMap* map, const void* ptr, int d, int64_t rows, int64_t heads,
             int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoDriverEntry;
  const cuuint64_t dims[3] = {cuuint64_t(d), cuuint64_t(rows), cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(d) * 2, cuuint64_t(d) * 2 * cuuint64_t(rows)};
  const cuuint32_t box[3] = {64, cuuint32_t(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kBadTensorMap;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int b, int hq, int group,
           int64_t sq, int64_t sk, int d, float scale, int causal, int has_window,
           int64_t window, int has_softcap, float softcap, cudaStream_t stream) {
  using C = Cfg<DP>;
  const int64_t n_bh = int64_t(b) * hq;
  CUtensorMap tq, tk, tv;
  int status = make_map(&tq, q, d, sq, n_bh, BQ);
  if (status == 0) status = make_map(&tk, k, d, sk, n_bh / group, C::BK);
  if (status == 0) status = make_map(&tv, v, d, sk, n_bh / group, C::BK);
  if (status != 0) return status;
  auto kernel = wgmma_kernel<DP>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::BYTES));
  if (err != cudaSuccess) return int(err);
  const int64_t tiles = (sq + BQ - 1) / BQ * n_bh;
  if (tiles > int64_t(0x7fffffff)) return int(cudaErrorInvalidConfiguration);
  kernel<<<unsigned(tiles), kThreads, C::BYTES, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), sq, sk, d, n_bh, hq, group, scale, causal,
      has_window, window, has_softcap, softcap);
  return int(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, int b, int hq, int group,
             int64_t sq, int64_t sk, int d, float scale, int causal, int has_window,
             int64_t window, int has_softcap, float softcap, cudaStream_t stream) {
#define DCI_FA_ARGS q, k, v, o, b, hq, group, sq, sk, d, scale, causal, has_window, window, \
                    has_softcap, softcap, stream
  if (d % 8 != 0) return int(cudaErrorInvalidValue);  // the TMA's 16-byte row stride
  if (d <= 64) return launch<64>(DCI_FA_ARGS);
  if (d <= 128) return launch<128>(DCI_FA_ARGS);
  if (d <= 192) return launch<192>(DCI_FA_ARGS);
  if (d <= 256) return launch<256>(DCI_FA_ARGS);
#undef DCI_FA_ARGS
  return int(cudaErrorInvalidValue);
}

}  // namespace wgmma_design

// ---------------------------------------------------------------------------
// design 2: split-key decode, bf16 and f32
// ---------------------------------------------------------------------------
namespace split_design {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int TK = 64;  // keys per staged K or V tile

// Row geometry in 16-byte vectors: the staged pitch is odd, so the eight
// rows one quarter-warp reads with 16-byte loads fall in eight bank groups.
template <typename T>
struct Geo {
  static constexpr int EPV = 16 / int(sizeof(T));  // elements per vector
  int n16;  // vectors per row of d elements (the last one zero-padded)
  int pitch;  // staged row pitch in vectors
  int qw;  // a query row in shared memory, in floats
  __host__ __device__ explicit Geo(int d)
      : n16((d * int(sizeof(T)) + 15) / 16), pitch(n16 | 1), qw(n16 * EPV) {}
  __host__ __device__ size_t smem(int rows, int chunk) const {
    return (size_t(rows) * qw + size_t(rows) * chunk) * sizeof(float) + size_t(TK) * pitch * 16;
  }
};

// Keys [t0, min(t0 + TK, t_end)) of one head's rows into TK staged rows,
// zero past t_end and past d.  `vec`: rows are whole 16-byte vectors and
// 16-byte aligned, so they are read as such, eight loads in flight a thread.
template <typename T>
__device__ __forceinline__ void stage(uint4* __restrict__ dst, const T* __restrict__ src,
                                      int64_t t0, int64_t t_end, int d, const Geo<T>& g,
                                      int vec) {
  if (vec) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    const int total = TK * g.n16;
    for (int e0 = threadIdx.x; e0 < total; e0 += 8 * kThreads) {
      uint4 buf[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads;
        const int r = e / g.n16;
        buf[u] = e < total && t0 + r < t_end ? __ldg(s + (t0 + r) * g.n16 + (e - r * g.n16))
                                             : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads;
        const int r = e / g.n16;
        if (e < total) dst[r * g.pitch + (e - r * g.n16)] = buf[u];
      }
    }
  } else {
    T* ds = reinterpret_cast<T*>(dst);
    const int row = g.pitch * Geo<T>::EPV;
    for (int e = threadIdx.x; e < TK * g.qw; e += kThreads) {
      const int r = e / g.qw;
      const int c = e - r * g.qw;
      ds[r * row + c] = c < d && t0 + r < t_end ? src[(t0 + r) * d + c] : from_f<T>(0.0f);
    }
  }
}

// acc += q[0 .. EPV) . the EPV elements of one staged vector.
template <typename T>
__device__ __forceinline__ void dot16(const float* q, uint4 kv, float& acc);
template <>
__device__ __forceinline__ void dot16<float>(const float* q, uint4 kv, float& acc) {
  const float4 a = *reinterpret_cast<const float4*>(q);
  acc = fmaf(a.x, __uint_as_float(kv.x), acc);
  acc = fmaf(a.y, __uint_as_float(kv.y), acc);
  acc = fmaf(a.z, __uint_as_float(kv.z), acc);
  acc = fmaf(a.w, __uint_as_float(kv.w), acc);
}
template <>
__device__ __forceinline__ void dot16<__nv_bfloat16>(const float* q, uint4 kv, float& acc) {
  const float4 a = *reinterpret_cast<const float4*>(q);
  const float4 b = *reinterpret_cast<const float4*>(q + 4);
  // A bf16 is the high half of a float: the first element is the low half-word.
  acc = fmaf(a.x, __uint_as_float(kv.x << 16), acc);
  acc = fmaf(a.y, __uint_as_float(kv.x & 0xffff0000u), acc);
  acc = fmaf(a.z, __uint_as_float(kv.y << 16), acc);
  acc = fmaf(a.w, __uint_as_float(kv.y & 0xffff0000u), acc);
  acc = fmaf(b.x, __uint_as_float(kv.z << 16), acc);
  acc = fmaf(b.y, __uint_as_float(kv.z & 0xffff0000u), acc);
  acc = fmaf(b.z, __uint_as_float(kv.w << 16), acc);
  acc = fmaf(b.w, __uint_as_float(kv.w & 0xffff0000u), acc);
}

// Pass 1: one CTA per (batch * kv head, chunk of keys), serving the
// group's rows = group * sq query rows (row r: head r / sq of the group,
// position r % sq).  Writes the chunk's m and l per row and acc[rows][d].
template <typename T, int NU>
__global__ void __launch_bounds__(kThreads)
    split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 float* __restrict__ part_acc, float* __restrict__ part_ml, int64_t sq,
                 int64_t sk, int d, int hq, int group, int n_chunks, int chunk, float scale,
                 int causal, int has_window, int64_t window, int has_softcap, float softcap,
                 int vec) {
  const Geo<T> g(d);
  const int rows = group * int(sq);
  extern __shared__ __align__(16) uint8_t split_smem[];
  float* qs = reinterpret_cast<float*>(split_smem);  // [rows][qw]
  float* sc = qs + rows * g.qw;  // [rows][chunk]: scores, then p
  uint4* tile = reinterpret_cast<uint4*>(sc + rows * chunk);  // [TK][pitch]

  const int c = int(blockIdx.x % n_chunks);
  const int64_t kv = blockIdx.x / n_chunks;  // b * hkv + kv head
  const int hkv = hq / group;
  const int64_t bb = kv / hkv;
  const int64_t kvh = kv % hkv;
  const int64_t kept = causal ? min(sk, sq) : sk;  // no row keeps a key at or past this
  const int64_t k_begin = int64_t(c) * chunk;
  const int64_t k_end = min(k_begin + chunk, kept);
  const int n_keys = int(max(k_end - k_begin, int64_t(0)));
  const T* kh = k + kv * sk * d;
  const T* vh = v + kv * sk * d;
  const int64_t part = kv * n_chunks + c;

  for (int e = threadIdx.x; e < rows * g.qw; e += kThreads) {
    const int r = e / g.qw;
    const int col = e - r * g.qw;
    const int64_t h = kvh * group + r / sq;
    qs[e] = col < d ? to_f(q[((bb * hq + h) * sq + r % sq) * d + col]) : 0.0f;
  }

  // Scores of the chunk, one (row, key) pair a thread.
  for (int64_t t0 = k_begin; t0 < k_end; t0 += TK) {
    __syncthreads();  // the query rows are written; the last tile's readers are done
    stage<T>(tile, kh, t0, k_end, d, g, vec);
    __syncthreads();
    const int tn = int(min(int64_t(TK), k_end - t0));
    for (int p = threadIdx.x; p < rows * TK; p += kThreads) {
      const int r = p / TK;
      const int j = p - r * TK;
      if (j >= tn) continue;
      const float* qr = qs + r * g.qw;
      const uint4* kr = tile + j * g.pitch;
      float dot = 0.0f;
      for (int u = 0; u < g.n16; ++u) dot16<T>(qr + u * Geo<T>::EPV, kr[u], dot);
      float x = dot * scale;
      if (has_softcap) x = softcap * tanhf(x / softcap);
      const int64_t qi = r % sq;
      const int64_t ki = t0 + j;
      bool keep = true;  // ki < k_end <= sk
      if (causal) keep = qi >= ki;
      if (has_window) keep = keep && qi - ki < window;
      sc[r * chunk + int(t0 - k_begin) + j] = keep ? x : kNegInf;
    }
  }
  __syncthreads();

  // The chunk's max and sum, one warp per row; p rounded to T for p.v.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    float* row = sc + r * chunk;
    float mx = kNegInf;
    for (int j = lane; j < n_keys; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.0f;
    for (int j = lane; j < n_keys; j += 32) {
      const float x = row[j];
      const float p = x <= kNegInf ? 0.0f : expf(x - mx);
      sum += p;
      row[j] = to_f(from_f<T>(p));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      part_ml[(part * rows + r) * 2] = mx;
      part_ml[(part * rows + r) * 2 + 1] = sum;
    }
  }

  // acc[rows][d] = p . v, NU outputs a thread.
  const int n_out = rows * d;
  int ro[NU], co[NU];
  float acc[NU];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int e = threadIdx.x + u * kThreads;
    ro[u] = e / d;
    co[u] = e - ro[u] * d;
    acc[u] = 0.0f;
  }
  const int row_elems = g.pitch * Geo<T>::EPV;
  for (int64_t t0 = k_begin; t0 < k_end; t0 += TK) {
    __syncthreads();  // p is written; the last tile's readers are done
    stage<T>(tile, vh, t0, k_end, d, g, vec);
    __syncthreads();
    const T* vt = reinterpret_cast<const T*>(tile);
    const int tn = int(min(int64_t(TK), k_end - t0));
    const int j0 = int(t0 - k_begin);
    for (int j = 0; j < tn; ++j) {
#pragma unroll
      for (int u = 0; u < NU; ++u)
        if (threadIdx.x + u * kThreads < n_out)
          acc[u] = fmaf(sc[ro[u] * chunk + j0 + j], to_f(vt[j * row_elems + co[u]]), acc[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int e = threadIdx.x + u * kThreads;
    if (e < n_out) part_acc[part * n_out + e] = acc[u];
  }
}

// Pass 2: one CTA per output row, combining the chunks by exp(m_c - m).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                   T* __restrict__ o, int64_t sq, int d, int hq, int group, int n_chunks) {
  const int rows = group * int(sq);
  const int64_t kv = blockIdx.x / rows;
  const int r = int(blockIdx.x % rows);
  const int hkv = hq / group;
  const int64_t h = (kv % hkv) * group + r / sq;
  T* orow = o + (((kv / hkv) * hq + h) * sq + r % sq) * d;
  const float* ml = part_ml + (kv * n_chunks * rows + r) * 2;  // chunk c at + c * rows * 2
  const float* acc = part_acc + (kv * n_chunks * rows + r) * d;  // chunk c at + c * rows * d
  float mx = kNegInf;
  for (int c = 0; c < n_chunks; ++c) mx = fmaxf(mx, ml[int64_t(c) * rows * 2]);
  float l = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    const float mc = ml[int64_t(c) * rows * 2];
    if (mc > kNegInf) l = fmaf(expf(mc - mx), ml[int64_t(c) * rows * 2 + 1], l);
  }
  for (int col = threadIdx.x; col < d; col += kThreads) {
    float a = 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
      const float mc = ml[int64_t(c) * rows * 2];
      if (mc > kNegInf) a = fmaf(expf(mc - mx), acc[int64_t(c) * rows * d + col], a);
    }
    orow[col] = from_f<T>(l == 0.0f ? 0.0f : a / l);  // a row with no kept key outputs 0
  }
}

template <typename T, int NU>
int launch(const void* q, const void* k, const void* v, void* o, int b, int hq, int group,
           int64_t sq, int64_t sk, int d, float scale, int causal, int has_window,
           int64_t window, int has_softcap, float softcap, int chunk, int n_chunks,
           void* scratch, cudaStream_t stream) {
  const Geo<T> g(d);
  const int rows = group * int(sq);
  const size_t bytes = g.smem(rows, chunk);
  auto kernel = split_kernel<T, NU>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  const int64_t n_kv = int64_t(b) * (hq / group);
  if (n_kv * n_chunks > int64_t(0x7fffffff) || n_kv * rows > int64_t(0x7fffffff))
    return int(cudaErrorInvalidConfiguration);
  float* part_acc = static_cast<float*>(scratch);
  float* part_ml = part_acc + n_kv * n_chunks * rows * d;
  const int vec = (d * int(sizeof(T))) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  kernel<<<unsigned(n_kv * n_chunks), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), part_acc,
      part_ml, sq, sk, d, hq, group, n_chunks, chunk, scale, causal, has_window, window,
      has_softcap, softcap, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  combine_kernel<T><<<unsigned(n_kv * rows), kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(o), sq, d, hq, group, n_chunks);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b, int hq, int group,
             int64_t sq, int64_t sk, int d, float scale, int causal, int has_window,
             int64_t window, int has_softcap, float softcap, int chunk, int n_chunks,
             void* scratch, cudaStream_t stream) {
#define DCI_FA_ARGS q, k, v, o, b, hq, group, sq, sk, d, scale, causal, has_window, window, \
                    has_softcap, softcap, chunk, n_chunks, scratch, stream
  const int64_t per_thread = (group * sq * d + kThreads - 1) / kThreads;
  if (chunk < 1 || n_chunks < 1 || int64_t(chunk) * n_chunks < sk)
    return int(cudaErrorInvalidValue);
  if (per_thread <= 1) return launch<T, 1>(DCI_FA_ARGS);
  if (per_thread <= 2) return launch<T, 2>(DCI_FA_ARGS);
  if (per_thread <= 4) return launch<T, 4>(DCI_FA_ARGS);
  if (per_thread <= 8) return launch<T, 8>(DCI_FA_ARGS);
  if (per_thread <= 16) return launch<T, 16>(DCI_FA_ARGS);
  if (per_thread <= 32) return launch<T, 32>(DCI_FA_ARGS);
#undef DCI_FA_ARGS
  return int(cudaErrorInvalidValue);  // more than 16 rows of 256
}

}  // namespace split_design

}  // namespace

extern "C" {

// q [b, hq, sq, d], k and v [b, hq / group, sk, d], o [b, hq, sq, d], all
// contiguous.  dtype: 0 = float32, 1 = bfloat16.  1 <= d <= 256.
// design: 0 = fma, 1 = wgmma (bf16, d % 8 == 0), 2 = split, which takes
// `chunk` keys per chunk, n_chunks * chunk >= sk, and float scratch of
// b * (hq / group) * n_chunks * (group * sq) * (d + 2) elements.
int dci_flash_attention(const void* q, const void* k, const void* v, void* o, int b, int hq,
                        int group, long long sq, long long sk, int d, int dtype, float scale,
                        int causal, int has_window, long long window, int has_softcap,
                        float softcap, int design, int chunk, int n_chunks, void* scratch,
                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DCI_FA_ARGS q, k, v, o, b, hq, group, sq, sk, d, scale, causal, has_window, window, \
                    has_softcap, softcap
  if (design == 0 && dtype == 0) return fma_design::dispatch<float>(DCI_FA_ARGS, st);
  if (design == 0 && dtype == 1) return fma_design::dispatch<__nv_bfloat16>(DCI_FA_ARGS, st);
  if (design == 1 && dtype == 1) return wgmma_design::dispatch(DCI_FA_ARGS, st);
  if (design == 2 && dtype == 0)
    return split_design::dispatch<float>(DCI_FA_ARGS, chunk, n_chunks, scratch, st);
  if (design == 2 && dtype == 1)
    return split_design::dispatch<__nv_bfloat16>(DCI_FA_ARGS, chunk, n_chunks, scratch, st);
#undef DCI_FA_ARGS
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
