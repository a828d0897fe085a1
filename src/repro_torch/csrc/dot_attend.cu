// The Graph Transformer's attention over a sampled block, for Hopper (sm_90a).
//
// dci_dot_attend replaces no Pallas kernel: the JAX reference has no Graph
// Transformer.  It computes, for each destination d and head k of a layer
// (Shi et al., UniMP, IJCAI 2021: PyG's TransformerConv), the
// softmax-weighted sum of the layer's INPUT rows over d's fanout sampled
// neighbours (slots 0..fanout-1; d's own row takes no part):
//
//   e_j   = u[d, k] . x_j
//   out_k = sum_j softmax_j(e_j) x_j                      [num_dst, H, F]
//
// u[d, k] = W_k^k q_d^k / sqrt(D) is d's own query folded through the
// head's key map, so a score costs one dot of length F and the heads' value
// maps run once, on out_k, as a batched matmul after this kernel
// (models/gnn/models.py).  The key bias adds the same to every slot of d,
// and the softmax cancels it.  x[R, F] (float32) holds rows; idx[num_dst *
// (1 + fanout)] (int32) maps the [self | neighbours] layout of
// sample_blocks onto them (a sampled layer 0 reads the frontier's distinct
// rows through the dedup inverse map), or is null: position i is row i (the
// dense form, layers 1 and up and the routes without dedup).  Only the
// neighbour positions are read.  Indices are clamped to [0, R).
//
// What bounds it on an H100: at layer 0 (270,336 destinations x 15 rows of
// 100 floats at batch 4096 and fan-outs 15,10,5) bytes read as random rows,
// as in gat_attend; at layers 1-2 (512-float rows in place) bytes read in
// order.  Beside GAT's, every destination brings its own H x F queries (read
// once, 1,600 bytes at layer 0) where gat_attend's folded score vectors are
// shared by every row.  The design is gat_attend's:
// - A team of G warps (G = 1, 2, 4 or 8, picked by the wrapper from F)
//   owns one destination; thread t of the team owns the row's 16-byte
//   vector t, and keeps vector t of each head's query in registers for the
//   whole destination.  A 100-float row is one warp's 25 lanes; a 512-float
//   row is four warps'.
// - The slots go a chunk at a time: a chunk's rows are loaded before the
//   first of them is used, then the chunk's rows x H partial dots are
//   summed across the team in one exchange (a transposing xor reduction in
//   the warp, then the warps' totals through shared memory in warp order,
//   one barrier a chunk, double-buffered by chunk parity).  Every thread of
//   the team ends with the same bits.
// - Softmax with a running maximum over the slots in order (the online
//   form of flash attention), starting from no slot (maximum -inf, sum 0):
//   per chunk the maximum grows once, the weighted sum of the rows seen so
//   far is rescaled once, and each row is added with its weight, so every
//   row is read once.
// - No atomics: every run gives the same bits, and the indexed and the
//   dense form of the same rows give the same bits.
//
// The entry point launches on the given stream and returns
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Partial dots a chunk exchanges: a chunk is kExchange / MAXH neighbour
// rows (2 at up to 4 heads, 1 at up to 8), loaded together and scored in
// one exchange (gat_attend's setting, timed there on the H100).
constexpr int kExchange = 8;

struct alignas(16) Vec {
  float v[4];
};

// Row read at neighbour slot t of destination d, clamped to the table.
__device__ __forceinline__ int64_t nbr_row(const int32_t* __restrict__ idx, int64_t rows,
                                           int64_t num_dst, int fanout, int64_t d, int t) {
  const int64_t pos = num_dst + d * fanout + t;
  const int64_t r = idx == nullptr ? pos : int64_t(idx[pos]);
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

// Sums each of v[0..N) over the warp (N a power of two, at most 32).  At
// each of the first log2 N xor levels a lane keeps half its values and
// passes the other half to its partner; then plain xor levels.  Returns
// the total of value lane / (32 / N), which every lane with that quotient
// holds with the same bits.
template <int N>
__device__ __forceinline__ float warp_transpose_sum(float (&v)[N]) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0, "N a power of two up to 32");
  constexpr int kLog = N >= 32 ? 5 : N >= 16 ? 4 : N >= 8 ? 3 : N >= 4 ? 2 : N >= 2 ? 1 : 0;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int level = 0; level < kLog; ++level) {
    const int half = (N >> level) >> 1;
    const int m = 16 >> level;
    const bool upper = (lane & m) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      if (i < half) {
        const float send = upper ? v[i] : v[i + half];
        const float keep = upper ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
      }
    }
  }
  float t = v[0];
#pragma unroll
  for (int level = kLog; level < 5; ++level) t += __shfl_xor_sync(0xffffffffu, t, 16 >> level);
  return t;
}

// Sums vals[0..N) over the team: every thread of the team gets the same
// bits.  A wider team than one warp adds the warps' totals through shared
// memory in warp order.  Every thread of the block calls it the same
// number of times (the whole block shares one fanout), dead teams included.
template <int N>
__device__ __forceinline__ void team_sum(float (&vals)[N], int team_warps, int buf,
                                         float (*part)[kWarps][N]) {
  constexpr int kStride = 32 / N;  // lanes that hold each total
  const int lane = threadIdx.x & 31;
  float t = warp_transpose_sum<N>(vals);
  if (team_warps > 1) {
    const int warp = threadIdx.x / 32;
    if (lane % kStride == 0) part[buf][warp][lane / kStride] = t;
    __syncthreads();
    const int first = warp - warp % team_warps;
    float total = 0.0f;
    if (lane < N) {
      for (int w = 0; w < team_warps; ++w) total += part[buf][first + w][lane];
    }
    t = total;
#pragma unroll
    for (int k = 0; k < N; ++k) vals[k] = __shfl_sync(0xffffffffu, t, k);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) vals[k] = __shfl_sync(0xffffffffu, t, k * kStride);
  }
}

__device__ __forceinline__ float dot(const Vec& row, const Vec& q) {
  float acc = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) acc += row.v[e] * q.v[e];
  return acc;
}

template <int MAXH>
__global__ void __launch_bounds__(kThreads)
    dot_attend_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
                      const float* __restrict__ u, float* __restrict__ out, int64_t rows,
                      int64_t num_dst, int fanout, int64_t f, int heads, int team_warps) {
  constexpr int kSlots = kExchange / MAXH >= 1 ? kExchange / MAXH : 1;
  constexpr int kChunk = kSlots * MAXH;  // values a chunk exchanges
  __shared__ float part[2][kWarps][kChunk];
  const int64_t fv = f / 4;
  const int team_threads = 32 * team_warps;
  const int64_t col = threadIdx.x % team_threads;
  const int64_t d = int64_t(blockIdx.x) * (kThreads / team_threads) + threadIdx.x / team_threads;
  const bool live = d < num_dst;
  const bool col_ok = live && col < fv;
  const Vec* xv = reinterpret_cast<const Vec*>(x);
  const Vec* qv = reinterpret_cast<const Vec*>(u) + (live ? d : 0) * heads * fv;
  const Vec zero = {};

  Vec q[MAXH];
  float m[MAXH], s[MAXH];
  Vec acc[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    q[h] = (h < heads && col_ok) ? qv[h * fv + col] : zero;
    m[h] = -INFINITY;  // no slot yet: the first chunk's rescale is exp(-inf) = 0
    s[h] = 0.0f;
    acc[h] = zero;
  }

  int buf = 0;
  for (int j0 = 0; j0 < fanout; j0 += kSlots) {
    const int live_slots = min(kSlots, fanout - j0);  // the same for the whole block
    Vec rowv[kSlots];
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int64_t r = (live && t < live_slots) ? nbr_row(idx, rows, num_dst, fanout, d, j0 + t)
                                                 : 0;
      rowv[t] = (col_ok && t < live_slots) ? xv[r * fv + col] : zero;
    }
    float e[kChunk];
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
#pragma unroll
      for (int h = 0; h < MAXH; ++h) e[t * MAXH + h] = dot(rowv[t], q[h]);
    }
    team_sum<kChunk>(e, team_warps, buf, part);
    buf ^= 1;
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      float m_new = m[h];
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        if (t < live_slots) m_new = fmaxf(m_new, e[t * MAXH + h]);
      }
      const float scale = expf(m[h] - m_new);
      s[h] *= scale;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[h].v[c] *= scale;
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        if (t < live_slots) {
          const float p = expf(e[t * MAXH + h] - m_new);
          s[h] += p;
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[h].v[c] += p * rowv[t].v[c];
        }
      }
      m[h] = m_new;
    }
  }

  if (!col_ok) return;
  Vec* ov = reinterpret_cast<Vec*>(out);
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    if (h >= heads) break;
    Vec res;
#pragma unroll
    for (int c = 0; c < 4; ++c) res.v[c] = acc[h].v[c] / s[h];
    ov[(d * heads + h) * fv + col] = res;
  }
}

template <int MAXH>
void launch(const float* x, const int32_t* idx, const float* u, float* out, int64_t rows,
            int64_t num_dst, int fanout, int64_t f, int heads, int team_warps,
            cudaStream_t stream) {
  const int64_t per_block = kThreads / (32 * team_warps);
  const unsigned int grid = unsigned((num_dst + per_block - 1) / per_block);
  dot_attend_kernel<MAXH><<<grid, kThreads, 0, stream>>>(x, idx, u, out, rows, num_dst, fanout,
                                                         f, heads, team_warps);
}

}  // namespace

extern "C" {

// x: float32 [rows, f]; idx: int32 [num_dst * (1 + fanout)] or null (the
// dense form); u: float32 [num_dst, heads, f]; out: float32 [num_dst,
// heads, f]; x, u and out on 16-byte aligned bases.  f: a multiple of 4, at
// most 128 * team_warps.  team_warps: 1, 2, 4 or 8 warps per destination.
// heads: 1 to 8.
int dci_dot_attend(const void* x, const void* idx, const void* u, void* out, long long rows,
                   long long num_dst, int fanout, long long f, int heads, int team_warps,
                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* uf = static_cast<const float*>(u);
  float* of = static_cast<float*>(out);
  if (rows < 1 || fanout < 1 || f < 1 || f % 4 != 0 || heads < 1 || heads > 8) {
    return int(cudaErrorInvalidValue);
  }
  if (team_warps != 1 && team_warps != 2 && team_warps != 4 && team_warps != 8) {
    return int(cudaErrorInvalidValue);
  }
  if (int64_t(128) * team_warps < f) return int(cudaErrorInvalidValue);
  if (heads <= 4) {
    launch<4>(xf, ix, uf, of, rows, num_dst, fanout, f, heads, team_warps, st);
  } else {
    launch<8>(xf, ix, uf, of, rows, num_dst, fanout, f, heads, team_warps, st);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
