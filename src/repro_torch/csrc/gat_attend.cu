// GAT's attention over a sampled block, for Hopper (sm_90a).
//
// dci_gat_attend replaces no Pallas kernel: the JAX reference has no GAT.
// It computes, for each destination d and head k of a GAT layer, the
// softmax-weighted sum of the layer's INPUT rows over d's own row (slot 0)
// and its fanout sampled neighbours (slots 1..fanout):
//
//   e_j   = LeakyReLU(x_d . u_dst[k] + x_j . u_src[k])
//   out_k = sum_j softmax_j(e_j) x_j                      [num_dst, H, F]
//
// u = W_k a_k is the score vector folded through the head's map, so a
// score costs one dot of length F and the head's projection runs once, on
// out_k, as a batched matmul after this kernel (models/gnn/models.py).
// x[R, F] (float32) holds rows; idx[num_dst * (1 + fanout)] (int32) maps
// the [self | neighbours] layout of sample_blocks onto them (a sampled
// layer 0 reads the frontier's distinct rows through the dedup inverse
// map), or is null: position i is row i (the dense form, layers 1 and up
// and the routes without dedup).  Indices are clamped to [0, R).
//
// What bounds it on an H100: at layer 0 (270,336 destinations x 16 rows
// of 100 floats at batch 4096 and fan-outs 15,10,5) bytes read as random
// rows, as in seg_agg_indexed; at layers 1-2 (1,024-float rows in place)
// bytes read in order.  The operations (two multiply-adds per element and
// head: the score's dot and the weighted sum) stay far below the ~20 per
// byte where float32 compute would take over, but the scores' sums across
// a row's threads and the exponentials come on top of the loads.  The
// design:
// - A team of G warps (G = 1, 2, 4 or 8, picked by the wrapper from F)
//   owns one destination; thread t of the team owns the row's 16-byte
//   vector t.  A 100-float row is one warp's 25 lanes; a 1,024-float row
//   is one 256-thread block's.  The wrapper takes rows of a multiple of 4
//   floats, at most 1,024, on 16-byte aligned bases, which is every row
//   the configurations have.
// - The slots go a chunk at a time: a chunk's rows are loaded before the
//   first of them is used, then the chunk's rows x H partial dots are
//   summed across the team in one exchange: a transposing xor reduction
//   in the warp (each level passes half the values on, so N values take
//   N - 1 shuffles, not 5N), then N shuffles that hand the totals round; a
//   team of more warps also adds the warps' totals through shared memory
//   in warp order, one barrier a chunk, double-buffered by chunk parity.
//   Every thread of the team ends with the same bits.
// - Softmax with a running maximum over the slots in order (the online
//   form of flash attention): per chunk the maximum grows once, the
//   weighted sum of the rows seen so far is rescaled once, and each row
//   is added with its weight, so every row is read once.
// - u_src stays in registers for the whole destination; u_dst is read once.
// - No atomics: every run gives the same bits, and the indexed and the
//   dense form of the same rows give the same bits.
//
// The entry point launches on the given stream and returns
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Partial dots a chunk exchanges: a chunk is kExchange / MAXH neighbour
// rows (2 at up to 4 heads, 1 at up to 8), loaded together and scored in
// one exchange.  8 against 16 and 32, timed on the H100 at the GAT cell's
// three layers: 1.43, 0.92 and 0.22 ms against 1.58, 1.03, 0.34 and
// 1.49, 1.10, 0.32 (more values a chunk hold more registers a thread).
constexpr int kExchange = 8;

struct alignas(16) Vec {
  float v[4];
};

// Row read at slot j of destination d: j = 0 is the self row, slot j >= 1
// neighbour j - 1.  Clamped to the table.
__device__ __forceinline__ int64_t slot_row(const int32_t* __restrict__ idx, int64_t rows,
                                            int64_t num_dst, int fanout, int64_t d, int j) {
  const int64_t pos = j == 0 ? d : num_dst + d * fanout + (j - 1);
  const int64_t r = idx == nullptr ? pos : int64_t(idx[pos]);
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

// Sums each of v[0..N) over the warp (N a power of two, at most 32).  At
// each of the first log2 N xor levels a lane keeps half its values and
// passes the other half to its partner; then plain xor levels.  Returns
// the total of value lane / (32 / N), which every lane with that quotient
// holds with the same bits.  Every loop has a constant trip count, so the
// values stay in registers.
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
// bits.  A one-warp team hands the totals round by shuffles; a wider team
// puts each warp's totals in shared memory, and lane k of every warp adds
// value k over the team's warps in warp order and hands it round.  Every
// thread of the block calls it the same number of times (the whole block
// shares one fanout), dead teams included.  part holds one row of S >= N
// floats per warp and buffer.
template <int N, int S>
__device__ __forceinline__ void team_sum(float (&vals)[N], int team_warps, int buf,
                                         float (*part)[kWarps][S]) {
  static_assert(N <= S, "the exchange row holds every value");
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

__device__ __forceinline__ float dot(const Vec& row, const Vec& u) {
  float acc = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) acc += row.v[e] * u.v[e];
  return acc;
}

__device__ __forceinline__ float leaky(float e, float slope) { return e > 0.0f ? e : e * slope; }

template <int MAXH>
__global__ void __launch_bounds__(kThreads)
    gat_attend_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
                      const float* __restrict__ u, float* __restrict__ out, int64_t rows,
                      int64_t num_dst, int fanout, int64_t f, int heads, float slope,
                      int team_warps) {
  constexpr int kSlots = kExchange / MAXH >= 1 ? kExchange / MAXH : 1;
  constexpr int kChunk = kSlots * MAXH;  // values a chunk exchanges
  constexpr int kRow = kChunk > 2 * MAXH ? kChunk : 2 * MAXH;  // and slot 0's
  __shared__ float part[2][kWarps][kRow];
  const int64_t fv = f / 4;
  const int team_threads = 32 * team_warps;
  const int64_t col = threadIdx.x % team_threads;
  const int64_t d = int64_t(blockIdx.x) * (kThreads / team_threads) + threadIdx.x / team_threads;
  const bool live = d < num_dst;
  const bool col_ok = live && col < fv;
  const Vec* xv = reinterpret_cast<const Vec*>(x);
  const Vec* usrc = reinterpret_cast<const Vec*>(u);
  const Vec* udst = usrc + int64_t(heads) * fv;
  const Vec zero = {};

  Vec us[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) us[h] = (h < heads && col_ok) ? usrc[h * fv + col] : zero;

  // Slot 0: the destination's own row gives both score halves.
  const int64_t self_row = live ? slot_row(idx, rows, num_dst, fanout, d, 0) : 0;
  const Vec self_v = col_ok ? xv[self_row * fv + col] : zero;
  float both[2 * MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    const Vec ud = (h < heads && col_ok) ? udst[h * fv + col] : zero;
    both[h] = dot(self_v, ud);
    both[MAXH + h] = dot(self_v, us[h]);
  }
  team_sum<2 * MAXH, kRow>(both, team_warps, 0, part);

  float sd[MAXH], m[MAXH], s[MAXH];
  Vec acc[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    sd[h] = both[h];
    m[h] = leaky(both[h] + both[MAXH + h], slope);
    s[h] = 1.0f;  // exp(e - m) of the self row
    acc[h] = self_v;
  }

  int buf = 1;
  for (int j0 = 0; j0 < fanout; j0 += kSlots) {
    const int live_slots = min(kSlots, fanout - j0);  // the same for the whole block
    Vec rowv[kSlots];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int64_t r = (live && q < live_slots) ? slot_row(idx, rows, num_dst, fanout, d, j0 + q + 1)
                                                 : 0;
      rowv[q] = (col_ok && q < live_slots) ? xv[r * fv + col] : zero;
    }
    float ss[kChunk];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
#pragma unroll
      for (int h = 0; h < MAXH; ++h) ss[q * MAXH + h] = dot(rowv[q], us[h]);
    }
    team_sum<kChunk, kRow>(ss, team_warps, buf, part);
    buf ^= 1;
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      float e[kSlots];
      float m_new = m[h];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        e[q] = leaky(sd[h] + ss[q * MAXH + h], slope);
        if (q < live_slots) m_new = fmaxf(m_new, e[q]);
      }
      const float scale = expf(m[h] - m_new);
      s[h] *= scale;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[h].v[c] *= scale;
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        if (q < live_slots) {
          const float p = expf(e[q] - m_new);
          s[h] += p;
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[h].v[c] += p * rowv[q].v[c];
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
            int64_t num_dst, int fanout, int64_t f, int heads, float slope, int team_warps,
            cudaStream_t stream) {
  const int64_t per_block = kThreads / (32 * team_warps);
  const unsigned int grid = unsigned((num_dst + per_block - 1) / per_block);
  gat_attend_kernel<MAXH><<<grid, kThreads, 0, stream>>>(x, idx, u, out, rows, num_dst, fanout,
                                                         f, heads, slope, team_warps);
}

}  // namespace

extern "C" {

// x: float32 [rows, f]; idx: int32 [num_dst * (1 + fanout)] or null (the
// dense form); u: float32 [2, heads, f], u_src then u_dst; out: float32
// [num_dst, heads, f]; x, u and out on 16-byte aligned bases.  f: a
// multiple of 4, at most 128 * team_warps.  team_warps: 1, 2, 4 or 8 warps
// per destination.  heads: 1 to 8.
int dci_gat_attend(const void* x, const void* idx, const void* u, void* out, long long rows,
                   long long num_dst, int fanout, long long f, int heads, float slope,
                   int team_warps, void* stream) {
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
    launch<4>(xf, ix, uf, of, rows, num_dst, fanout, f, heads, slope, team_warps, st);
  } else {
    launch<8>(xf, ix, uf, of, rows, num_dst, fanout, f, heads, slope, team_warps, st);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
