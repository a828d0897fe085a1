// GNN neighbourhood aggregation for Hopper (sm_90a), in two entries.
//
// 1. dci_seg_agg: [S, fanout, F] -> [S, F].  Replaces the Pallas TPU
// kernel `seg_agg` of the JAX reference (src/repro/kernels/seg_agg/kernel.py):
// the sum, or the mean, over the fanout axis of a dense sampled
// neighbourhood.  Mean divides the fp32 sum by the static fanout.  f32 and
// bf16 in, the same type out; the sum is always accumulated in fp32.
//
// What bounds it on an H100: bytes.  It reads S*fanout*F elements once and
// writes S*F once, with one add per element read, far below the ~295
// operations per byte where compute would take over.  The design answers
// that with one plain coalesced pass: one thread per group of V adjacent
// output elements along F, where V elements are one 16-, 8-, 4- or 2-byte
// vector (the widest that divides the row pitch and both base addresses,
// picked by the wrapper).  Neighbouring threads read neighbouring vectors
// of the same neighbour row, so each warp's load of one fanout slot is one
// contiguous span; the fanout loop (2-15 slots) runs in registers.  The
// Pallas kernel's (8, 512) VMEM tiling has no counterpart: nothing is
// staged in shared memory, because no element is read twice.
//
// 2. dci_seg_agg_indexed: a sampled GNN's first layer, read through an
// index.  It replaces no Pallas kernel: it fuses the reference's
// `input_feats[inverse_index]` (src/repro/models/gnn/models.py:79), which
// writes every duplicate row of the deepest frontier, with the self-and-
// fanout sum of that layer, so the duplicate-carrying tensor is never
// written.  A row table x[R, F] (float32) holds the frontier's distinct
// rows; idx[num_dst * (1 + fanout)] (int32) maps the [self | neighbours]
// layout of sample_blocks onto them, or is null (row i is position i, the
// dense form).  Destination d's self row is x[idx[d]], its neighbours
// x[idx[num_dst + d*fanout + j]].  Mode sage writes the self row (not in
// the dense form, whose self rows are x's first num_dst rows as they
// stand) and the neighbour sum, mode gcn (self + sum) / (fanout + 1); the
// sum is taken in fp32 from zero, j ascending.  Indices are clamped to
// [0, R): the kernel reads no row outside the table, whatever it is given.
//
// What bounds it: bytes again, and worse than in (1), since every read is
// a row chosen at random.  At batch 4096 and fan-outs 15,10,5 it reads
// 4.3 M rows (10.4 GB at Reddit's 2,408-byte rows) and writes 270 K.  What
// the design does about it:
// - One destination row per warp.  Its lanes load the row's indices
//   once, one per lane, and hand them round with warp shuffles; no index
//   is read twice from memory.
// - Each lane walks F in the widest vector that divides the row pitch and
//   both base addresses (16 B for 400-byte rows, 8 B for 2,408-byte
//   ones): a warp's load of one neighbour row is one contiguous span.
// - The neighbour loop is unrolled in chunks of kSlots: all of a chunk's
//   loads of one vector column are issued before the first add, so up to
//   kSlots random rows per lane are in flight.  These reads are latency-
//   bound, and memory-level parallelism is what hides the latency.
// - A row narrower than 32 vectors leaves lanes idle.  No configuration
//   has one: every dataset's F (100 to 602 floats) gives at least 25.
// - No atomics and no shared memory: every run gives the same bits.
//
// F need not be a multiple of anything (reddit's 602 gives 8-byte f32
// vectors); offsets are 64-bit.
//
// The entry points launch on the given stream and return
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

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

// Thread t owns output vector t: row s = t / fv, vector column c = t % fv,
// where fv = F / V vectors per row.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    seg_agg_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t s, int fanout,
                   int64_t f, int mean) {
  const int64_t fv = f / V;
  const int64_t t = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= s * fv) return;
  const int64_t row = t / fv;
  const int64_t col = t % fv;
  const Vec<T, V>* src = reinterpret_cast<const Vec<T, V>*>(x) + row * fanout * fv + col;
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.0f;
  for (int k = 0; k < fanout; ++k) {
    const Vec<T, V> in = src[int64_t(k) * fv];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] += to_f(in.v[e]);
  }
  Vec<T, V> res;
  const float n = float(fanout);
#pragma unroll
  for (int e = 0; e < V; ++e) res.v[e] = from_f<T>(mean ? acc[e] / n : acc[e]);
  reinterpret_cast<Vec<T, V>*>(out)[row * fv + col] = res;
}

template <typename T, int V>
void launch(const void* x, void* out, int64_t s, int fanout, int64_t f, int mean,
            cudaStream_t stream) {
  const int64_t n = s * (f / V);
  const unsigned int grid = unsigned((n + kThreads - 1) / kThreads);
  seg_agg_kernel<T, V><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                      static_cast<T*>(out), s, fanout, f, mean);
}

template <typename T>
int dispatch(int vec_bytes, const void* x, void* out, int64_t s, int fanout, int64_t f,
             int mean, cudaStream_t stream) {
  switch (vec_bytes / int(sizeof(T))) {
    case 8: launch<T, 8>(x, out, s, fanout, f, mean, stream); break;
    case 4: launch<T, 4>(x, out, s, fanout, f, mean, stream); break;
    case 2: launch<T, 2>(x, out, s, fanout, f, mean, stream); break;
    case 1: launch<T, 1>(x, out, s, fanout, f, mean, stream); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}


// ---------------------------------------------------------------- indexed form

constexpr int kIndexedThreads = 256;
// Neighbour loads per lane in flight, per chunk.  8 and not 16: 16 vectors
// of 16 B kept 143 registers a thread, so an SM held 8 warps, and the
// layer took 1.6x as long at Reddit's shape (4, 8 and 16 timed on the H100).
constexpr int kSlots = 8;

// Row read at index slot j of destination d: j = 0 is the self row, slot
// j >= 1 neighbour j - 1.  Clamped to the table.
__device__ __forceinline__ int64_t slot_row(const int32_t* __restrict__ idx, int64_t rows,
                                            int64_t num_dst, int fanout, int64_t d, int j) {
  const int64_t pos = j == 0 ? d : num_dst + d * fanout + (j - 1);
  const int64_t r = idx == nullptr ? pos : int64_t(idx[pos]);
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

// A warp owns destination d; lane l owns vector columns l, l + 32, ...
// For each chunk of kSlots neighbour slots the warp takes the chunk's row
// numbers by shuffles from the lanes that fetched them: lane l fetches
// slot j0 + l once every 32 slots.
template <int V, bool kGcn>
__global__ void __launch_bounds__(kIndexedThreads)
    seg_agg_indexed_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
                           float* __restrict__ out_self, float* __restrict__ out_agg,
                           int64_t rows, int64_t num_dst, int fanout, int64_t f) {
  static_assert(32 % kSlots == 0, "a chunk of slots lies within one fetch");
  using VecT = Vec<float, V>;
  const int64_t fv = f / V;
  const int l = threadIdx.x & 31;
  const int64_t d = int64_t(blockIdx.x) * (kIndexedThreads / 32) + threadIdx.x / 32;
  if (d >= num_dst) return;  // the whole warp leaves together
  const VecT* xv = reinterpret_cast<const VecT*>(x);
  const int64_t self_row = slot_row(idx, rows, num_dst, fanout, d, 0);

  int64_t held = 0;  // the row number of slot j0 - j0 % 32 + l
  // Every lane makes the same passes, since the shuffles need them all; a
  // lane past the row's last vector loads and stores nothing.
  for (int64_t c0 = 0; c0 < fv; c0 += 32) {
    const int64_t c = c0 + l;
    const bool live = c < fv;
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.0f;
    VecT self_v;
    if (live && (kGcn || out_self != nullptr)) self_v = xv[self_row * fv + c];
    for (int j0 = 0; j0 < fanout; j0 += kSlots) {
      if (j0 % 32 == 0) {
        const int j = j0 + l;
        held = j < fanout ? slot_row(idx, rows, num_dst, fanout, d, j + 1) : 0;
      }
      VecT buf[kSlots];
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int64_t r = __shfl_sync(0xffffffffu, held, (j0 % 32) + k);
        if (live && j0 + k < fanout) buf[k] = xv[r * fv + c];
      }
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (live && j0 + k < fanout) {
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] += buf[k].v[e];
        }
      }
    }
    if (!live) continue;
    VecT res;
    if (kGcn) {
      const float n = float(fanout + 1);
#pragma unroll
      for (int e = 0; e < V; ++e) res.v[e] = (self_v.v[e] + acc[e]) / n;
    } else {
      if (out_self != nullptr) reinterpret_cast<VecT*>(out_self)[d * fv + c] = self_v;
#pragma unroll
      for (int e = 0; e < V; ++e) res.v[e] = acc[e];
    }
    reinterpret_cast<VecT*>(out_agg)[d * fv + c] = res;
  }
}

template <int V>
void launch_indexed(const float* x, const int32_t* idx, float* out_self, float* out_agg,
                    int64_t rows, int64_t num_dst, int fanout, int64_t f, int gcn,
                    cudaStream_t stream) {
  constexpr int64_t kPerBlock = kIndexedThreads / 32;
  const unsigned int grid = unsigned((num_dst + kPerBlock - 1) / kPerBlock);
  if (gcn) {
    seg_agg_indexed_kernel<V, true>
        <<<grid, kIndexedThreads, 0, stream>>>(x, idx, out_self, out_agg, rows, num_dst, fanout, f);
  } else {
    seg_agg_indexed_kernel<V, false>
        <<<grid, kIndexedThreads, 0, stream>>>(x, idx, out_self, out_agg, rows, num_dst, fanout, f);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  vec_bytes: the vector width in bytes,
// a multiple of the element size that divides F's row pitch and both base
// addresses (at most 16).  mean: 0 = sum, 1 = mean.
int dci_seg_agg(const void* x, void* out, long long s, int fanout, long long f, int dtype,
                int vec_bytes, int mean, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec_bytes > 16) return int(cudaErrorInvalidValue);
  if (dtype == 0) return dispatch<float>(vec_bytes, x, out, s, fanout, f, mean, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(vec_bytes, x, out, s, fanout, f, mean, st);
  return int(cudaErrorInvalidValue);
}

// x: float32 [rows, f]; idx: int32 [num_dst * (1 + fanout)] or null (the
// dense form).  gcn: 0 = sage (out_self gets the self rows, out_agg the
// neighbour sums; a null out_self skips the self rows, which the dense
// form's caller reads in place), 1 = gcn (out_agg gets the mean, out_self
// is unused).
// vec_bytes: 16, 8 or 4, dividing f's row pitch and every base address.
int dci_seg_agg_indexed(const void* x, const void* idx, void* out_self, void* out_agg,
                        long long rows, long long num_dst, int fanout, long long f,
                        int vec_bytes, int gcn, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  float* os = static_cast<float*>(out_self);
  float* oa = static_cast<float*>(out_agg);
  if (rows < 1 || fanout < 1 || f < 1) return int(cudaErrorInvalidValue);
  switch (vec_bytes) {
    case 16: launch_indexed<4>(xf, ix, os, oa, rows, num_dst, fanout, f, gcn, st); break;
    case 8: launch_indexed<2>(xf, ix, os, oa, rows, num_dst, fanout, f, gcn, st); break;
    case 4: launch_indexed<1>(xf, ix, os, oa, rows, num_dst, fanout, f, gcn, st); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
