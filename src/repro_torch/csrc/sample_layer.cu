// One layer of DCI's neighbour sampling for Hopper (sm_90a), in one launch.
//
// dci_sample_layer replaces no Pallas kernel: the JAX reference samples in
// plain jnp ops (src/repro/graph/sampling.py, sample_neighbors), which XLA
// fuses.  Eager PyTorch runs the same arithmetic as some 36 launches a
// layer, and at batch 4096 their host cost, not the card, paced the
// sampled path.  For every draw (seed s, slot j) of a layer it does what
// kernels/sample_layer/ref.py does in torch ops:
//
//   v = seeds[s]; start = col_ptr[v]; deg = col_ptr[v + 1] - start
//   r = min(trunc(u[s, j] * max(deg, 1)), max(deg, 1) - 1)   (or r given)
//   edge_slots[s, j] = start + r                              (unclamped)
//   hit[s, j] = r < cached_len[v]
//   nbr[s * fanout + j] = hit ? cache_row_index[cache_ptr[v] + r]
//                             : row_index[start + r]
//   deg == 0: nbr = v, hit = 1 (an isolated node loops to itself)
//
// and adds the layer's hits to an int64 total.  The product is __dmul_rn,
// the float64 product torch computes (no contraction), and the truncation
// the cast torch makes, so the same u give the same r, bit for bit.  Reads
// clamp as the plain version's do: the row_index read to [0, E) (a
// trailing isolated node's slot is E), the cache read to the cache's
// length; seed ids to [0, N) (the plain version raises on one outside).
//
// What bounds it on an H100: bytes, and most of them random.  At the last
// layer of batch 4096 at fan-outs 15,10,5 (270,336 seeds x 15 draws) it
// reads each seed's id, node range, cached length and cache offset (20
// bytes), each draw's u (8) and ONE neighbour id, from the cached list on
// a hit and from the full list on a miss (4), and writes the neighbour,
// the hit flag and the slot (9): about 90 MB, 27 us at 3.35 TB/s, though
// a random 4-byte read costs a 32-byte sector.  The plain version reads
// both lists for every draw and writes each intermediate to memory.  The
// design:
// - One thread a draw, draws in row-major order: the reads of u and the
//   writes of the three outputs are coalesced, and the fanout threads of
//   one seed read its node range from the same addresses, one transaction
//   for the warp.
// - The neighbour goes straight into the tail of the frontier buffer
//   (sample_blocks lays frontier l+1 out as [frontier l | neighbours]), so
//   no concatenation follows.
// - The hit total: a warp ballot, the warps' counts summed in shared
//   memory, one atomicAdd a block.  Integer adds, so the total is exact
//   whatever order the blocks run in.
//
// The entry point launches on the given stream and returns
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// kDrawn: the draws are uniforms u in [0, 1) (float64); else slots r (int32).
template <bool kDrawn>
__global__ void __launch_bounds__(kThreads)
    sample_layer_kernel(const int32_t* __restrict__ col_ptr, int64_t num_nodes,
                        const int32_t* __restrict__ row_index, int64_t num_edges,
                        const int32_t* __restrict__ cache_ptr,
                        const int32_t* __restrict__ cache_row_index, int64_t cache_rows,
                        const int32_t* __restrict__ cached_len, const int32_t* __restrict__ seeds,
                        int64_t draws, int fanout, const double* __restrict__ u,
                        const int32_t* __restrict__ r_in, int32_t* __restrict__ nbr,
                        uint8_t* __restrict__ hit, int32_t* __restrict__ slots,
                        unsigned long long* __restrict__ hit_count) {
  __shared__ int warp_hits[kWarps];
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  bool is_hit = false;
  if (i < draws) {
    const int32_t v = seeds[i / fanout];
    const int64_t node = clamp_index(v, num_nodes);
    const int32_t start = col_ptr[node];
    const int32_t deg = col_ptr[node + 1] - start;
    const int32_t d = deg > 1 ? deg : 1;
    int32_t r;
    if (kDrawn) {
      const long long t = static_cast<long long>(__dmul_rn(u[i], double(d)));
      r = int32_t(t < d - 1 ? t : d - 1);
    } else {
      r = r_in[i];
    }
    const int32_t slot = int32_t(uint32_t(start) + uint32_t(r));
    int32_t out;
    if (deg == 0) {
      out = v;
      is_hit = true;
    } else {
      is_hit = r < cached_len[node];
      out = is_hit ? cache_row_index[clamp_index(int64_t(cache_ptr[node]) + r, cache_rows)]
                   : row_index[clamp_index(slot, num_edges)];
    }
    nbr[i] = out;
    hit[i] = is_hit ? 1 : 0;
    slots[i] = slot;
  }
  // Every thread of the block reaches the ballot and the barrier.
  const unsigned int ballot = __ballot_sync(0xffffffffu, is_hit);
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_hits[threadIdx.x / 32] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x < 32) {
    int h = lane < kWarps ? warp_hits[lane] : 0;
#pragma unroll
    for (int offset = kWarps / 2; offset > 0; offset /= 2) {
      h += __shfl_down_sync(0xffffffffu, h, offset);
    }
    if (lane == 0 && h > 0) atomicAdd(hit_count, static_cast<unsigned long long>(h));
  }
}

}  // namespace

extern "C" {

// col_ptr: int32 [num_nodes + 1]; row_index: int32 [num_edges];
// cache_ptr: int32 [num_nodes + 1]; cache_row_index: int32 [cache_rows];
// cached_len: int32 [num_nodes]; seeds: int32 [num_seeds]; exactly one of
// u (float64) and r (int32), [num_seeds, fanout]; nbr, slots: int32 and
// hit: uint8, [num_seeds, fanout]; hit_count: one int64, added to.
int dci_sample_layer(const void* col_ptr, long long num_nodes, const void* row_index,
                     long long num_edges, const void* cache_ptr, const void* cache_row_index,
                     long long cache_rows, const void* cached_len, const void* seeds,
                     long long num_seeds, int fanout, const void* u, const void* r, void* nbr,
                     void* hit, void* slots, void* hit_count, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_nodes < 1 || num_edges < 0 || cache_rows < 1 || num_seeds < 0 || fanout < 1 ||
      (u == nullptr) == (r == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  const int64_t draws = int64_t(num_seeds) * fanout;
  if (draws == 0) return int(cudaGetLastError());
  const unsigned int grid = unsigned((draws + kThreads - 1) / kThreads);
  const int32_t* cp = static_cast<const int32_t*>(col_ptr);
  const int32_t* ri = static_cast<const int32_t*>(row_index);
  const int32_t* kp = static_cast<const int32_t*>(cache_ptr);
  const int32_t* kr = static_cast<const int32_t*>(cache_row_index);
  const int32_t* cl = static_cast<const int32_t*>(cached_len);
  const int32_t* sd = static_cast<const int32_t*>(seeds);
  int32_t* nb = static_cast<int32_t*>(nbr);
  uint8_t* ht = static_cast<uint8_t*>(hit);
  int32_t* sl = static_cast<int32_t*>(slots);
  unsigned long long* hc = static_cast<unsigned long long*>(hit_count);
  if (u != nullptr) {
    sample_layer_kernel<true><<<grid, kThreads, 0, st>>>(
        cp, num_nodes, ri, num_edges, kp, kr, cache_rows, cl, sd, draws, fanout,
        static_cast<const double*>(u), nullptr, nb, ht, sl, hc);
  } else {
    sample_layer_kernel<false><<<grid, kThreads, 0, st>>>(
        cp, num_nodes, ri, num_edges, kp, kr, cache_rows, cl, sd, draws, fanout, nullptr,
        static_cast<const int32_t*>(r), nb, ht, sl, hc);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
