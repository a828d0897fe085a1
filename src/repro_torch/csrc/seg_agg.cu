// GNN neighbourhood aggregation for Hopper (sm_90a): [S, fanout, F] -> [S, F].
//
// Replaces the Pallas TPU kernel `seg_agg` of the JAX reference
// (src/repro/kernels/seg_agg/kernel.py): the sum, or the mean, over the
// fanout axis of a dense sampled neighbourhood.  Mean divides the fp32 sum
// by the static fanout.  f32 and bf16 in, the same type out; the sum is
// always accumulated in fp32.
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
// F need not be a multiple of anything (reddit's 602 gives 8-byte f32
// vectors); offsets are 64-bit.
//
// The entry point launches on the given stream and returns
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

}  // extern "C"
