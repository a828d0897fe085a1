// DCI's two-source cached row gather for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of the JAX reference in
// src/repro/kernels/cached_gather/kernel.py:
//   dci_cached_gather        <- _cached_gather_db      (per-row copy)
//   dci_cached_gather_blocks <- _cached_gather_blocks  (row-block runs)
//   dci_cached_gather_select <- cached_gather_select   (read both, select)
//
// Every kernel computes the same function:
//   out[i] = hot[clamp(pos[i], 0, H-1)]   if pos[i] >= 0   (raw position)
//          = host[clamp(idx[i], 0, N-1)]  otherwise
// It is a pure copy, so the kernels are type-agnostic over row bytes: f32
// and bf16 rows share them, and the caller picks the vector width (16, 8,
// 4, 2 or 1 bytes) from the row pitch and the three base pointers.  A
// 602-float row (reddit) is 2,408 bytes: 8-byte aligned, not 16.
//
// What bounds them on an H100: bytes.  Hit rows are read from device
// memory (3.35 TB/s), miss rows from the host table, which is pinned host
// memory read in place over UVA (PCIe Gen5 x16, 64 GB/s each way) or a
// device tensor, and every output row is written once to device memory.
// With any real miss share the PCIe reads dominate.  The simple design
// answers that by copying each row from its winning source only (the
// select kernel reads both and is the baseline), with the widest vector
// the pitch allows, one warp per row so that many independent row reads
// are in flight at once.  The TPU kernels' gather_buffers VMEM-slot
// schedule has no counterpart here: the wrapper validates the argument and
// the output does not depend on it.  TMA and tuning are later work.
//
// Row offsets are computed in 64 bits: ogbn-papers100m at full size holds
// 14.2 G feature elements.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // 8 warps per CTA
constexpr int kWarpsPerCta = kThreads / kWarp;

template <typename V>
__device__ __forceinline__ void copy_vecs(char* __restrict__ dst, const char* __restrict__ src,
                                          int64_t n_vec, int64_t first, int64_t stride) {
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
#pragma unroll 4
  for (int64_t k = first; k < n_vec; k += stride) d[k] = s[k];
}

__device__ __forceinline__ const char* winning_row(const char* hot, const char* host,
                                                   const int32_t* idx, const int32_t* pos,
                                                   int64_t row, int64_t row_bytes, int64_t n_hot,
                                                   int64_t n_host) {
  const int64_t p = pos[row];
  if (p >= 0) return hot + min(p, n_hot - 1) * row_bytes;
  const int64_t i = idx[row];
  return host + max(int64_t(0), min(i, n_host - 1)) * row_bytes;
}

// #1: one warp per output row, copying from the winning source only.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const char* __restrict__ hot, const char* __restrict__ host,
                       const int32_t* __restrict__ idx, const int32_t* __restrict__ pos,
                       char* __restrict__ out, int64_t s, int64_t row_bytes, int64_t n_hot,
                       int64_t n_host) {
  const int64_t row = int64_t(blockIdx.x) * kWarpsPerCta + (threadIdx.x / kWarp);
  if (row >= s) return;
  const char* src = winning_row(hot, host, idx, pos, row, row_bytes, n_hot, n_host);
  copy_vecs<V>(out + row * row_bytes, src, row_bytes / int64_t(sizeof(V)), threadIdx.x % kWarp,
               kWarp);
}

// #2: one CTA per block of row_block output rows.  blk_mode (classified by
// the wrapper with the reference's rule): 1 = the rows are consecutive hot
// rows, 2 = consecutive host rows, both copied as ONE contiguous span of
// n_rows * row_bytes bytes by the whole CTA; 0 = per-row copies, one warp
// per row.  The ragged last block is masked here (it is always mode 0).
template <typename V>
__global__ void __launch_bounds__(kThreads)
    gather_blocks_kernel(const char* __restrict__ hot, const char* __restrict__ host,
                         const int32_t* __restrict__ idx, const int32_t* __restrict__ pos,
                         const int32_t* __restrict__ blk_mode,
                         const int32_t* __restrict__ blk_start, char* __restrict__ out, int64_t s,
                         int64_t row_bytes, int64_t n_hot, int64_t n_host, int64_t row_block) {
  const int64_t b = blockIdx.x;
  const int64_t row0 = b * row_block;
  const int64_t n_rows = min(row_block, s - row0);
  const int mode = blk_mode[b];
  if (mode != 0) {
    const char* base = mode == 1 ? hot : host;
    const char* src = base + int64_t(blk_start[b]) * row_bytes;
    copy_vecs<V>(out + row0 * row_bytes, src, n_rows * row_bytes / int64_t(sizeof(V)),
                 threadIdx.x, kThreads);
    return;
  }
  const int64_t n_vec = row_bytes / int64_t(sizeof(V));
  for (int64_t r = threadIdx.x / kWarp; r < n_rows; r += kWarpsPerCta) {
    const int64_t row = row0 + r;
    const char* src = winning_row(hot, host, idx, pos, row, row_bytes, n_hot, n_host);
    copy_vecs<V>(out + row * row_bytes, src, n_vec, threadIdx.x % kWarp, kWarp);
  }
}

// #3: one warp per output row.  Like the TPU select kernel, it stages BOTH
// candidate rows (through shared memory, one warp-wide chunk at a time)
// and writes the one the raw position selects: twice the reads of #1.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    gather_select_kernel(const char* __restrict__ hot, const char* __restrict__ host,
                         const int32_t* __restrict__ idx, const int32_t* __restrict__ pos,
                         char* __restrict__ out, int64_t s, int64_t row_bytes, int64_t n_hot,
                         int64_t n_host) {
  __shared__ V stage[kWarpsPerCta][2][kWarp];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t row = int64_t(blockIdx.x) * kWarpsPerCta + warp;
  if (row >= s) return;
  const int64_t p = pos[row];
  const int64_t i = idx[row];
  const V* hs =
      reinterpret_cast<const V*>(hot + max(int64_t(0), min(p, n_hot - 1)) * row_bytes);
  const V* ms =
      reinterpret_cast<const V*>(host + max(int64_t(0), min(i, n_host - 1)) * row_bytes);
  V* d = reinterpret_cast<V*>(out + row * row_bytes);
  const int pick = p >= 0 ? 0 : 1;
  const int64_t n_vec = row_bytes / int64_t(sizeof(V));
  for (int64_t k0 = 0; k0 < n_vec; k0 += kWarp) {
    const int64_t k = k0 + lane;
    if (k < n_vec) {
      stage[warp][0][lane] = hs[k];
      stage[warp][1][lane] = ms[k];
    }
    __syncwarp();
    if (k < n_vec) d[k] = stage[warp][pick][lane];
    __syncwarp();
  }
}

template <template <typename> class Launch, typename... Args>
int dispatch(int vec_bytes, Args... args) {
  switch (vec_bytes) {
    case 16: Launch<uint4>::run(args...); break;
    case 8: Launch<uint2>::run(args...); break;
    case 4: Launch<uint32_t>::run(args...); break;
    case 2: Launch<uint16_t>::run(args...); break;
    case 1: Launch<uint8_t>::run(args...); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

unsigned int row_grid(int64_t s) { return unsigned((s + kWarpsPerCta - 1) / kWarpsPerCta); }

template <typename V>
struct LaunchRows {
  static void run(const char* hot, const char* host, const int32_t* idx, const int32_t* pos,
                  char* out, int64_t s, int64_t row_bytes, int64_t n_hot, int64_t n_host,
                  cudaStream_t stream) {
    gather_rows_kernel<V><<<row_grid(s), kThreads, 0, stream>>>(hot, host, idx, pos, out, s,
                                                                 row_bytes, n_hot, n_host);
  }
};

template <typename V>
struct LaunchSelect {
  static void run(const char* hot, const char* host, const int32_t* idx, const int32_t* pos,
                  char* out, int64_t s, int64_t row_bytes, int64_t n_hot, int64_t n_host,
                  cudaStream_t stream) {
    gather_select_kernel<V><<<row_grid(s), kThreads, 0, stream>>>(hot, host, idx, pos, out, s,
                                                                   row_bytes, n_hot, n_host);
  }
};

template <typename V>
struct LaunchBlocks {
  static void run(const char* hot, const char* host, const int32_t* idx, const int32_t* pos,
                  const int32_t* blk_mode, const int32_t* blk_start, char* out, int64_t s,
                  int64_t row_bytes, int64_t n_hot, int64_t n_host, int64_t row_block,
                  cudaStream_t stream) {
    const unsigned int n_blocks = unsigned((s + row_block - 1) / row_block);
    gather_blocks_kernel<V><<<n_blocks, kThreads, 0, stream>>>(
        hot, host, idx, pos, blk_mode, blk_start, out, s, row_bytes, n_hot, n_host, row_block);
  }
};

}  // namespace

extern "C" {

int dci_cached_gather(const void* hot, const void* host, const void* idx, const void* pos,
                      void* out, long long s, long long row_bytes, long long n_hot,
                      long long n_host, int vec_bytes, void* stream) {
  return dispatch<LaunchRows>(vec_bytes, static_cast<const char*>(hot),
                              static_cast<const char*>(host), static_cast<const int32_t*>(idx),
                              static_cast<const int32_t*>(pos), static_cast<char*>(out),
                              int64_t(s), int64_t(row_bytes), int64_t(n_hot), int64_t(n_host),
                              static_cast<cudaStream_t>(stream));
}

int dci_cached_gather_select(const void* hot, const void* host, const void* idx,
                             const void* pos, void* out, long long s, long long row_bytes,
                             long long n_hot, long long n_host, int vec_bytes, void* stream) {
  return dispatch<LaunchSelect>(vec_bytes, static_cast<const char*>(hot),
                                static_cast<const char*>(host), static_cast<const int32_t*>(idx),
                                static_cast<const int32_t*>(pos), static_cast<char*>(out),
                                int64_t(s), int64_t(row_bytes), int64_t(n_hot), int64_t(n_host),
                                static_cast<cudaStream_t>(stream));
}

int dci_cached_gather_blocks(const void* hot, const void* host, const void* idx,
                             const void* pos, const void* blk_mode, const void* blk_start,
                             void* out, long long s, long long row_bytes, long long n_hot,
                             long long n_host, long long row_block, int vec_bytes,
                             void* stream) {
  return dispatch<LaunchBlocks>(
      vec_bytes, static_cast<const char*>(hot), static_cast<const char*>(host),
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(pos),
      static_cast<const int32_t*>(blk_mode), static_cast<const int32_t*>(blk_start),
      static_cast<char*>(out), int64_t(s), int64_t(row_bytes), int64_t(n_hot), int64_t(n_host),
      int64_t(row_block), static_cast<cudaStream_t>(stream));
}

// The device address of pinned host memory (cudaHostAlloc'd or registered):
// the host operand's pointer as the kernels must read it over UVA.
int dci_host_device_pointer(void* host_ptr, void** dev_ptr) {
  return int(cudaHostGetDevicePointer(dev_ptr, host_ptr, 0));
}

}  // extern "C"
