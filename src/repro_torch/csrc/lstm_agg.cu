// GraphSAGE-LSTM's aggregator over a sampled block, for Hopper (sm_90a).
//
// dci_lstm_agg replaces no Pallas kernel: the JAX reference has no LSTM
// aggregator.  It runs the recurrence of GraphSAGE's LSTM aggregator
// (Hamilton et al., NeurIPS 2017: the authors' SeqAggregator, TF's
// BasicLSTMCell) over each destination d's fanout sampled neighbours, in
// the order they were drawn, and writes the last hidden state:
//
//   z_t = g[row(d, t)] + h_{t-1} w_hh             (4H gate sums: i, j, f, o)
//   c_t = sigmoid(f + 1) c_{t-1} + sigmoid(i) tanh(j)
//   h_t = sigmoid(o) tanh(c_t),   h_{-1} = c_{-1} = 0,   out[d] = h_{fanout-1}
//
// g[R, 4H] (float32) holds gate rows x W_ih + b, mapped by one SGEMM before
// this kernel (models/gnn/models.py): at a sampled layer 0 the frontier's
// distinct rows, read here through idx[num_dst * (1 + fanout)] (int32, the
// [self | neighbours] layout of sample_blocks: the dedup inverse map; only
// the neighbour positions are read); with idx null, g holds the num_dst *
// fanout neighbour rows themselves in slot order (layers 1 and up, and the
// routes without dedup).  Rows are clamped to [0, R).  w_hh is [H, 4H] and
// H is 128 (GraphSAGE's "small" LSTM).
//
// What bounds it on an H100: operations.  Each step after the first is a
// product of the block's hidden states with w_hh, 2 x 128 x 512 FLOP a
// destination: at batch 4096 and fan-outs 25,10 layer 0 is 45,056
// destinations x 24 such steps, 142 GFLOP, 2.1 ms at float32's 67 TFLOP/s,
// against 0.7 ms to read every slot's 2 KB gate row at 3.35 TB/s.  The
// steps of one destination depend on each other; its destinations do not.
// So:
// - A block owns 64 destinations for all their steps; c stays in registers
//   and h in shared memory, so neither is ever written to device memory
//   before the end.  A thread owns 8 destinations x 4 hidden units, and
//   for those the 4 gates, so the cell's update needs nothing of another
//   thread: its 128 sums start from the step's gate rows (16-byte loads)
//   and add h w_hh in order of k.
// - w_hh (256 KB) does not fit in shared memory.  It streams from L2 (every
//   block reads the same 256 KB) through a double buffer of 32-row stages,
//   cp.async, the next stage in flight while one is used; 64 destinations
//   a block make each read stage feed 64 x 2 FLOP a float.
// - h is kept transposed ([k][destination], rows padded by 4 floats) so a
//   warp, whose 32 lanes share their 8 destinations and own 128 units in
//   turn, reads its 8 h values as two broadcast 16-byte loads and each
//   gate's w_hh values as one 16-byte load a lane, with no bank conflict.
//   Per k a thread loads 24 floats for 128 FMAs.
// - The step's gate rows are loaded at its start (the latency is not
//   hidden by another block: one block fills an SM); the next step's rows
//   are fetched into L2 meanwhile (prefetch.global.L2), so that wait is an
//   L2 hit's.
// - No atomics: every run gives the same bits.  The first step adds no
//   product (h is 0), so its cost is the gate rows' read.
//
// The entry point launches on the given stream and returns
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kH = 128;                 // hidden units
constexpr int kN = 4 * kH;              // gate columns: i, j, f, o
constexpr int kM = 64;                  // destinations a block
constexpr int kThreads = 256;           // 8 warps
constexpr int kRows = kM / (kThreads / 32);  // destinations a warp (and a thread): 8
constexpr int kUnits = kH / 32;         // hidden units a lane, one 16-byte vector of each gate: 4
constexpr int kStage = 32;              // rows of w_hh a stage
constexpr int kStages = kH / kStage;    // stages a step
constexpr int kHStride = kM + 4;        // floats a k of the transposed h
constexpr int kMaxFanout = 64;
constexpr int kLines = kN / 32;         // 128-byte lines a gate row

constexpr size_t kWBytes = size_t(2) * kStage * kN * sizeof(float);
constexpr size_t kHBytes = size_t(2) * kH * kHStride * sizeof(float);
constexpr size_t kMaxBytes = kWBytes + kHBytes + size_t(kM) * kMaxFanout * sizeof(int32_t);

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Stage s of w_hh (its rows s * kStage ..) into buf, as one commit group.
__device__ __forceinline__ void load_stage(float* buf, const float* __restrict__ w_hh, int s) {
  const float* src = w_hh + size_t(s) * kStage * kN;
  for (int v = threadIdx.x; v < kStage * kN / 4; v += kThreads) {
    cp_async16(buf + 4 * v, src + 4 * v);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kThreads, 1)
    lstm_agg_kernel(const float* __restrict__ g, const int32_t* __restrict__ idx,
                    const float* __restrict__ w_hh, float* __restrict__ out, int64_t rows,
                    int64_t num_dst, int fanout) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);                               // [2][kStage][kN]
  float* hs = reinterpret_cast<float*>(smem + kWBytes);                     // [2][kH][kHStride]
  int32_t* ids = reinterpret_cast<int32_t*>(smem + kWBytes + kHBytes);      // [kM][fanout]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t d0 = int64_t(blockIdx.x) * kM;
  const int r0 = warp * kRows;   // the thread's first destination in the block
  const int u0 = lane * kUnits;  // the thread's first hidden unit

  // w_hh's first stage streams in while the slots' rows are resolved.
  if (fanout > 1) load_stage(ws, w_hh, 0);
  for (int s = threadIdx.x; s < kM * fanout; s += kThreads) {
    const int m = s / fanout, t = s - m * fanout;
    // A tail block's spare destinations repeat the last one and write nothing.
    const int64_t d = d0 + m < num_dst ? d0 + m : num_dst - 1;
    const int64_t pos = d * fanout + t;
    int64_t r = idx == nullptr ? pos : int64_t(idx[num_dst + pos]);
    r = r < 0 ? 0 : (r >= rows ? rows - 1 : r);
    ids[s] = int32_t(r);
  }
  __syncthreads();

  float c[kRows][kUnits];
  float acc[kRows][4][kUnits];  // the gate sums; after the cell, acc[.][0] holds h
  int used = 0;                 // stages consumed: the next is in buffer used & 1
  for (int t = 0; t < fanout; ++t) {
    if (t + 1 < fanout) {
      for (int l = threadIdx.x; l < kM * kLines; l += kThreads) {
        const int m = l / kLines, line = l - m * kLines;
        const float* p = g + int64_t(ids[m * fanout + t + 1]) * kN + line * 32;
        asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float* row = g + int64_t(ids[(r0 + r) * fanout + t]) * kN + u0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(row + q * kH));
        acc[r][q][0] = v.x;
        acc[r][q][1] = v.y;
        acc[r][q][2] = v.z;
        acc[r][q][3] = v.w;
      }
    }
    if (t > 0) {
      const float* hp = hs + ((t - 1) & 1) * kH * kHStride;
      for (int s = 0; s < kStages; ++s, ++used) {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        // Stage `used` has landed for every thread, every thread is done with
        // the other buffer, and (at s == 0) the last step's h is written.
        __syncthreads();
        if (s + 1 < kStages || t + 1 < fanout) {
          load_stage(ws + ((used + 1) & 1) * kStage * kN, w_hh, (s + 1) % kStages);
        }
        const float* wb = ws + (used & 1) * kStage * kN;
        const float* hk = hp + s * kStage * kHStride + r0;
#pragma unroll 4
        for (int k = 0; k < kStage; ++k) {
          const float4 ha = *reinterpret_cast<const float4*>(hk + k * kHStride);
          const float4 hb = *reinterpret_cast<const float4*>(hk + k * kHStride + 4);
          const float hv[kRows] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
          float4 wv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            wv[q] = *reinterpret_cast<const float4*>(wb + k * kN + q * kH + u0);
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc[r][q][0] = fmaf(hv[r], wv[q].x, acc[r][q][0]);
              acc[r][q][1] = fmaf(hv[r], wv[q].y, acc[r][q][1]);
              acc[r][q][2] = fmaf(hv[r], wv[q].z, acc[r][q][2]);
              acc[r][q][3] = fmaf(hv[r], wv[q].w, acc[r][q][3]);
            }
          }
        }
      }
    }
    // The cell.  The step's h goes to the buffer the next step reads: every
    // thread finished reading it in step t - 1 (step t's barriers came since).
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const float ij = sigmoid(acc[r][0][u]) * tanhf(acc[r][1][u]);
        c[r][u] = t == 0 ? ij : sigmoid(acc[r][2][u] + 1.0f) * c[r][u] + ij;
        acc[r][0][u] = sigmoid(acc[r][3][u]) * tanhf(c[r][u]);
      }
    }
    if (t + 1 < fanout) {
      float* hn = hs + (t & 1) * kH * kHStride + r0;
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        *reinterpret_cast<float4*>(hn + (u0 + u) * kHStride) =
            make_float4(acc[0][0][u], acc[1][0][u], acc[2][0][u], acc[3][0][u]);
        *reinterpret_cast<float4*>(hn + (u0 + u) * kHStride + 4) =
            make_float4(acc[4][0][u], acc[5][0][u], acc[6][0][u], acc[7][0][u]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t d = d0 + r0 + r;
    if (d < num_dst) {
      *reinterpret_cast<float4*>(out + d * kH + u0) =
          make_float4(acc[r][0][0], acc[r][0][1], acc[r][0][2], acc[r][0][3]);
    }
  }
}

}  // namespace

extern "C" {

// g: float32 [rows, 512]; idx: int32 [num_dst * (1 + fanout)] or null (g
// then holds num_dst * fanout rows); w_hh: float32 [128, 512]; out:
// float32 [num_dst, 128]; g, w_hh and out on 16-byte aligned bases.
// rows: 1 to 2^31 - 1; fanout: 1 to 64.
int dci_lstm_agg(const void* g, const void* idx, const void* w_hh, void* out, long long rows,
                 long long num_dst, int fanout, void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || fanout < 1 || fanout > kMaxFanout || num_dst < 1) {
    return int(cudaErrorInvalidValue);
  }
  const int64_t blocks = (num_dst + kM - 1) / kM;
  if (blocks > int64_t(0x7fffffff)) return int(cudaErrorInvalidConfiguration);
  const cudaError_t err = cudaFuncSetAttribute(
      lstm_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kMaxBytes));
  if (err != cudaSuccess) return int(err);
  const size_t bytes = kWBytes + kHBytes + size_t(kM) * fanout * sizeof(int32_t);
  lstm_agg_kernel<<<unsigned(blocks), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w_hh), static_cast<float*>(out), rows, num_dst, fanout);
  return int(cudaGetLastError());
}

}  // extern "C"
