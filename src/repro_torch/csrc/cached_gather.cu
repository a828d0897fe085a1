// DCI's two-source cached row gather for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of the JAX reference in
// src/repro/kernels/cached_gather/kernel.py:
//   dci_cached_gather        <- _cached_gather_db      (per-row copy)
//   dci_cached_gather_blocks <- _cached_gather_blocks  (row-block runs)
//   dci_cached_gather_select <- cached_gather_select   (_select_kernel)
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
// A miss row is a UVA read at PCIe latency, several times an HBM read's.
//
// #1 and #2 answer that with latency hiding, not with fewer bytes: each
// copies every row from its winning source only, and both run a grid
// sized to the card (CTAs per SM from the occupancy API times the SM
// count, computed by the wrapper) whose warps walk the work with a
// stride.  Each lane issues kUnroll loads before it stores any, one load
// instruction per row of up to 32 vectors (copy_rows), so a warp keeps
// eight rows in flight.  When the host table is pinned host memory and
// rows are up to 32 vectors long, #1's warps are specialised: two of
// each CTA's eight copy only the miss rows and the other six only the
// hit rows, so a miss row's PCIe latency stalls a miss warp and never a
// hit warp (on the products frontier, warps that each took both kinds
// took about as long as its all-hit and miss-only gathers together).
// Otherwise every warp takes both kinds: from a device host table (the
// prefetch pack) both sides are HBM reads and two warps of eight would
// only wait, and on the reddit-sized table (2,408-byte rows, three rows
// in four missing) the split measured slower.
// #2 classifies its row blocks itself, with warp votes, by the
// reference's rule (kernel.py:391-407), and copies a block that is one
// consecutive all-hit or all-miss run as one span.  What is left bounds
// them: on the pinned route the PCIe reads of the miss rows take most of
// the time, and #1 reads a miss row once per occurrence; only the dedup
// route (#2 on unique ids) reads each once.
// Both stage rows through registers.  A ring of shared-memory slots
// filled and drained by bulk copies (cp.async.bulk with an mbarrier per
// stage), which read pinned host memory over UVA too, measured no faster
// for #2's spans on the H100 and slower from a device host table
// (PERF.md), so it is not kept there.
//
// #2 reads long miss rows from a pinned host table as whole aligned
// 128-byte lines (copy_lines).  Reddit's 2,408-byte rows are 8-byte
// aligned, so they were read as 301 vectors of 8 bytes: 256 bytes an
// instruction, and as a row starts 8 bytes off a line (id x 2,408 is 104
// mod 128) each instruction met three lines, two in part, and a row's
// 45-vector tail made a round trip alone.  At 34% hits on a sorted
// unique frontier that came to about 26 GB/s of miss bytes, whether the
// rows went through registers (#1, #2) or a cp.async ring (#3), against
// 43 GB/s read for 400-byte rows as 16-byte vectors, 49 GB/s by the copy
// engine, and about four times slower with L1-bypassing .cg reads than
// with .ca.  The 43 GB/s counted the dedup bucket's pad rows, which all
// read one host row: 400-byte rows one in nine read 23 GB/s, and a plain
// sequential read of pinned memory by every SM, whole lines of 16-byte
// loads, 23-26 GB/s with the copy engine at 42 (PERF.md).  So the SM's
// own reads of pinned memory have a ceiling below the copy engine's, and
// the lines bring #2 to it: 1.16x on Reddit's f32 rows, 1.45x on its
// bf16 rows, whose 4-byte vectors read well below it.  The wrapper takes
// the line copy for rows of more than 32 vectors from a pinned host table
// whose base is 16-byte aligned (kernel.py, _takes_lines); shorter rows
// are one instruction a row already, and hit rows and a host table on the
// card are HBM reads, so they keep copy_rows.
//
// #3 computes what the TPU select kernel computes, not how: there the
// BlockSpec index maps stage BOTH candidate tiles of every row (an index
// map cannot depend on the data) and jnp.where keeps one, so the losing
// row crosses the link too.  On Hopper an address may depend on the data
// at no cost, so #3 selects each row's one source ADDRESS from the raw
// position and never reads the losing row: its bytes are #1's, and so is
// its bound.  It moves them through an asynchronous ring in shared memory
// (cp.async, the LDGSTS path): a persistent grid whose warps stride over
// chunks of rows, each chunk one stage of the warp's ring of `stages`
// slots.  A stage holds up to 32 x unroll vectors: rows of up to 32
// vectors whole (32 / n_vec rows per instruction, as copy_rows lays
// them), a longer row alone in stages of 32 x unroll vectors.  A warp
// issues one stage's copies, commits them as one group, waits until the
// oldest group has landed (cp.async.wait_group stages - 1) and stores
// that stage to the output, whose rows are contiguous, with coalesced
// stores: stages - 1 stages stay in flight and no register is held for
// them.  A lane whose copy falls past its row's end or past the
// frontier's tail issues its cp.async with a source size of 0: it
// zero-fills its slot and reads nothing.  The ids and slots of a warp's
// next chunk are loaded while the current chunk is issued.  The copies
// go through L1 (.ca; the L1-bypassing .cg read pinned host memory about
// four times slower), so the wrapper sizes the rings (kernel.py,
// _select_ring) to leave a quarter of the SM's L1 and shared memory to
// L1.  cp.async copies only 4, 8 or 16 bytes, so 2- and 1-byte vectors
// (bf16 rows of odd width, misaligned bases) take this kernel's register
// instance, which copies each chunk with copy_rows: a rule of the row's
// shape, not a fallback.
//
// Row offsets are computed in 64 bits: ogbn-papers100m at full size holds
// 14.2 G feature elements, and reddit's main-shape output 2.6 GB.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // 8 warps per CTA
constexpr int kWarpsPerCta = kThreads / kWarp;
constexpr int kUnroll = 8;  // vectors each lane loads before it stores any
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t clamp_row(int64_t v, int64_t n) {
  return max(int64_t(0), min(v, n - 1));
}

__device__ __forceinline__ const char* winning_row(const char* hot, const char* host,
                                                   const int32_t* idx, const int32_t* pos,
                                                   int64_t row, int64_t row_bytes, int64_t n_hot,
                                                   int64_t n_host) {
  const int64_t p = pos[row];
  if (p >= 0) return hot + min(p, n_hot - 1) * row_bytes;
  return host + clamp_row(idx[row], n_host) * row_bytes;
}

// The warp copies `rows` (<= 32) rows of n_vec vectors each: lane r <
// rows holds row r's source in `src` and its output address in `dst`.
// One load instruction never splits a row it does not fill: a row of up
// to 32 vectors is read whole by one instruction (32 / n_vec rows per
// instruction: a 400-byte row takes 25 lanes and leaves 7 idle), which
// measured faster over PCIe than lanes laid across row boundaries, and a
// longer row is read by all 32 lanes, one row at a time.  Each lane
// issues kUnroll loads before it stores any.  A span of consecutive
// source rows is one row of rows * n_vec vectors.
template <typename V>
__device__ __forceinline__ void copy_rows(const char* src, char* dst, int rows, int n_vec,
                                          int lane) {
  const auto my_src = reinterpret_cast<unsigned long long>(src);
  const auto my_dst = reinterpret_cast<unsigned long long>(dst);
  if (n_vec <= kWarp) {
    const int per_load = kWarp / n_vec;
    const int sub = lane / n_vec;  // this lane's row within one instruction
    const int col = lane % n_vec;
    for (int r0 = 0; r0 < rows; r0 += per_load * kUnroll) {
      V buf[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * per_load + sub;
        const auto row = reinterpret_cast<const V*>(__shfl_sync(kFull, my_src, min(r, rows - 1)));
        if (sub < per_load && r < rows) buf[u] = row[col];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * per_load + sub;
        const auto out = reinterpret_cast<V*>(__shfl_sync(kFull, my_dst, min(r, rows - 1)));
        if (sub < per_load && r < rows) out[col] = buf[u];
      }
    }
    return;
  }
  for (int r = 0; r < rows; ++r) {
    const auto row = reinterpret_cast<const V*>(__shfl_sync(kFull, my_src, r));
    const auto out = reinterpret_cast<V*>(__shfl_sync(kFull, my_dst, r));
    for (int k0 = 0; k0 < n_vec; k0 += kWarp * kUnroll) {
      V buf[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * kWarp + lane;
        if (k < n_vec) buf[u] = row[k];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * kWarp + lane;
        if (k < n_vec) out[k] = buf[u];
      }
    }
  }
}

// Long miss rows from a pinned host table are read as whole aligned lines
// (copy_lines): one instruction reads kLinesPerLoad lines of kLine bytes,
// kLanesPerLine lanes a line, each lane one kPiece-byte piece.
constexpr int kLine = 128;
constexpr int kPiece = 16;
constexpr int kLanesPerLine = kLine / kPiece;
constexpr int kLinesPerLoad = kWarp / kLanesPerLine;

union Piece {
  uint4 whole;
  unsigned char bytes[kPiece];
};

// The piece at q, read only inside the host table [lo, hi): whole where it
// lies inside, else its V units below hi (the table's last piece, when the
// table ends off a 16-byte boundary); a piece outside the table is not read.
template <typename V>
__device__ __forceinline__ Piece load_piece(const char* q, const char* lo, const char* hi) {
  Piece v;
  v.whole = make_uint4(0, 0, 0, 0);
  if (q < lo || q >= hi) return v;
  if (q + kPiece <= hi) {
    v.whole = *reinterpret_cast<const uint4*>(q);
    return v;
  }
#pragma unroll
  for (int k = 0; k < kPiece / int(sizeof(V)); ++k)
    if (q + (k + 1) * int(sizeof(V)) <= hi)
      reinterpret_cast<V*>(v.bytes)[k] = reinterpret_cast<const V*>(q)[k];
  return v;
}

// Store the V units of a piece that fall inside its range: the piece starts
// `off` bytes after the range's first source byte (negative in the head
// line, before the range) and the range is `bytes` long.
template <typename V>
__device__ __forceinline__ void store_piece(const Piece& v, int64_t off, int64_t bytes, char* dst) {
#pragma unroll
  for (int k = 0; k < kPiece / int(sizeof(V)); ++k) {
    const int64_t x = off + k * int64_t(sizeof(V));
    if (x >= 0 && x < bytes) *reinterpret_cast<V*>(dst + x) = reinterpret_cast<const V*>(v.bytes)[k];
  }
}

// The warp copies `segs` (<= 32) ranges of `bytes` bytes each out of the
// pinned host table [lo, hi), whose base is 16-byte aligned: lane s < segs
// holds range s's source in `src` and its output address in `dst`.  The
// aligned lines that cover the ranges are read as one stream, four whole
// lines an instruction and kUnroll instructions in flight before any
// store, so the next range's lines are read before this one's are stored
// and no range's tail makes a round trip alone.  Line t of the stream
// belongs to the range whose lines end first after t (the lanes count the
// ranges that end at or before it, a ballot for each of an instruction's
// four lines); each lane stores the V units of its piece that fall inside
// that range, at the range's output plus their offset, so the bytes of a
// neighbouring row in a range's first and last line are read and dropped.
template <typename V>
__device__ __forceinline__ void copy_lines(const char* src, char* dst, int segs, int64_t bytes,
                                           const char* lo, const char* hi, int lane) {
  const auto a = reinterpret_cast<unsigned long long>(src);
  const int64_t head = lane < segs ? int64_t(a % kLine) : 0;  // bytes of the first line before a
  const int n = lane < segs ? int((head + bytes + kLine - 1) / kLine) : 0;  // lines of the range
  int end = n;  // the stream's lines up to and including this range's
#pragma unroll
  for (int d = 1; d < kWarp; d *= 2) {
    const int v = __shfl_up_sync(kFull, end, d);
    if (lane >= d) end += v;
  }
  const int total = __shfl_sync(kFull, end, kWarp - 1);
  // Stream line 0's offset from this range's first byte: line t's piece
  // lies at rel + t * kLine + piece bytes after it.
  const long long rel = -head - int64_t(end - n) * kLine;
  const int sub = lane / kLanesPerLine;  // this lane's line within one instruction
  const int piece = (lane % kLanesPerLine) * kPiece;
  for (int t0 = 0; t0 < total; t0 += kLinesPerLoad * kUnroll) {
    Piece buf[kUnroll];
    int seg[kUnroll];
    int64_t off[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int first = t0 + u * kLinesPerLoad;
      int s = 0;
#pragma unroll
      for (int g = 0; g < kLinesPerLoad; ++g) {
        const int ended = __popc(__ballot_sync(kFull, end <= first + g));
        if (g == sub) s = ended;
      }
      seg[u] = min(s, kWarp - 1);  // past the stream's end: not read
      const int t = first + sub;
      off[u] = __shfl_sync(kFull, rel, seg[u]) + int64_t(t) * kLine + piece;
      const auto from = reinterpret_cast<const char*>(__shfl_sync(kFull, a, seg[u])) + off[u];
      if (t < total) buf[u] = load_piece<V>(from, lo, hi);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const auto out = reinterpret_cast<char*>(
          __shfl_sync(kFull, reinterpret_cast<unsigned long long>(dst), seg[u]));
      if (t0 + u * kLinesPerLoad + sub < total) store_piece<V>(buf[u], off[u], bytes, out);
    }
  }
}

// #1, warp-specialised for short rows read from pinned host memory: in
// each CTA, miss_warps warps (the wrapper passes 2 then, else 0) copy only
// the miss rows and the others only the hit rows, so a miss row's PCIe
// latency stalls a miss warp and never the hit warps' HBM copies.  Hit
// warps walk chunks of rows_per_warp rows (the wrapper sizes it so that a
// warp keeps kUnroll load instructions in flight), miss warps chunks of
// 32 rows; each side strides over the frontier, compacts its chunk's rows
// of its own kind into the first lanes (a ballot, then __fns), and copies
// them.  With miss_warps = 0 every warp copies both kinds.  The ids and
// slots of a warp's next chunk are loaded before the current chunk's
// rows, so their latency overlaps the copy.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const char* __restrict__ hot, const char* __restrict__ host,
                       const int32_t* __restrict__ idx, const int32_t* __restrict__ pos,
                       char* __restrict__ out, int64_t s, int64_t row_bytes, int64_t n_hot,
                       int64_t n_host, int rows_per_warp, int miss_warps) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int hit_warps = kWarpsPerCta - miss_warps;
  const bool miss_side = warp >= hit_warps;
  const bool both = miss_warps == 0;
  const bool reads_idx = both || miss_side;  // hit-only warps never read a host id
  const int chunk = miss_side ? kWarp : rows_per_warp;
  const int side = miss_side ? miss_warps : hit_warps;
  const int n_vec = int(row_bytes / int64_t(sizeof(V)));
  const int64_t n_chunks = (s + chunk - 1) / chunk;
  const int64_t stride = int64_t(gridDim.x) * side;
  int64_t c = int64_t(blockIdx.x) * side + (miss_side ? warp - hit_warps : warp);
  int32_t p = 0, i = 0;  // this lane's row of chunk c
  bool live = c < n_chunks && lane < chunk && c * chunk + lane < s;
  if (live) {
    p = pos[c * chunk + lane];
    if (reads_idx) i = idx[c * chunk + lane];
  }
  for (; c < n_chunks; c += stride) {
    const int64_t row = c * chunk + lane;
    const bool mine = live && (both || (p < 0) == miss_side);
    const char* src = p >= 0 ? hot + min(int64_t(p), n_hot - 1) * row_bytes
                             : host + clamp_row(i, n_host) * row_bytes;
    char* dst = out + row * row_bytes;
    const int64_t next = (c + stride) * chunk + lane;
    live = c + stride < n_chunks && lane < chunk && next < s;
    if (live) {
      p = pos[next];
      if (reads_idx) i = idx[next];
    }
    const unsigned kind = __ballot_sync(kFull, mine);
    const int from = lane < __popc(kind) ? int(__fns(kind, 0, lane + 1)) : 0;
    const auto s_from = __shfl_sync(kFull, reinterpret_cast<unsigned long long>(src), from);
    const auto d_from = __shfl_sync(kFull, reinterpret_cast<unsigned long long>(dst), from);
    copy_rows<V>(reinterpret_cast<const char*>(s_from), reinterpret_cast<char*>(d_from),
                 __popc(kind), n_vec, lane);
  }
}

// #2: each warp takes one block of row_block output rows at a time and
// strides over the blocks.  It classifies the block with the reference's
// rule: src = hit ? clamp(pos) : clamp(idx); mode 1 if every row hits and
// src runs consecutively, 2 if every row misses and src runs
// consecutively, else 0 (and the ragged last block is 0).  Modes 1 and 2
// copy the block as one span from src[0]; mode 0 copies row by row.
// With kLines (rows of more than 32 vectors from a pinned host table whose
// base is 16-byte aligned) the host side is read by aligned lines: a mode-2
// span with copy_lines, and a mode-0 block's miss rows, gathered into the
// first lanes, with one copy_lines before its hit rows' copy_rows.
// `modes`, when not null, receives each block's mode.
template <typename V, bool kLines = false>
__global__ void __launch_bounds__(kThreads)
    gather_blocks_kernel(const char* __restrict__ hot, const char* __restrict__ host,
                         const int32_t* __restrict__ idx, const int32_t* __restrict__ pos,
                         char* __restrict__ out, int32_t* __restrict__ modes, int64_t s,
                         int64_t row_bytes, int64_t n_hot, int64_t n_host, int64_t row_block) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int n_vec = int(row_bytes / int64_t(sizeof(V)));
  const char* host_end = host + n_host * row_bytes;
  const int64_t n_blocks = (s + row_block - 1) / row_block;
  const int64_t stride = int64_t(gridDim.x) * kWarpsPerCta;
  for (int64_t b = int64_t(blockIdx.x) * kWarpsPerCta + warp; b < n_blocks; b += stride) {
    const int64_t row0 = b * row_block;
    const int n_rows = int(min(row_block, s - row0));
    bool all_hit = true, all_miss = true, contig = true;
    int32_t start = 0, last = 0;
    for (int j0 = 0; j0 < n_rows; j0 += kWarp) {
      const int j = j0 + lane;
      const bool valid = j < n_rows;
      bool hit = false;
      int32_t src = 0;
      if (valid) {
        const int32_t p = pos[row0 + j];
        hit = p >= 0;
        src = hit ? int32_t(min(int64_t(p), n_hot - 1)) : int32_t(clamp_row(idx[row0 + j], n_host));
      }
      int32_t prev = __shfl_up_sync(kFull, src, 1);
      if (lane == 0) prev = last;
      const bool h = __all_sync(kFull, !valid || hit);
      const bool m = __all_sync(kFull, !valid || !hit);
      const bool c = __all_sync(kFull, !valid || j == 0 || src == prev + 1);
      all_hit = all_hit && h;
      all_miss = all_miss && m;
      contig = contig && c;
      if (j0 == 0) start = __shfl_sync(kFull, src, 0);
      last = __shfl_sync(kFull, src, kWarp - 1);
    }
    const int mode = (n_rows == row_block && contig) ? (all_hit ? 1 : (all_miss ? 2 : 0)) : 0;
    if (modes != nullptr && lane == 0) modes[b] = mode;
    char* dst = out + row0 * row_bytes;
    if (mode != 0) {
      const char* src = (mode == 1 ? hot : host) + int64_t(start) * row_bytes;
      if (kLines && mode == 2)
        copy_lines<V>(src, dst, 1, n_rows * row_bytes, host, host_end, lane);
      else
        copy_rows<V>(src, dst, 1, n_rows * n_vec, lane);
    } else {
      for (int j0 = 0; j0 < n_rows; j0 += kWarp) {
        const int rows = min(kWarp, n_rows - j0);
        const char* src = lane < rows ? winning_row(hot, host, idx, pos, row0 + j0 + lane,
                                                    row_bytes, n_hot, n_host)
                                      : nullptr;
        char* row_dst = dst + int64_t(j0 + lane) * row_bytes;
        if constexpr (kLines) {
          const bool miss = lane < rows && pos[row0 + j0 + lane] < 0;
#pragma unroll
          for (int side = 0; side < 2; ++side) {  // the miss rows, then the hit rows
            const unsigned set = __ballot_sync(kFull, lane < rows && miss == (side == 0));
            if (set == 0) continue;
            const int from = lane < __popc(set) ? int(__fns(set, 0, lane + 1)) : 0;
            const auto s_from = reinterpret_cast<const char*>(
                __shfl_sync(kFull, reinterpret_cast<unsigned long long>(src), from));
            const auto d_from = reinterpret_cast<char*>(
                __shfl_sync(kFull, reinterpret_cast<unsigned long long>(row_dst), from));
            if (side == 0)
              copy_lines<V>(s_from, d_from, __popc(set), row_bytes, host, host_end, lane);
            else
              copy_rows<V>(s_from, d_from, __popc(set), n_vec, lane);
          }
        } else {
          copy_rows<V>(src, row_dst, rows, n_vec, lane);
        }
      }
    }
  }
}

// #3's asynchronous copy of one vector into its ring slot.  It goes
// through L1 (cp.async.ca) at every width: from pinned host memory the
// L1-bypassing cp.async.cg, the usual choice for 16 bytes, read the miss
// rows about four times slower on the H100 (PERF.md).  A dead lane passes
// a source size of 0, which zero-fills the slot and reads nothing.
template <typename V>
__device__ __forceinline__ void cp_async(V* slot, const V* src, bool live) {
  static_assert(sizeof(V) == 4 || sizeof(V) == 8 || sizeof(V) == 16, "cp.async copies 4, 8 or 16 B");
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(slot));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
               "n"(int(sizeof(V))), "r"(live ? int(sizeof(V)) : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's groups are in flight
// (wait_group takes an immediate: pending = stages - 1, 1 to 7).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    case 7: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
  }
}

constexpr int kMaxStages = 8;  // ring slots per warp of #3 (wait_group 7 at most)

// #3: a persistent grid whose warps stride over chunks of chunk_rows
// output rows (1 for rows longer than 32 vectors).  A chunk is `pieces`
// stages of the warp's ring: up to 32 x unroll vectors each, the whole
// chunk for short rows, 32 x unroll vectors of the one row otherwise.
// Lane r < chunk_rows holds row r's source, chosen from the raw position;
// a stage's vector (u, lane) is row r, vector k of the chunk:
//   short rows: r = u * (32 / n_vec) + lane / n_vec, k = lane % n_vec;
//   long rows:  r = 0, k = piece * 32 * unroll + u * 32 + lane.
// Each lane stores back from the ring exactly the slots it filled.  V of
// 2 or 1 bytes (which cp.async cannot copy): each chunk through
// registers with copy_rows, and no ring.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    gather_select_kernel(const char* __restrict__ hot, const char* __restrict__ host,
                         const int32_t* __restrict__ idx, const int32_t* __restrict__ pos,
                         char* __restrict__ out, int64_t s, int64_t row_bytes, int64_t n_hot,
                         int64_t n_host, int chunk_rows, int unroll, int stages) {
  extern __shared__ __align__(16) unsigned char ring_smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int n_vec = int(row_bytes / int64_t(sizeof(V)));
  const int64_t n_chunks = (s + chunk_rows - 1) / chunk_rows;
  const int64_t stride = int64_t(gridDim.x) * kWarpsPerCta;
  const int64_t first = int64_t(blockIdx.x) * kWarpsPerCta + warp;
  if (first >= n_chunks) return;
  const int my_row = min(lane, chunk_rows - 1);
  int32_t p = 0, i = 0;  // this lane's row of the next chunk to issue
  if (first * chunk_rows + my_row < s) {
    p = pos[first * chunk_rows + my_row];
    i = idx[first * chunk_rows + my_row];
  }
  // The select on the address: one source per row, the loser never read.
  auto source = [&]() {
    return reinterpret_cast<unsigned long long>(
        p >= 0 ? hot + min(int64_t(p), n_hot - 1) * row_bytes
               : host + clamp_row(i, n_host) * row_bytes);
  };
  auto load_next = [&](int64_t c) {
    const int64_t next = (c + stride) * chunk_rows + my_row;
    if (c + stride < n_chunks && next < s) {
      p = pos[next];
      i = idx[next];
    }
  };
  auto rows_of = [&](int64_t c) { return int(min(int64_t(chunk_rows), s - c * chunk_rows)); };

  if constexpr (sizeof(V) < 4) {
    for (int64_t c = first; c < n_chunks; c += stride) {
      const auto src = reinterpret_cast<const char*>(source());
      char* dst = out + (c * chunk_rows + my_row) * row_bytes;
      load_next(c);
      copy_rows<V>(src, dst, rows_of(c), n_vec, lane);
    }
  } else {
    const bool short_rows = n_vec <= kWarp;
    const int per_load = short_rows ? kWarp / n_vec : 1;
    const int sub = short_rows ? lane / n_vec : 0;
    const int col = short_rows ? lane - sub * n_vec : lane;
    const int stage_vecs = unroll * kWarp;
    const int pieces = short_rows ? 1 : (n_vec + stage_vecs - 1) / stage_vecs;
    // Instructions a stage of `rows` rows (piece `piece`) takes.
    auto n_inst = [&](int rows, int piece) {
      return short_rows ? (rows + per_load - 1) / per_load
                        : min(unroll, (n_vec - piece * stage_vecs + kWarp - 1) / kWarp);
    };
    // Row r and vector k of a stage's vector (u, lane); live: k is in the row.
    auto lane_of = [&](int u, int piece, int rows, int& r, int& k) {
      r = short_rows ? u * per_load + sub : 0;
      k = short_rows ? col : piece * stage_vecs + u * kWarp + lane;
      return short_rows ? sub < per_load && r < rows : k < n_vec;
    };
    V* ring = reinterpret_cast<V*>(ring_smem) + int64_t(warp) * stages * stage_vecs;
    const int64_t n_stages = ((n_chunks - 1 - first) / stride + 1) * pieces;
    unsigned long long my_src = 0;
    int64_t ic = first, dc = first;  // chunk being issued, being drained
    int ip = 0, dp = 0, is = 0, ds = 0;  // their pieces and ring slots
    for (int64_t t = 0; t < n_stages + stages - 1; ++t) {
      if (t < n_stages) {
        if (ip == 0) {
          my_src = source();
          load_next(ic);
        }
        const int rows = rows_of(ic);
        const int nu = n_inst(rows, ip);
        V* slot = ring + is * stage_vecs;
        for (int u = 0; u < nu; ++u) {
          int r, k;
          const bool live = lane_of(u, ip, rows, r, k);
          const auto row = reinterpret_cast<const V*>(__shfl_sync(kFull, my_src, min(r, rows - 1)));
          cp_async(slot + u * kWarp + lane, row + (live ? k : 0), live);
        }
        if (++ip == pieces) {
          ip = 0;
          ic += stride;
        }
        is = is + 1 == stages ? 0 : is + 1;
      }
      cp_async_commit();  // an empty group past the last stage keeps the count
      if (t >= stages - 1) {
        cp_async_wait(stages - 1);  // the oldest stage has landed
        __syncwarp();
        const int rows = rows_of(dc);
        const int nu = n_inst(rows, dp);
        const V* slot = ring + ds * stage_vecs;
        for (int u = 0; u < nu; ++u) {
          int r, k;
          const bool live = lane_of(u, dp, rows, r, k);
          if (live)
            reinterpret_cast<V*>(out + (dc * chunk_rows + r) * row_bytes)[k] = slot[u * kWarp + lane];
        }
        __syncwarp();
        if (++dp == pieces) {
          dp = 0;
          dc += stride;
        }
        ds = ds + 1 == stages ? 0 : ds + 1;
      }
    }
  }
}

// Dynamic shared memory of a #3 launch: each warp's ring of `stages`
// slots of 32 x unroll vectors (none for 2- and 1-byte vectors).
template <typename V>
int select_smem(int unroll, int stages) {
  return sizeof(V) >= 4 ? kWarpsPerCta * stages * unroll * kWarp * int(sizeof(V)) : 0;
}

// The kernel a launch of `kind` (0: #1, 1: #2, 2: #3, 3: #2 by aligned lines)
// and vector type V runs.
template <typename V>
const void* kernel_of(int kind) {
  switch (kind) {
    case 0: return reinterpret_cast<const void*>(gather_rows_kernel<V>);
    case 1: return reinterpret_cast<const void*>(gather_blocks_kernel<V>);
    case 2: return reinterpret_cast<const void*>(gather_select_kernel<V>);
    case 3: return reinterpret_cast<const void*>(gather_blocks_kernel<V, true>);
    default: return nullptr;
  }
}

const void* kernel_of(int kind, int vec_bytes) {
  switch (vec_bytes) {
    case 16: return kernel_of<uint4>(kind);
    case 8: return kernel_of<uint2>(kind);
    case 4: return kernel_of<uint32_t>(kind);
    case 2: return kernel_of<uint16_t>(kind);
    case 1: return kernel_of<uint8_t>(kind);
    default: return nullptr;
  }
}

// Dynamic shared memory above the default 48 KB must be allowed per kernel.
cudaError_t allow_smem(const void* fn, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <template <typename> class Launch, typename... Args>
int dispatch(int vec_bytes, Args... args) {
  cudaError_t err;
  switch (vec_bytes) {
    case 16: err = Launch<uint4>::run(args...); break;
    case 8: err = Launch<uint2>::run(args...); break;
    case 4: err = Launch<uint32_t>::run(args...); break;
    case 2: err = Launch<uint16_t>::run(args...); break;
    case 1: err = Launch<uint8_t>::run(args...); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename V>
struct LaunchRows {
  static cudaError_t run(const char* hot, const char* host, const int32_t* idx, const int32_t* pos,
                  char* out, int64_t s, int64_t row_bytes, int64_t n_hot, int64_t n_host,
                  int rows_per_warp, int miss_warps, unsigned grid, cudaStream_t stream) {
    gather_rows_kernel<V><<<grid, kThreads, 0, stream>>>(hot, host, idx, pos, out, s, row_bytes,
                                                         n_hot, n_host, rows_per_warp, miss_warps);
    return cudaSuccess;
  }
};

template <typename V>
struct LaunchBlocks {
  static cudaError_t run(const char* hot, const char* host, const int32_t* idx, const int32_t* pos,
                  char* out, int32_t* modes, int64_t s, int64_t row_bytes, int64_t n_hot,
                  int64_t n_host, int64_t row_block, bool lines, unsigned grid,
                  cudaStream_t stream) {
    if (lines)
      gather_blocks_kernel<V, true><<<grid, kThreads, 0, stream>>>(
          hot, host, idx, pos, out, modes, s, row_bytes, n_hot, n_host, row_block);
    else
      gather_blocks_kernel<V><<<grid, kThreads, 0, stream>>>(hot, host, idx, pos, out, modes, s,
                                                             row_bytes, n_hot, n_host, row_block);
    return cudaSuccess;
  }
};

template <typename V>
struct LaunchSelect {
  static cudaError_t run(const char* hot, const char* host, const int32_t* idx, const int32_t* pos,
                  char* out, int64_t s, int64_t row_bytes, int64_t n_hot, int64_t n_host,
                  int chunk_rows, int unroll, int stages, unsigned grid, cudaStream_t stream) {
    const int64_t n_vec = row_bytes / int64_t(sizeof(V));
    const bool ring = sizeof(V) >= 4;  // else through registers
    // A long row is a chunk alone; short rows fill at most one stage.
    if (n_vec > kWarp ? chunk_rows != 1 : ring && chunk_rows > kWarp / n_vec * unroll)
      return cudaErrorInvalidValue;
    if (ring && (stages < 2 || stages > kMaxStages)) return cudaErrorInvalidValue;
    const int smem = select_smem<V>(unroll, stages);
    // Allowed once per size, not at every launch: the attribute call is
    // host work of its own on a launch that takes a fraction of a ms.
    static std::atomic<int> allowed{48 * 1024};
    if (smem > allowed.load()) {
      const cudaError_t err = allow_smem(reinterpret_cast<const void*>(gather_select_kernel<V>), smem);
      if (err != cudaSuccess) return err;
      allowed.store(smem);
    }
    gather_select_kernel<V><<<grid, kThreads, smem, stream>>>(
        hot, host, idx, pos, out, s, row_bytes, n_hot, n_host, chunk_rows, unroll, stages);
    return cudaSuccess;
  }
};

}  // namespace

extern "C" {

// CTAs of 256 threads that fit on one SM for a launch of `kind` (0: #1,
// 1: #2, 2: #3, 3: #2 by aligned lines) at vector width vec_bytes with
// smem_bytes of dynamic shared memory (#3's ring; 0 for #1 and #2).
int dci_gather_occupancy(int kind, int vec_bytes, int smem_bytes, int* ctas_per_sm) {
  const void* fn = kernel_of(kind, vec_bytes);
  if (fn == nullptr || smem_bytes < 0) return int(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(fn, smem_bytes);
  if (err != cudaSuccess) return int(err);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, fn, kThreads,
                                                           size_t(smem_bytes)));
}

int dci_cached_gather(const void* hot, const void* host, const void* idx, const void* pos,
                      void* out, long long s, long long row_bytes, long long n_hot,
                      long long n_host, int vec_bytes, int rows_per_warp, int miss_warps,
                      int grid, void* stream) {
  if (rows_per_warp < 1 || rows_per_warp > kWarp || miss_warps < 0 ||
      miss_warps >= kWarpsPerCta || grid < 1)
    return int(cudaErrorInvalidValue);
  return dispatch<LaunchRows>(vec_bytes, static_cast<const char*>(hot),
                              static_cast<const char*>(host), static_cast<const int32_t*>(idx),
                              static_cast<const int32_t*>(pos), static_cast<char*>(out),
                              int64_t(s), int64_t(row_bytes), int64_t(n_hot), int64_t(n_host),
                              rows_per_warp, miss_warps, unsigned(grid),
                              static_cast<cudaStream_t>(stream));
}

int dci_cached_gather_select(const void* hot, const void* host, const void* idx,
                             const void* pos, void* out, long long s, long long row_bytes,
                             long long n_hot, long long n_host, int vec_bytes, int chunk_rows,
                             int unroll, int stages, int grid, void* stream) {
  if (chunk_rows < 1 || chunk_rows > kWarp || unroll < 1 || grid < 1)
    return int(cudaErrorInvalidValue);
  return dispatch<LaunchSelect>(vec_bytes, static_cast<const char*>(hot),
                                static_cast<const char*>(host), static_cast<const int32_t*>(idx),
                                static_cast<const int32_t*>(pos), static_cast<char*>(out),
                                int64_t(s), int64_t(row_bytes), int64_t(n_hot), int64_t(n_host),
                                chunk_rows, unroll, stages, unsigned(grid),
                                static_cast<cudaStream_t>(stream));
}

// `lines` (0 or 1): read the host side by aligned lines, which needs a
// 16-byte aligned host base.
int dci_cached_gather_blocks(const void* hot, const void* host, const void* idx,
                             const void* pos, void* out, void* modes, long long s,
                             long long row_bytes, long long n_hot, long long n_host,
                             long long row_block, int vec_bytes, int lines, int grid,
                             void* stream) {
  if (grid < 1 || row_block < 1 || (lines && reinterpret_cast<uintptr_t>(host) % kPiece != 0))
    return int(cudaErrorInvalidValue);
  return dispatch<LaunchBlocks>(
      vec_bytes, static_cast<const char*>(hot), static_cast<const char*>(host),
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(pos),
      static_cast<char*>(out), static_cast<int32_t*>(modes), int64_t(s), int64_t(row_bytes),
      int64_t(n_hot), int64_t(n_host), int64_t(row_block), lines != 0, unsigned(grid),
      static_cast<cudaStream_t>(stream));
}

// The device address of pinned host memory (cudaHostAlloc'd or registered):
// the host operand's pointer as the kernels must read it over UVA.
int dci_host_device_pointer(void* host_ptr, void** dev_ptr) {
  return int(cudaHostGetDevicePointer(dev_ptr, host_ptr, 0));
}

}  // extern "C"
