"""CUDA kernels for DCI's two-source cached row gather (H100, sm_90a).

Wrappers around ``csrc/cached_gather.cu``, built with ``nvcc`` at first
use and loaded with ``ctypes`` (see ``kernels/_build.py``).  Each replaces
one Pallas TPU kernel of the reference's
``src/repro/kernels/cached_gather/kernel.py``:

  :func:`cached_gather`         ``_cached_gather_db`` — per-row copy from
                                the winning source only
  :func:`cached_gather_blocks`  ``_cached_gather_blocks`` — blocks of
                                ``row_block`` rows that are one contiguous
                                hit or miss run are copied as one span
  :func:`cached_gather_select`  ``cached_gather_select`` — the select
                                made on each row's source address, so the
                                losing candidate is never read; rows move
                                through a ``cp.async`` ring in shared memory

All three return ``out[i] = hot[pos[i]]`` when ``pos[i] >= 0`` (the raw
position) and ``host[idx[i]]`` otherwise, with ids and slots clamped into
their tables as the reference clamps them.  What bounds them is bytes: hit
rows over device memory, miss rows over PCIe when the host table is pinned
host memory (read in place over UVA), and the output written once.

#1 and #2 run a persistent grid: CTAs per SM from the occupancy API times
the SM count, no more than the work needs (:func:`_grid`).  For short
rows read from a pinned host table #1's warps are specialised
(:func:`_miss_warps`): ``MISS_WARPS`` of each CTA copy only miss rows,
the others only hit rows, so PCIe latency never stalls an HBM copy; a
hit warp copies :func:`_rows_per_warp` rows at a time with several load
instructions in flight before it stores, each instruction reading whole
rows (a longer row alone, by all 32 lanes), and a miss warp the misses
among 32 rows at a time.  A warp of #2 takes one row block at a time,
classifies it with warp votes by the reference's rule (the kernel does
what :func:`classify_blocks` states), and copies a run as one span and
any other block row by row.  Both stage rows through registers.

Long miss rows from pinned host memory are read by whole aligned lines
(:func:`_takes_lines`, :func:`line_plan`).  Reddit's 2,408-byte rows,
8-byte aligned and 8 bytes off a 128-byte line, were read as 8-byte
vectors, 256 bytes over three lines an instruction and each row's tail
alone: about 26 GB/s of miss bytes through registers (#1, #2) or a
``cp.async`` ring (#3), against 43 GB/s for 400-byte rows read as 16-byte
vectors, 49 GB/s by the copy engine, and about four times slower with
L1-bypassing ``.cg`` reads than ``.ca``.  The 43 GB/s counted the dedup
bucket's pad rows, which read one host row again and again: the SM's own
reads of pinned memory, whole lines in order, reach only 23-26 GB/s
where the copy engine reaches 42 (PERF.md).  So #2 reads the lines that
cover a miss range as 16-byte pieces, eight lanes a line and four whole
lines an instruction, in one stream over a block's miss rows, never
outside the host table, and stores each byte where it belongs: that
brings Reddit's rows to the ceiling (1.16x on f32 rows, 1.45x on bf16's
4-byte vectors).  The rule, from what the wrapper sees: rows of more than
32 vectors, a pinned host table, a 16-byte aligned host base.  Shorter
rows are one instruction a row already, and hit rows and a host table on
the card are HBM reads, so they are copied as before.

#3 runs the same persistent grid as #1 and #2; its warps stride over chunks of rows
(:func:`_select_ring`: a chunk is one stage of a warp's ring in shared
memory), issue each stage's ``cp.async`` copies, keep ``stages - 1``
stages in flight and store the oldest with coalesced stores; 2- and
1-byte vectors, which ``cp.async`` cannot copy, go through registers in
the same kernel.  The source note in the ``.cu`` file says more.

Routing: on CPU tensors a wrapper computes the plain version
(``ref.py``); with the hot table on a CUDA device it launches its kernel
or raises — there is no fallback.  The host operand is then a CUDA tensor
on the same device or a pinned CPU tensor (pageable memory would fault).
Each wrapper counts its launches in a plain integer attribute,
``<wrapper>.launches``, bumped only where the kernel is launched;
``cached_gather_blocks.line_launches`` counts those of its launches that
read the host side by aligned lines.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.cached_gather.ref import cached_gather_ref

__all__ = [
    "ROW_BLOCK",
    "cached_gather",
    "cached_gather_blocks",
    "cached_gather_select",
    "classify_blocks",
    "line_plan",
    "load_library",
]

ROW_BLOCK = 8  # default rows per block in the row-block variant

# Launch constants shared with csrc/cached_gather.cu.
WARPS_PER_CTA = 8  # kThreads / 32
MISS_WARPS = 2  # warps of each #1 CTA that copy only the miss rows of short rows
UNROLL = 8  # kUnroll: load instructions a warp issues before it stores
# dci_gather_occupancy's kinds; KIND_LINES is #2 reading its host side by lines.
KIND_ROWS, KIND_BLOCKS, KIND_SELECT, KIND_LINES = 0, 1, 2, 3
LINE_BYTES = 128  # kLine: the aligned lines #2 reads long pinned miss rows by
PIECE_BYTES = 16  # kPiece: what one lane reads of a line
# #3's rings: the eight warps of a CTA take 192 KB of an H100 SM's 256 KB
# of L1 and shared memory, so one CTA fits an SM and the rest stays L1,
# which cp.async.ca passes through (rings of 224 KB per SM, or smaller
# stages, read pinned rows more slowly: PERF.md).
SELECT_RING_BYTES = 196_608
SELECT_STAGE_BYTES = 8192  # one stage of a warp's ring: 32 x unroll vectors
MAX_STAGES = 8  # kMaxStages: cp.async.wait_group waits for 7 at most


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its C ABI."""
    from repro_torch.kernels._build import build_library

    path, _ = build_library("cached_gather")
    lib = ctypes.CDLL(str(path))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dci_cached_gather.argtypes = [p, p, p, p, p, ll, ll, ll, ll, i, i, i, i, p]
    lib.dci_cached_gather_select.argtypes = [p, p, p, p, p, ll, ll, ll, ll, i, i, i, i, i, p]
    lib.dci_cached_gather_blocks.argtypes = [p, p, p, p, p, p, ll, ll, ll, ll, ll, i, i, i, p]
    lib.dci_gather_occupancy.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.dci_host_device_pointer.argtypes = [p, ctypes.POINTER(ctypes.c_void_p)]
    for fn in (
        lib.dci_cached_gather,
        lib.dci_cached_gather_select,
        lib.dci_cached_gather_blocks,
        lib.dci_gather_occupancy,
        lib.dci_host_device_pointer,
    ):
        fn.restype = ctypes.c_int
    return lib


def _check_status(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what} failed: CUDA error {status}")


def _validate(hot, host, indices, positions):
    if hot.dim() != 2 or host.dim() != 2 or hot.shape[1] != host.shape[1]:
        raise ValueError("hot and host tables must be 2-D and share the feature dim")
    if hot.shape[0] < 1 or host.shape[0] < 1:
        raise ValueError("hot and host tables need at least one row each")
    if hot.dtype != host.dtype:
        raise ValueError(f"hot ({hot.dtype}) and host ({host.dtype}) dtypes differ")
    if indices.dim() != 1 or positions.shape != indices.shape:
        raise ValueError("indices and positions must be 1-D of the same length")


def _on_cuda(hot, host, indices, positions) -> bool:
    """True: launch the kernel.  False: every operand is on the CPU (plain
    route).  Anything else raises."""
    if hot.device.type == "cpu":
        if host.device.type != "cpu" or indices.is_cuda or positions.is_cuda:
            raise ValueError("a CPU hot table needs CPU host table, indices and positions")
        return False
    if hot.device.type != "cuda":
        raise ValueError(f"unsupported device {hot.device}")
    for name, t in (("indices", indices), ("positions", positions)):
        if t.device != hot.device:
            raise ValueError(f"{name} must be on {hot.device}, got {t.device}")
    if host.is_cuda:
        if host.device != hot.device:
            raise ValueError(f"host table must be on {hot.device} or pinned, got {host.device}")
    elif host.device.type != "cpu" or not host.is_pinned():
        raise ValueError("a host table on the CPU must be pinned (pageable memory would fault)")
    if not (hot.is_contiguous() and host.is_contiguous()):
        raise ValueError("hot and host tables must be contiguous")
    return True


def _host_pointer(host: torch.Tensor) -> int:
    """The address the kernel reads the host table at: the device pointer
    of a CUDA tensor, or the UVA device address of pinned host memory.
    The address is asked for the pinned allocation's base (where its
    storage starts) and the tensor's byte offset added, so a view into a
    pinned table — a shard's row range — reads its own rows."""
    if host.is_cuda:
        return host.data_ptr()
    base = host.untyped_storage().data_ptr()
    dev = ctypes.c_void_p()
    _check_status(
        load_library().dci_host_device_pointer(base, ctypes.byref(dev)),
        "cudaHostGetDevicePointer",
    )
    return dev.value + (host.data_ptr() - base)


def _vec_bytes(row_bytes: int, *ptrs: int) -> int:
    """Widest copy vector (16/8/4/2/1 bytes) dividing the row pitch and
    every base address."""
    g = math.gcd(row_bytes, *ptrs)
    return next(v for v in (16, 8, 4, 2, 1) if g % v == 0)


def _rows_per_warp(row_bytes: int, vec: int) -> int:
    """Rows a warp of #1 copies at a time: one load instruction reads
    ``32 // n_vec`` whole rows of up to 32 vectors, and a warp keeps
    ``UNROLL`` instructions in flight, up to 32 rows (one lane holds each
    row's source address); a longer row is copied alone."""
    n_vec = row_bytes // vec
    return min(32, 32 // n_vec * UNROLL) if n_vec <= 32 else 1


def _miss_warps(row_bytes: int, vec: int, host_on_card: bool) -> int:
    """Warps of each CTA of #1 that copy only miss rows: ``MISS_WARPS`` for
    rows of up to 32 vectors read from a pinned host table, whose HBM and
    PCIe sides overlap only when split (PERF.md), else 0 and every warp
    copies both kinds: from a host table on the card (the prefetch pack)
    the misses are HBM reads too and the split only idles two warps, and
    for longer rows it measured slower."""
    return MISS_WARPS if row_bytes // vec <= 32 and not host_on_card else 0


def _takes_lines(row_bytes: int, vec: int, host_on_card: bool, host_ptr: int) -> bool:
    """Whether #2 reads its host side by whole aligned lines: rows of more
    than 32 vectors read from a pinned host table whose base is 16-byte
    aligned.  A row of up to 32 vectors is already read by one instruction
    (products' 400-byte rows read at the same rate as the lines), a host
    table on the card is HBM, and a base off 16 bytes would cut the pieces
    at the table's head."""
    return row_bytes // vec > 32 and not host_on_card and host_ptr % PIECE_BYTES == 0


def line_plan(src: int, nbytes: int, lo: int, hi: int) -> dict:
    """What ``copy_lines`` reads for one range ``[src, src + nbytes)`` of
    the pinned host table ``[lo, hi)`` (addresses in bytes): its first
    aligned line, the count of lines that cover it, the head skip (the
    bytes of the first line before ``src``) and the byte spans it reads,
    each 16-byte piece of those lines that lies in the table, the last cut
    at ``hi`` where the table ends off a piece.  The kernel's arithmetic,
    for the tests and for ``chip_smoke.py``'s count of lines a miss row."""
    first = src - src % LINE_BYTES
    head = src - first
    n_lines = -(-(head + nbytes) // LINE_BYTES)
    reads = []
    for q in range(first, first + n_lines * LINE_BYTES, PIECE_BYTES):
        if lo <= q < hi:
            reads.append((q, min(q + PIECE_BYTES, hi)))
    return {"first": first, "n_lines": n_lines, "head": head, "reads": reads}


def _select_ring(row_bytes: int, vec: int) -> tuple[int, int, int]:
    """``(chunk_rows, unroll, stages)`` of #3.  A stage is ``32 * unroll``
    vectors, ``SELECT_STAGE_BYTES``; a chunk of rows of up to 32 vectors
    fills one stage (``32 // n_vec`` rows per instruction, at most 32
    rows: one lane holds each row's source), a longer row is a chunk
    alone, in ``ceil(n_vec / (32 * unroll))`` stages.  ``stages`` is as
    many as the rings of a CTA's eight warps fit in ``SELECT_RING_BYTES``,
    at most ``MAX_STAGES``.  A 2- or 1-byte vector takes no ring
    (``stages`` 0): each chunk, as many rows as a warp of #1 takes, goes
    through registers."""
    n_vec = row_bytes // vec
    if vec < 4:
        return _rows_per_warp(row_bytes, vec), UNROLL, 0
    unroll = SELECT_STAGE_BYTES // (32 * vec)
    rows = min(32, 32 // n_vec * unroll) if n_vec <= 32 else 1
    stages = min(MAX_STAGES, SELECT_RING_BYTES // (WARPS_PER_CTA * SELECT_STAGE_BYTES))
    return rows, unroll, stages


def _select_smem(vec: int, unroll: int, stages: int) -> int:
    """Dynamic shared memory of a #3 launch (``select_smem`` in the
    ``.cu``): every warp's ring."""
    return WARPS_PER_CTA * stages * unroll * 32 * vec if vec >= 4 else 0


def _grid(work: int, sm_count: int, ctas_per_sm: int, warps: int = WARPS_PER_CTA) -> int:
    """CTAs of a persistent launch over ``work`` items for ``warps`` warps
    of each CTA (chunks of rows for #1's hit warps and for #3, row blocks
    for #2): every CTA the card holds at once, or fewer when the work does
    not fill them."""
    return max(1, min(sm_count * ctas_per_sm, -(-work // warps)))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _ctas_per_sm(kind: int, vec: int, smem: int = 0) -> int:
    n = ctypes.c_int()
    _check_status(load_library().dci_gather_occupancy(kind, vec, smem, ctypes.byref(n)),
                  "cudaOccupancyMaxActiveBlocksPerMultiprocessor")
    if n.value < 1:
        raise RuntimeError(f"no CTA of gather kind {kind} fits on an SM")
    return n.value


def _launch_args(hot, host, indices, positions):
    idx = indices.to(torch.int32).contiguous()
    pos = positions.to(torch.int32).contiguous()
    out = torch.empty((idx.shape[0], hot.shape[1]), dtype=hot.dtype, device=hot.device)
    row_bytes = hot.shape[1] * hot.element_size()
    host_ptr = _host_pointer(host)
    vec = _vec_bytes(row_bytes, hot.data_ptr(), host_ptr, out.data_ptr())
    stream = torch.cuda.current_stream(hot.device).cuda_stream
    return idx, pos, out, row_bytes, host_ptr, vec, stream


def cached_gather(
    hot_table: torch.Tensor,  # [H, F]
    host_table: torch.Tensor,  # [N, F]
    indices: torch.Tensor,  # int32 [S]
    positions: torch.Tensor,  # int32 [S] (slot or -1)
) -> torch.Tensor:
    """Two-source gather: a persistent grid whose warps copy chunks of
    rows, each row from its winning source only (for short rows from a
    pinned host table, hit and miss rows by separate warps)."""
    _validate(hot_table, host_table, indices, positions)
    if not _on_cuda(hot_table, host_table, indices, positions):
        return cached_gather_ref(hot_table, host_table, indices, positions)
    if indices.shape[0] == 0:  # nothing to gather; skip the launch
        return hot_table.new_empty((0, hot_table.shape[1]))
    idx, pos, out, row_bytes, host_ptr, vec, stream = _launch_args(
        hot_table, host_table, indices, positions
    )
    rows = _rows_per_warp(row_bytes, vec)
    miss_warps = _miss_warps(row_bytes, vec, host_table.is_cuda)
    grid = _grid(-(-idx.shape[0] // rows), _sm_count(hot_table.device.index),
                 _ctas_per_sm(KIND_ROWS, vec), WARPS_PER_CTA - miss_warps)
    status = load_library().dci_cached_gather(
        hot_table.data_ptr(), host_ptr, idx.data_ptr(), pos.data_ptr(), out.data_ptr(),
        idx.shape[0], row_bytes, hot_table.shape[0], host_table.shape[0], vec, rows, miss_warps,
        grid, stream,
    )
    _check_status(status, "dci_cached_gather launch")
    cached_gather.launches += 1
    return out


cached_gather.launches = 0


def cached_gather_select(
    hot_table: torch.Tensor,
    host_table: torch.Tensor,
    indices: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """Two-source gather, the port of the reference's select kernel with
    the select made on each row's source address: a persistent grid whose
    warps move chunks of rows through a ``cp.async`` ring in shared memory
    (:func:`_select_ring`), each row from its winning source only."""
    _validate(hot_table, host_table, indices, positions)
    if not _on_cuda(hot_table, host_table, indices, positions):
        return cached_gather_ref(hot_table, host_table, indices, positions)
    if indices.shape[0] == 0:
        return hot_table.new_empty((0, hot_table.shape[1]))
    idx, pos, out, row_bytes, host_ptr, vec, stream = _launch_args(
        hot_table, host_table, indices, positions
    )
    rows, unroll, stages = _select_ring(row_bytes, vec)
    smem = _select_smem(vec, unroll, stages)
    grid = _grid(-(-idx.shape[0] // rows), _sm_count(hot_table.device.index),
                 _ctas_per_sm(KIND_SELECT, vec, smem))
    status = load_library().dci_cached_gather_select(
        hot_table.data_ptr(), host_ptr, idx.data_ptr(), pos.data_ptr(), out.data_ptr(),
        idx.shape[0], row_bytes, hot_table.shape[0], host_table.shape[0], vec, rows, unroll,
        stages, grid, stream,
    )
    _check_status(status, "dci_cached_gather_select launch")
    cached_gather_select.launches += 1
    return out


cached_gather_select.launches = 0


def classify_blocks(
    indices: torch.Tensor,
    positions: torch.Tensor,
    num_hot: int,
    num_host: int,
    row_block: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(blk_mode, blk_start)``, ``int32[ceil(S / row_block)]`` each: the
    plain statement of the rule kernel #2 applies to each block itself
    (the GPU tests hold the kernel's modes to it).

    The reference's rule (``kernel.py:391-407``): a block whose rows all
    hit at consecutive (clamped) hot slots is mode 1, all miss at
    consecutive (clamped) host ids mode 2, anything else mode 0;
    ``blk_start`` is the block's first source row.  The reference pads the
    ragged last block with miss rows of host row 0, which always breaks
    its run, so that block is mode 0 here without padding anything."""
    s = indices.shape[0]
    n_full = s // row_block
    n_blocks = -(-s // row_block)
    pos = positions.to(torch.int32)
    hit = pos >= 0
    src = torch.where(
        hit, pos.clamp(0, num_hot - 1), indices.to(torch.int32).clamp(0, num_host - 1)
    )
    mode = torch.zeros(n_blocks, dtype=torch.int32, device=indices.device)
    start = torch.zeros(n_blocks, dtype=torch.int32, device=indices.device)
    if n_full:
        src_b = src[: n_full * row_block].view(n_full, row_block)
        hit_b = hit[: n_full * row_block].view(n_full, row_block)
        contig = (src_b[:, 1:] == src_b[:, :-1] + 1).all(dim=1)
        mode[:n_full] = torch.where(
            contig & hit_b.all(dim=1),
            1,
            torch.where(contig & (~hit_b).all(dim=1), 2, 0),
        ).to(torch.int32)
        start[:n_full] = src_b[:, 0]
    if n_blocks > n_full:
        start[n_full] = src[n_full * row_block]
    return mode, start


def _launch_blocks(hot, host, indices, positions, row_block, *, modes=None):
    """Launch #2 on validated CUDA operands (the hot table already padded
    to ``row_block`` rows); return the output and whether the launch read
    its host side by aligned lines (:func:`_takes_lines`).  ``modes``
    (``int32``, one entry per block, on the card) receives the in-kernel
    classification; the wrapper passes none, chip_smoke.py and the GPU
    tests hold it to :func:`classify_blocks`."""
    if row_block * hot.shape[1] * hot.element_size() >= 2**31:
        raise ValueError(f"a block of {row_block} rows exceeds 2 GiB")
    idx, pos, out, row_bytes, host_ptr, vec, stream = _launch_args(hot, host, indices, positions)
    lines = _takes_lines(row_bytes, vec, host.is_cuda, host_ptr)
    grid = _grid(-(-idx.shape[0] // row_block), _sm_count(hot.device.index),
                 _ctas_per_sm(KIND_LINES if lines else KIND_BLOCKS, vec))
    status = load_library().dci_cached_gather_blocks(
        hot.data_ptr(), host_ptr, idx.data_ptr(), pos.data_ptr(), out.data_ptr(),
        0 if modes is None else modes.data_ptr(), idx.shape[0], row_bytes, hot.shape[0],
        host.shape[0], row_block, vec, int(lines), grid, stream,
    )
    _check_status(status, "dci_cached_gather_blocks launch")
    return out, lines


def cached_gather_blocks(
    hot_table: torch.Tensor,
    host_table: torch.Tensor,
    indices: torch.Tensor,
    positions: torch.Tensor,
    *,
    row_block: int = ROW_BLOCK,
) -> torch.Tensor:
    """Row-block two-source gather for sorted-run frontiers.

    Identical output to :func:`cached_gather` for ANY index order — blocks
    that are not one contiguous single-source run are copied row by row —
    but a deduped (sorted unique) frontier, whose hit slots and miss ids
    run consecutively, collapses most blocks to one contiguous span copy.
    ``row_block == 1`` routes to :func:`cached_gather`, as the reference
    does.

    A hot table shorter than ``row_block`` is zero-padded to ``row_block``
    rows first, on both routes, as the reference's row-block kernel pads
    it (``kernel.py:377-380``): a slot in ``[H, row_block)`` then reads a
    zero row, and larger slots clamp into the padded table.  Host ids
    clamp into the real host table, padded or not."""
    _validate(hot_table, host_table, indices, positions)
    if row_block < 1:
        raise ValueError(f"row_block must be >= 1, got {row_block}")
    on_cuda = _on_cuda(hot_table, host_table, indices, positions)
    if indices.shape[0] == 0:
        return hot_table.new_empty((0, hot_table.shape[1]))
    if row_block == 1:
        return cached_gather(hot_table, host_table, indices, positions)
    if hot_table.shape[0] < row_block:
        hot_table = torch.cat(
            [hot_table, hot_table.new_zeros((row_block - hot_table.shape[0], hot_table.shape[1]))]
        )
    if not on_cuda:
        return cached_gather_ref(hot_table, host_table, indices, positions)
    out, lines = _launch_blocks(hot_table, host_table, indices, positions, row_block)
    cached_gather_blocks.launches += 1
    cached_gather_blocks.line_launches += int(lines)
    return out


cached_gather_blocks.launches = 0
cached_gather_blocks.line_launches = 0
