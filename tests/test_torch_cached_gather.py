"""The port's cached gather (CPU route) against the JAX Pallas kernels.

The JAX side runs the Pallas kernels in interpret mode, as
tests/test_kernels.py does.  A gather is a pure copy, so every comparison
is exact.  The CUDA route of the same wrappers is held to ``ref.py`` on the
card by tests/test_torch_kernels_gpu.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.cached_gather.kernel import (
    cached_gather as jax_cached_gather,
    cached_gather_blocks as jax_cached_gather_blocks,
    cached_gather_select as jax_cached_gather_select,
)
from repro_torch.kernels.cached_gather import kernel as tk
from repro_torch.kernels.cached_gather.ops import cached_feature_gather
from repro_torch.kernels.cached_gather.ref import cached_gather_ref

# One intra-op thread: these tests share the machine with other test workers.
torch.set_num_threads(1)

RNG = np.random.default_rng(0)

PORT = {
    "db": tk.cached_gather,
    "blocks": tk.cached_gather_blocks,
    "select": tk.cached_gather_select,
}
REF = {
    "db": jax_cached_gather,
    "blocks": jax_cached_gather_blocks,
    "select": lambda *a: jax_cached_gather_select(*a, interpret=True),
}


def _case(h, n, f, s, dtype=np.float32, idx=None, pos=None):
    hot = RNG.standard_normal((h, f)).astype(dtype)
    host = RNG.standard_normal((n, f)).astype(dtype)
    idx = RNG.integers(0, n, s).astype(np.int32) if idx is None else np.asarray(idx, np.int32)
    pos = RNG.integers(-1, h, s).astype(np.int32) if pos is None else np.asarray(pos, np.int32)
    return hot, host, idx, pos


def _both(kind, hot, host, idx, pos, **kw):
    """(port output, reference output) as numpy arrays."""
    port = PORT[kind](
        torch.from_numpy(hot.view(np.uint16)).view(torch.bfloat16)
        if hot.dtype == ml_dtypes.bfloat16
        else torch.from_numpy(hot),
        torch.from_numpy(host.view(np.uint16)).view(torch.bfloat16)
        if host.dtype == ml_dtypes.bfloat16
        else torch.from_numpy(host),
        torch.from_numpy(idx),
        torch.from_numpy(pos),
        **kw,
    )
    ref = REF[kind](jnp.asarray(hot), jnp.asarray(host), jnp.asarray(idx), jnp.asarray(pos), **kw)
    if port.dtype == torch.bfloat16:
        return port.view(torch.uint16).numpy(), np.asarray(ref).view(np.uint16)
    return port.numpy(), np.asarray(ref)


@pytest.mark.parametrize("kind", ["db", "blocks", "select"])
@pytest.mark.parametrize("h,n,f,s", [(16, 100, 64, 32), (8, 50, 602, 7), (4, 256, 128, 200), (1, 10, 16, 1)])
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_gather_matches_jax_random(kind, h, n, f, s, dtype):
    port, ref = _both(kind, *_case(h, n, f, s, dtype))
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("kind", ["db", "blocks", "select"])
def test_gather_all_hits_all_misses_and_empty(kind):
    hot, host, idx, _ = _case(4, 9, 8, 4, idx=np.arange(4))
    for pos in (np.arange(4), np.full(4, -1)):
        port, ref = _both(kind, hot, host, idx, pos.astype(np.int32))
        np.testing.assert_array_equal(port, ref)
    empty = PORT[kind](
        torch.from_numpy(hot),
        torch.from_numpy(host),
        torch.zeros(0, dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32),
    )
    assert empty.shape == (0, 8) and empty.dtype == torch.float32


@pytest.mark.parametrize("kind", ["db", "blocks", "select"])
@pytest.mark.parametrize("f", [96, 130, 250, 602])
def test_gather_feature_dims_not_multiple_of_128(kind, f):
    port, ref = _both(kind, *_case(6, 40, f, 17))
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("kind", ["db", "blocks", "select"])
def test_gather_out_of_range_ids_and_slots_clamp(kind):
    """Ids past the host table and slots past the hot table clamp, as in
    the reference; a negative slot is a miss.  (Both tables hold at least
    one row block: the reference's row-block kernel pads smaller tables
    with zero rows, and an out-of-range slot would then read a pad row.)"""
    idx = np.array([0, 9, 50, 3, 1000, 2, 7, 8, 4], np.int32)
    pos = np.array([-1, 3, 100, -1, -1, 0, 17, -5, 2], np.int32)
    port, ref = _both(kind, *_case(12, 10, 24, 9, idx=idx, pos=pos))
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_blocks_pad_a_hot_table_shorter_than_a_row_block(dtype):
    """With H = 4 < row_block, the reference's row-block kernel zero-pads
    the hot table to 8 rows before clamping slots: slot 5 reads a zero pad
    row and slot 100 clamps to pad row 7.  The port's row-block gather
    pads the same way; the per-row gathers keep clamping to row H - 1."""
    pos = np.array([0, 1, 2, 3, 5, 100, -1, 2, 5], np.int32)
    idx = np.array([3, 0, 9, 1, 4, 2, 7, 40, 6], np.int32)
    hot, host, idx, pos = _case(4, 10, 24, 9, dtype, idx=idx, pos=pos)
    port, ref = _both("blocks", hot, host, idx, pos)
    np.testing.assert_array_equal(port, ref)
    assert not port[[4, 5, 8]].any() and port[[0, 1, 2, 3]].any(axis=1).all()
    db, db_ref = _both("db", hot, host, idx, pos)
    np.testing.assert_array_equal(db, db_ref)
    np.testing.assert_array_equal(db[5], db[3])


def test_blocks_contiguous_runs_and_row_block_edges():
    """Sorted ids with id-ordered slots collapse to runs on both sources;
    row_block 1, 4 and 16 (larger than S) stay exact; row_block 0 raises."""
    host = RNG.standard_normal((64, 128)).astype(np.float32)
    ids = np.arange(10, 42, dtype=np.int32)
    for pos in (ids, np.full(32, -1, np.int32)):
        port, ref = _both("blocks", host, host, ids, pos)
        np.testing.assert_array_equal(port, ref)
        np.testing.assert_array_equal(port, host[10:42])
    hot, host, idx, _ = _case(4, 9, 130, 3)
    pos = np.array([-1, 0, 2], np.int32)
    for rb in (1, 4, 16):
        port, ref = _both("blocks", hot, host, idx, pos, row_block=rb)
        np.testing.assert_array_equal(port, ref)
    with pytest.raises(ValueError):
        tk.cached_gather_blocks(
            torch.from_numpy(hot), torch.from_numpy(host), torch.from_numpy(idx),
            torch.from_numpy(pos), row_block=0,
        )


def _classify_numpy(idx, pos, n_hot, n_host, row_block):
    """kernel.py:367-407 of the reference, read in numpy: pad the row axis
    to whole blocks with (idx 0, pos -1), then classify each block."""
    s = idx.shape[0]
    sp = -(-s // row_block) * row_block
    idx = np.clip(np.pad(idx, (0, sp - s)), 0, n_host - 1)
    pos_raw = np.pad(pos, (0, sp - s), constant_values=-1)
    pos_c = np.clip(pos_raw, 0, max(n_hot, row_block) - 1)
    hit = pos_raw >= 0
    src = np.where(hit, pos_c, idx).reshape(-1, row_block)
    hit_b = hit.reshape(-1, row_block)
    contig = np.all(src[:, 1:] == src[:, :-1] + 1, axis=1)
    mode = np.where(contig & hit_b.all(1), 1, np.where(contig & (~hit_b).all(1), 2, 0))
    return mode.astype(np.int32), src[:, 0].astype(np.int32)


@pytest.mark.parametrize("row_block", [1, 2, 8])
@pytest.mark.parametrize("s", [1, 8, 37, 64])
def test_block_classification_matches_reference_rule(row_block, s):
    n_hot, n_host = 40, 300
    # Mix sorted runs (which classify) with random rows (which do not).
    idx = np.sort(RNG.choice(n_host, s, replace=False)).astype(np.int32)
    idx[: s // 2] = np.arange(100, 100 + s // 2)
    pos = np.where(RNG.random(s) < 0.5, -1, 0).astype(np.int32)
    pos[: s // 4] = np.arange(3, 3 + s // 4)
    pos[s // 4 : s // 2] = -1
    mode, start = tk.classify_blocks(
        torch.from_numpy(idx), torch.from_numpy(pos), n_hot, n_host, row_block
    )
    want_mode, want_start = _classify_numpy(idx, pos, n_hot, n_host, row_block)
    np.testing.assert_array_equal(mode.numpy(), want_mode)
    np.testing.assert_array_equal(start.numpy(), want_start)
    assert (mode.numpy() > 0).any() or s < 2 * row_block or row_block == 1


def test_ops_routes_and_ref_on_cpu():
    hot, host, idx, pos = _case(8, 30, 160, 11)
    args = [torch.from_numpy(a) for a in (hot, host, idx, pos)]
    want = np.asarray(
        jax_cached_gather_select(*(jnp.asarray(a) for a in (hot, host, idx, pos)), interpret=True)
    )
    for use_kernel in (False, True):
        np.testing.assert_array_equal(
            cached_feature_gather(*args, use_kernel=use_kernel).numpy(), want
        )
    np.testing.assert_array_equal(cached_gather_ref(*args).numpy(), want)


def test_cpu_route_launches_no_kernel():
    """On CPU tensors the wrappers compute the plain version and never
    count a launch."""
    before = (tk.cached_gather.launches, tk.cached_gather_blocks.launches,
              tk.cached_gather_select.launches)
    hot, host, idx, pos = (torch.from_numpy(a) for a in _case(4, 20, 16, 9))
    tk.cached_gather(hot, host, idx, pos)
    tk.cached_gather_blocks(hot, host, idx, pos)
    tk.cached_gather_select(hot, host, idx, pos)
    after = (tk.cached_gather.launches, tk.cached_gather_blocks.launches,
             tk.cached_gather_select.launches)
    assert before == after


def test_wrapper_validates_operands():
    hot, host = torch.zeros(2, 8), torch.zeros(5, 8)
    z = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        tk.cached_gather(hot, torch.zeros(5, 9), z, z)  # feature dims differ
    with pytest.raises(ValueError):
        tk.cached_gather(hot, host.to(torch.float64), z, z)  # dtypes differ
    with pytest.raises(ValueError):
        tk.cached_gather(hot, host, z, torch.zeros(4, dtype=torch.int32))  # lengths differ
    with pytest.raises(ValueError):
        tk.cached_gather(hot, host.to("meta"), z, z)  # host on another device


def test_vector_width_follows_pitch_and_alignment():
    assert tk._vec_bytes(400, 256, 512, 1024) == 16  # ogbn-products rows
    assert tk._vec_bytes(2408, 256, 512, 1024) == 8  # reddit rows: 8-byte pitch
    assert tk._vec_bytes(400, 256, 520, 1024) == 8  # an 8-byte-aligned base
    assert tk._vec_bytes(6, 256, 512, 1024) == 2  # three bf16 values
    assert tk._vec_bytes(3, 256, 512, 1024) == 1


@pytest.mark.parametrize(
    "row_bytes,vec,rows",
    [(400, 16, 8), (512, 16, 8), (800, 16, 1), (2408, 8, 1), (1204, 4, 1), (200, 8, 8),
     (64, 16, 32), (6, 2, 32), (2, 2, 32), (96, 8, 16)],
)
def test_rows_per_warp_keeps_eight_loads_in_flight(row_bytes, vec, rows):
    """#1's chunk: one load instruction reads 32 // n_vec whole rows of up
    to 32 vectors; a warp takes the rows of eight instructions, up to 32
    (one source address per lane).  A row longer than 32 vectors is
    copied alone."""
    assert tk._rows_per_warp(row_bytes, vec) == rows
    n_vec = row_bytes // vec
    if n_vec <= 32:
        assert -(-rows // (32 // n_vec)) <= tk.UNROLL and (rows == 32 or rows % (32 // n_vec) == 0)


@pytest.mark.parametrize(
    "work,warps,grid",
    [
        (0, 8, 1),  # S = 0 is never launched (the wrappers return first); 1 is the least
        (1, 8, 1),  # S = 1
        (8, 8, 1),  # one CTA's warps
        (9, 8, 2),  # one chunk more
        (279, 8, 35),  # S just below one grid of the small card
        (280, 8, 35),  # exactly one grid
        (281, 8, 35),  # above one grid: the grid stays the card's, warps stride
        (210, 6, 35),  # #1 split: the grid counts hit warps only
        (211, 6, 35),
        (209, 6, 35),
        (204, 6, 34),
    ],
)
def test_persistent_grid_covers_every_row_once(work, warps, grid):
    """The grid is every CTA the card holds (SM count x CTAs per SM), or
    fewer when the work (chunks of rows for #1, row blocks for #2) does
    not fill them: then one pass of the warps covers every chunk once and
    no CTA is left without a chunk for its first warp.  (A larger grid's
    stride loop is covered on the card by the ragged-tail GPU test.)"""
    sm, ctas = 7, 5  # a small card, so that the work crosses whole grids here
    assert tk._grid(work, sm, ctas, warps) == grid
    assert 1 <= grid <= sm * ctas
    if grid < sm * ctas:
        assert (grid - 1) * warps < max(work, 1) <= grid * warps


@pytest.mark.parametrize("host_on_card", [False, True])
@pytest.mark.parametrize("row_bytes,vec,split", [(400, 16, True), (512, 16, True), (2408, 8, False),
                                                 (1204, 4, False), (2, 2, True), (6, 2, True)])
def test_miss_warps_split_short_rows_only(row_bytes, vec, split, host_on_card):
    """#1 splits its warps into hit and miss warps for rows of up to 32
    vectors read from a pinned host table, and lets every warp take both
    kinds for longer rows and for a host table on the card (the prefetch
    pack), whose misses are HBM reads too."""
    want = tk.MISS_WARPS if split and not host_on_card else 0
    assert tk._miss_warps(row_bytes, vec, host_on_card) == want
    assert 0 <= want < tk.WARPS_PER_CTA


def test_grid_at_the_main_shape():
    """1,081,344 frontier rows of 400 bytes: 8 rows per warp, and far more
    chunks than one grid of an H100 (132 SMs) holds, so the grid is the
    card's; the dedup bucket's 8-row blocks likewise."""
    rows = tk._rows_per_warp(400, 16)
    assert rows == 8 and tk._grid(-(-1_081_344 // rows), 132, 4, 6) == 528
    assert tk._grid(-(-1_081_344 // rows), 132, 4, 8) == 528
    assert tk._grid(262_144 // 8, 132, 4) == 528
    assert tk._grid(3, 132, 4) == 1


@pytest.mark.parametrize(
    "row_bytes,vec,ring",
    [
        (400, 16, (16, 16, 3)),  # ogbn-products rows: sixteen rows fill a stage
        (512, 16, (16, 16, 3)),
        (64, 16, (32, 16, 3)),  # eight rows per instruction, 32 lanes' rows at most
        (16, 16, (32, 16, 3)),
        (200, 8, (32, 32, 3)),  # F = 100 bf16
        (2408, 8, (1, 32, 3)),  # reddit rows: a chunk alone, 301 vectors of a stage's 1,024
        (9000, 8, (1, 32, 3)),  # F = 4500 bf16: 1,125 vectors, two stages
        (10000, 16, (1, 16, 3)),  # F = 2500 f32: 625 vectors, two stages
        (1204, 4, (1, 64, 3)),  # F = 602 bf16
        (20004, 4, (1, 64, 3)),  # F = 10002 bf16: 5,001 vectors, three stages
        (4, 4, (32, 64, 3)),  # F = 1 f32
        (6, 2, (32, 8, 0)),  # F = 3 bf16: no cp.async of 2 bytes, registers
        (2, 2, (32, 8, 0)),  # F = 1 bf16
        (3, 1, (32, 8, 0)),
        (1206, 2, (1, 8, 0)),  # F = 603 bf16: a long row through registers
    ],
)
def test_select_ring_fits_shared_memory(row_bytes, vec, ring):
    """#3's ring: a stage is SELECT_STAGE_BYTES, 32 lanes x unroll
    vectors; a chunk of short rows fills at most one stage, with one lane
    to hold each row's source; a longer row is a chunk alone; the rings
    of a CTA's eight warps fit in SELECT_RING_BYTES, within the 227 KB a
    CTA may use and, with the 1 KB that CUDA reserves per CTA, in an H100 SM's 228
    KB of shared memory.  2- and 1-byte vectors take no ring."""
    assert tk._select_ring(row_bytes, vec) == ring
    rows, unroll, stages = ring
    n_vec = row_bytes // vec
    smem = tk._select_smem(vec, unroll, stages)
    assert 1 <= rows <= 32
    if n_vec > 32:
        assert rows == 1
    if vec < 4:
        assert stages == 0 and smem == 0 and rows == tk._rows_per_warp(row_bytes, vec)
        return
    assert 32 * unroll * vec == tk.SELECT_STAGE_BYTES
    assert 2 <= stages <= tk.MAX_STAGES
    if n_vec <= 32:
        assert -(-rows // (32 // n_vec)) <= unroll
    assert smem == tk.WARPS_PER_CTA * stages * tk.SELECT_STAGE_BYTES <= tk.SELECT_RING_BYTES
    assert smem <= 232_448 and smem + 1024 <= 233_472


def _select_stage(c, piece, s, n_vec, chunk_rows, unroll):
    """The live lanes of one stage of #3, as the kernel lays it out: a
    list of (ring slot offset, output row, vector of the row)."""
    short = n_vec <= 32
    per_load = 32 // n_vec if short else 1
    rows = min(chunk_rows, s - c * chunk_rows)
    base = piece * 32 * unroll
    n_inst = -(-rows // per_load) if short else min(unroll, -(-(n_vec - base) // 32))
    lanes = []
    for u in range(n_inst):
        for lane in range(32):
            if short:
                r, k = u * per_load + lane // n_vec, lane % n_vec
                live = lane // n_vec < per_load and r < rows
            else:
                r, k = 0, base + u * 32 + lane
                live = k < n_vec
            if live:
                lanes.append((u * 32 + lane, c * chunk_rows + r, k))
    return lanes


def _simulate_select(s, row_bytes, vec, sm_count, ctas_per_sm):
    """Every (row, vector) the kernel's warps store, counted, walking each
    warp's stride loop as the kernel does: the issue side and the drain
    side keep their own chunk, piece and ring slot, and the drain of a
    stage must find in its slot what the issue side put there."""
    chunk_rows, unroll, stages = tk._select_ring(row_bytes, vec)
    n_vec = row_bytes // vec
    stored = np.zeros((s, n_vec), np.int64)
    n_chunks = -(-s // chunk_rows)
    grid = tk._grid(n_chunks, sm_count, ctas_per_sm)
    stride = grid * tk.WARPS_PER_CTA
    if stages == 0:  # registers: each chunk's rows whole
        for first in range(stride):
            for c in range(first, n_chunks, stride):
                stored[c * chunk_rows : (c + 1) * chunk_rows] += 1
        return stored, grid
    pieces = 1 if n_vec <= 32 else -(-n_vec // (32 * unroll))
    for first in range(min(stride, n_chunks)):
        ring = [None] * stages
        n_stages = ((n_chunks - 1 - first) // stride + 1) * pieces
        ic = dc = first
        ip = dp = slot_i = slot_d = 0
        for t in range(n_stages + stages - 1):
            if t < n_stages:
                ring[slot_i] = _select_stage(ic, ip, s, n_vec, chunk_rows, unroll)
                ip += 1
                if ip == pieces:
                    ip, ic = 0, ic + stride
                slot_i = (slot_i + 1) % stages
            if t >= stages - 1:
                lanes = _select_stage(dc, dp, s, n_vec, chunk_rows, unroll)
                assert ring[slot_d] == lanes
                assert len({off for off, _, _ in lanes}) == len(lanes) <= 32 * unroll
                for _, r, k in lanes:
                    stored[r, k] += 1
                ring[slot_d] = None
                dp += 1
                if dp == pieces:
                    dp, dc = 0, dc + stride
                slot_d = (slot_d + 1) % stages
        assert ring == [None] * stages  # every issued stage drained
    return stored, grid


@pytest.mark.parametrize("row_bytes,vec", [(400, 16), (2408, 8), (1204, 4), (10000, 16),
                                           (20004, 4), (64, 16), (4, 4), (6, 2), (1206, 2)])
def test_select_stride_stores_every_vector_once(row_bytes, vec):
    """#3's persistent stride over chunks and its ring walk store every
    vector of every output row exactly once, for S below, at and just
    above one chunk and one grid of a small card, and S = 1."""
    sm, ctas = 3, 2
    chunk_rows = tk._select_ring(row_bytes, vec)[0]
    grid_rows = sm * ctas * tk.WARPS_PER_CTA * chunk_rows
    for s in sorted({1, chunk_rows - 1, chunk_rows, chunk_rows + 1, grid_rows - 1, grid_rows,
                     grid_rows + 1, 2 * grid_rows + 3} - {0}):
        stored, grid = _simulate_select(s, row_bytes, vec, sm, ctas)
        assert (stored == 1).all(), s
        assert 1 <= grid <= sm * ctas


def test_occupancy_kinds_match_the_source():
    """The kinds the wrappers pass to dci_gather_occupancy name the
    kernels kernel_of maps them to in the .cu source, and the launch
    constants the wrapper mirrors equal the source's."""
    import re

    from repro_torch.kernels._build import CSRC

    src = (CSRC / "cached_gather.cu").read_text()
    kinds = dict(re.findall(r"case (\d): return reinterpret_cast<const void\*>\((\w+<V[\w, ]*>)\)",
                            src))
    assert kinds == {
        str(tk.KIND_ROWS): "gather_rows_kernel<V>",
        str(tk.KIND_BLOCKS): "gather_blocks_kernel<V>",
        str(tk.KIND_SELECT): "gather_select_kernel<V>",
        str(tk.KIND_LINES): "gather_blocks_kernel<V, true>",
    }
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+)", src))
    assert int(const["kThreads"]) // 32 == tk.WARPS_PER_CTA
    assert int(const["kUnroll"]) == tk.UNROLL
    assert int(const["kMaxStages"]) == tk.MAX_STAGES
    assert int(const["kLine"]) == tk.LINE_BYTES and int(const["kPiece"]) == tk.PIECE_BYTES


# --------------------------------------------------------------------------
# #2's aligned-line copy of long pinned miss rows (copy_lines in the .cu).

LINE, PIECE = tk.LINE_BYTES, tk.PIECE_BYTES


@pytest.mark.parametrize(
    "row_bytes,vec,host_on_card,base_mod,lines",
    [
        (2408, 8, False, 0, True),  # Reddit's f32 rows, pinned: the cells' case
        (1204, 4, False, 0, True),  # Reddit's rows in bf16
        (602, 2, False, 0, True),  # bf16 rows of an odd width
        (528, 16, False, 0, True),  # 33 vectors of 16 bytes
        (2408, 8, True, 0, False),  # a host table on the card (the prefetch pack): HBM
        (2408, 8, False, 8, False),  # a pinned view whose base is off 16 bytes
        (400, 16, False, 0, False),  # products' rows: one instruction a row already
        (512, 16, False, 0, False),  # the embedding rows: 32 vectors
        (256, 8, False, 0, False),  # 32 vectors of 8 bytes
        (6, 2, False, 0, False),
    ],
)
def test_line_copy_rule_follows_row_length_placement_and_base(row_bytes, vec, host_on_card,
                                                                base_mod, lines):
    """#2 reads its host side by aligned lines exactly when the rows are
    longer than 32 vectors, the host table is pinned host memory and its
    base is 16-byte aligned."""
    assert tk._takes_lines(row_bytes, vec, host_on_card, 4096 * 7 + base_mod) == lines


def _table(n_rows, row_bytes, base_mod=48):
    """``(lo, hi)`` of a pinned table of ``n_rows`` rows inside a larger
    buffer: its base 16-byte aligned and ``base_mod`` bytes past a line."""
    lo = 64 * LINE + base_mod
    return lo, lo + n_rows * row_bytes


LINE_PLAN_CASES = {
    # Reddit's rows start at id x 2,408, 104 mod 128: ids 0-15 meet all
    # sixteen 8-byte offsets within a line (the base adds 48 to each).
    **{f"offset{i}": (2408, 101, [i], 1) for i in range(16)},
    "first_row": (2408, 101, [0], 1),  # the table's head, off a line
    "last_row_odd_end": (2408, 101, [100], 1),  # the table ends 8 bytes off a piece
    "span_of_8": (2408, 101, [40], 8),  # a mode-2 span
    "span_to_the_end": (2408, 101, [68], 33),
    "bf16": (1204, 77, [3], 1),
    "two_byte_vectors": (602, 77, [76], 1),
}


@pytest.mark.parametrize("case", sorted(LINE_PLAN_CASES))
def test_line_plan_reads_whole_lines_inside_the_table(case):
    """``line_plan``: the first line is the aligned line at or before the
    range, the head skip the bytes before the range in it, and the count
    covers the range; the reads are the 16-byte pieces of those lines that
    lie in the table, so they cover the range, never leave the table, and
    fill every line except where the table's own ends cut it."""
    row_bytes, n_rows, (row,), rows = LINE_PLAN_CASES[case]
    lo, hi = _table(n_rows, row_bytes)
    src, nbytes = lo + row * row_bytes, rows * row_bytes
    plan = tk.line_plan(src, nbytes, lo, hi)
    assert plan["first"] % LINE == 0 and plan["first"] <= src < plan["first"] + LINE
    assert plan["head"] == src - plan["first"]
    assert plan["first"] + (plan["n_lines"] - 1) * LINE < src + nbytes
    assert src + nbytes <= plan["first"] + plan["n_lines"] * LINE
    assert plan["n_lines"] <= nbytes // LINE + 2
    read = set()
    for a, b in plan["reads"]:
        assert lo <= a < b <= hi and a % PIECE == 0
        assert b - a == PIECE or b == hi  # only the table's end cuts a piece
        read.update(range(a, b))
    assert set(range(src, src + nbytes)) <= read
    for k in range(plan["n_lines"]):
        line = range(plan["first"] + k * LINE, plan["first"] + (k + 1) * LINE)
        assert {x for x in line if lo <= x < hi} <= read  # the line, whole within the table


def _copy_lines(mem, out, srcs, dsts, nbytes, lo, hi, vec):
    """copy_lines as one warp of the kernel runs it, on a byte array:
    lane s < len(srcs) holds range s.  Returns every byte stored (with its
    count) and every byte read."""
    segs = len(srcs)
    head = [a % LINE for a in srcs] + [0] * (32 - segs)
    n = [-(-(head[s] + nbytes) // LINE) for s in range(segs)] + [0] * (32 - segs)
    end = list(np.cumsum(n))
    total = end[-1]
    rel = [-head[s] - (end[s] - n[s]) * LINE for s in range(32)]
    stored, read = np.zeros(out.shape[0], np.int64), []
    for t0 in range(0, total, 4 * tk.UNROLL):
        issued = []
        for u in range(tk.UNROLL):
            first = t0 + u * 4
            for lane in range(32):
                sub = lane // 8
                s = min(sum(e <= first + sub for e in end), 31)
                t = first + sub
                off = rel[s] + t * LINE + (lane % 8) * PIECE
                if t >= total:
                    continue
                q = srcs[s] + off
                piece = np.zeros(PIECE, np.uint8)
                if lo <= q < hi:  # load_piece: whole, or its units below hi
                    for k in range(0, PIECE, vec):
                        if q + PIECE <= hi or q + k + vec <= hi:
                            piece[k : k + vec] = mem[q + k : q + k + vec]
                            read.extend(range(q + k, q + k + vec))
                issued.append((piece, off, s))
        for piece, off, s in issued:  # store_piece
            for k in range(0, PIECE, vec):
                x = off + k
                if 0 <= x < nbytes:
                    out[dsts[s] + x : dsts[s] + x + vec] = piece[k : k + vec]
                    stored[dsts[s] + x : dsts[s] + x + vec] += 1
    return stored, read


LINE_COPY_CASES = {
    # (row bytes, vector bytes, table rows, ids, rows a range)
    "sixteen_offsets": (2408, 8, 101, list(range(16)), 1),
    "miss_runs": (2408, 8, 101, [3, 4, 5, 6, 7, 8, 9, 10, 11], 1),
    "random_32": (2408, 8, 101, [int(i) for i in np.random.default_rng(5).integers(0, 101, 32)], 1),
    "first_and_last_rows": (2408, 8, 101, [0, 1, 99, 100], 1),
    "span_of_8": (2408, 8, 101, [92], 8),
    "span_of_33": (2408, 8, 101, [0], 33),
    "bf16": (1204, 4, 77, [0, 5, 6, 40, 76], 1),
    "two_byte_vectors": (602, 2, 77, [1, 2, 76], 1),
}


@pytest.mark.parametrize("case", sorted(LINE_COPY_CASES))
def test_line_copy_stores_every_byte_once_from_inside_the_table(case):
    """The warp's line stream (copy_lines' prefix sum, the ballots that
    find each line's range, the pieces' offsets) stores every byte of every
    range once, at its place in the output, reads only inside the table,
    and reads what ``line_plan`` says for each range."""
    row_bytes, vec, n_rows, ids, rows = LINE_COPY_CASES[case]
    lo, hi = _table(n_rows, row_bytes)
    assert lo % PIECE == 0 and hi % PIECE != 0  # every case's table ends off a piece
    mem = np.random.default_rng(len(ids)).integers(0, 256, hi + 4 * LINE, dtype=np.uint8)
    nbytes = rows * row_bytes
    srcs = [lo + i * row_bytes for i in ids]
    dsts = [j * nbytes for j in range(len(ids))]
    out = np.zeros(len(ids) * nbytes, np.uint8)
    stored, read = _copy_lines(mem, out, srcs, dsts, nbytes, lo, hi, vec)
    assert (stored == 1).all()
    want = np.concatenate([mem[a : a + nbytes] for a in srcs])
    np.testing.assert_array_equal(out, want)
    assert min(read) >= lo and max(read) < hi
    planned = [x for a in srcs for p, q in tk.line_plan(a, nbytes, lo, hi)["reads"]
               for x in range(p, q)]
    assert sorted(read) == sorted(planned)


@pytest.mark.parametrize("route", ["sampled", "layerwise"])
@pytest.mark.parametrize("line_launches", [0, 1])
def test_gather_spans_count_the_line_copies(monkeypatch, route, line_launches):
    """The stage span that gathers (``feature`` in the sampled engine,
    ``gather`` layer-wise) carries ``line_copies``: the launches of #2 in
    its item that read by aligned lines.  On the CPU no kernel launches,
    so it is 0; a store whose gather counts one line launch a call (a
    stand-in for the card's Reddit rows) makes it 1 on every item.  No
    other span carries it."""
    import collections

    from repro_torch.core.config import EngineConfig
    from repro_torch.core.trace import Tracer
    from repro_torch.graph.datasets import load_dataset
    from repro_torch.graph.features import FeatureStore
    from repro_torch.runtime.gnn_engine import GNNInferenceEngine
    from repro_torch.runtime.layerwise import run_layerwise

    gather = FeatureStore.gather

    def counted(self, *args, **kwargs):
        tk.cached_gather_blocks.line_launches += line_launches
        return gather(self, *args, **kwargs)

    monkeypatch.setattr(FeatureStore, "gather", counted)
    ds = load_dataset("ogbn-products", scale=0.002, seed=0)
    eng = GNNInferenceEngine(ds, fanouts=(3, 2), batch_size=64, seed=3, device="cpu")
    eng.prepare("dci", total_cache_bytes=100_000, n_presample=2)
    tracer = Tracer()
    if route == "sampled":
        eng.run(config=EngineConfig(pipeline_depth=2, use_kernel=True, dedup=True),
                max_batches=3, tracer=tracer)
        stage = "feature"
    else:
        cfg = EngineConfig(mode="layerwise", chunk_size=256, use_kernel=True)
        run_layerwise(ds, eng.pipeline, list(eng.model.layers), model=eng.model_name,
                      config=cfg.resolved(eng.pipeline, pipeline_depth=2), tracer=tracer)
        stage = "gather"
    by_name = collections.defaultdict(list)
    for e in tracer.events:
        if e["ph"] == "X":
            by_name[e["name"]].append(e.get("args", {}))
    assert len(by_name[stage]) >= 3
    assert [a["line_copies"] for a in by_name[stage]] == [line_launches] * len(by_name[stage])
    for name, args in by_name.items():
        if name != stage:
            assert not any("line_copies" in a for a in args), name
