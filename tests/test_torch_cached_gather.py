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


@pytest.mark.parametrize("gather_buffers", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["db", "blocks"])
def test_gather_buffer_counts_do_not_change_output(kind, gather_buffers):
    port, ref = _both(kind, *_case(8, 64, 160, 33), gather_buffers=gather_buffers)
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("kind", ["db", "blocks"])
def test_gather_rejects_bad_buffers(kind):
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        PORT[kind](torch.zeros(1, 8), torch.zeros(2, 8), z, z, gather_buffers=0)


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
