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
  :func:`cached_gather_select`  ``cached_gather_select`` — reads both
                                candidate rows and selects (the baseline)

All three return ``out[i] = hot[pos[i]]`` when ``pos[i] >= 0`` (the raw
position) and ``host[idx[i]]`` otherwise, with ids and slots clamped into
their tables as the reference clamps them.  What bounds them is bytes: hit
rows over device memory, miss rows over PCIe when the host table is pinned
host memory (read in place over UVA), and the output written once; the
source note in the ``.cu`` file says what the simple design does about it.

Routing: on CPU tensors a wrapper computes the plain version
(``ref.py``); with the hot table on a CUDA device it launches its kernel
or raises — there is no fallback.  The host operand is then a CUDA tensor
on the same device or a pinned CPU tensor (pageable memory would fault).
Each wrapper counts its launches in a plain integer attribute,
``<wrapper>.launches``, bumped only where the kernel is launched.

``gather_buffers`` was the TPU kernels' VMEM-slot count; it has no
counterpart here and stays a validated argument that does not change the
output.
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
    "load_library",
]

ROW_BLOCK = 8  # default rows per block in the row-block variant


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its C ABI."""
    from repro_torch.kernels._build import build_library

    path, _ = build_library("cached_gather")
    lib = ctypes.CDLL(str(path))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dci_cached_gather.argtypes = [p, p, p, p, p, ll, ll, ll, ll, i, p]
    lib.dci_cached_gather_select.argtypes = [p, p, p, p, p, ll, ll, ll, ll, i, p]
    lib.dci_cached_gather_blocks.argtypes = [p, p, p, p, p, p, p, ll, ll, ll, ll, ll, i, p]
    lib.dci_host_device_pointer.argtypes = [p, ctypes.POINTER(ctypes.c_void_p)]
    for fn in (
        lib.dci_cached_gather,
        lib.dci_cached_gather_select,
        lib.dci_cached_gather_blocks,
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
    of a CUDA tensor, or the UVA device address of pinned host memory."""
    if host.is_cuda:
        return host.data_ptr()
    dev = ctypes.c_void_p()
    _check_status(
        load_library().dci_host_device_pointer(host.data_ptr(), ctypes.byref(dev)),
        "cudaHostGetDevicePointer",
    )
    return dev.value


def _vec_bytes(row_bytes: int, *ptrs: int) -> int:
    """Widest copy vector (16/8/4/2/1 bytes) dividing the row pitch and
    every base address."""
    g = math.gcd(row_bytes, *ptrs)
    return next(v for v in (16, 8, 4, 2, 1) if g % v == 0)


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
    *,
    gather_buffers: int = 2,
) -> torch.Tensor:
    """Two-source gather, one warp per row copying its winning source."""
    _validate(hot_table, host_table, indices, positions)
    if gather_buffers < 1:
        raise ValueError(f"gather_buffers must be >= 1, got {gather_buffers}")
    if not _on_cuda(hot_table, host_table, indices, positions):
        return cached_gather_ref(hot_table, host_table, indices, positions)
    if indices.shape[0] == 0:  # nothing to gather; skip the launch
        return hot_table.new_empty((0, hot_table.shape[1]))
    idx, pos, out, row_bytes, host_ptr, vec, stream = _launch_args(
        hot_table, host_table, indices, positions
    )
    status = load_library().dci_cached_gather(
        hot_table.data_ptr(), host_ptr, idx.data_ptr(), pos.data_ptr(), out.data_ptr(),
        idx.shape[0], row_bytes, hot_table.shape[0], host_table.shape[0], vec, stream,
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
    """Two-source gather that reads BOTH candidate rows and selects — the
    port of the reference's select kernel, and the baseline the other two
    are timed against."""
    _validate(hot_table, host_table, indices, positions)
    if not _on_cuda(hot_table, host_table, indices, positions):
        return cached_gather_ref(hot_table, host_table, indices, positions)
    if indices.shape[0] == 0:
        return hot_table.new_empty((0, hot_table.shape[1]))
    idx, pos, out, row_bytes, host_ptr, vec, stream = _launch_args(
        hot_table, host_table, indices, positions
    )
    status = load_library().dci_cached_gather_select(
        hot_table.data_ptr(), host_ptr, idx.data_ptr(), pos.data_ptr(), out.data_ptr(),
        idx.shape[0], row_bytes, hot_table.shape[0], host_table.shape[0], vec, stream,
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
    """``(blk_mode, blk_start)``, ``int32[ceil(S / row_block)]`` each.

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


def cached_gather_blocks(
    hot_table: torch.Tensor,
    host_table: torch.Tensor,
    indices: torch.Tensor,
    positions: torch.Tensor,
    *,
    row_block: int = ROW_BLOCK,
    gather_buffers: int = 2,
) -> torch.Tensor:
    """Row-block two-source gather for sorted-run frontiers.

    Identical output to :func:`cached_gather` for ANY index order — blocks
    that are not one contiguous single-source run are copied row by row —
    but a deduped (sorted unique) frontier, whose hit slots and miss ids
    run consecutively, collapses most blocks to one contiguous span copy.
    ``row_block == 1`` routes to :func:`cached_gather`, as the reference
    does."""
    _validate(hot_table, host_table, indices, positions)
    if gather_buffers < 1:
        raise ValueError(f"gather_buffers must be >= 1, got {gather_buffers}")
    if row_block < 1:
        raise ValueError(f"row_block must be >= 1, got {row_block}")
    if not _on_cuda(hot_table, host_table, indices, positions):
        return cached_gather_ref(hot_table, host_table, indices, positions)
    if indices.shape[0] == 0:
        return hot_table.new_empty((0, hot_table.shape[1]))
    if row_block == 1:
        return cached_gather(
            hot_table, host_table, indices, positions, gather_buffers=gather_buffers
        )
    idx, pos, out, row_bytes, host_ptr, vec, stream = _launch_args(
        hot_table, host_table, indices, positions
    )
    mode, start = classify_blocks(idx, pos, hot_table.shape[0], host_table.shape[0], row_block)
    status = load_library().dci_cached_gather_blocks(
        hot_table.data_ptr(), host_ptr, idx.data_ptr(), pos.data_ptr(), mode.data_ptr(),
        start.data_ptr(), out.data_ptr(), idx.shape[0], row_bytes, hot_table.shape[0],
        host_table.shape[0], row_block, vec, stream,
    )
    _check_status(status, "dci_cached_gather_blocks launch")
    cached_gather_blocks.launches += 1
    return out


cached_gather_blocks.launches = 0
