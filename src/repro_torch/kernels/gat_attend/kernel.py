"""CUDA kernel for GAT's attention over a sampled block (H100, sm_90a).

The wrapper around ``csrc/gat_attend.cu``, built with ``nvcc`` at first use
and loaded with ``ctypes`` (``kernels/_build.py``).

:func:`gat_attend` replaces no Pallas kernel (the JAX reference has no
GAT).  For each destination and head it scores the destination's own row
and its sampled neighbours' rows from the score vectors folded through the
head's map, softmaxes the scores with a running maximum and writes the
weighted sum of the layer's input rows, ``[num_dst, H, F]``; the layer's
projection follows as one batched matmul (``models/gnn/models.py``).  Its
indexed form reads a sampled layer 0's distinct frontier rows through the
dedup inverse map, as ``seg_agg_indexed`` does, so no tensor of every
position's row, nor of every position's projection, is written.  The
source note in the ``.cu`` file says more of the design.

Routing: on a CPU tensor the wrapper computes the plain version
(``ref.py``); on a CUDA tensor it launches the kernel or raises — there is
no fallback.  On a card it takes rows of a multiple of 4 floats, at most
1,024 (every row the configurations have: 100 at a sampled layer 0, 1,024
after), and copies a tensor whose base is not 16-byte aligned, so the kernel
reads every row in 16-byte vectors.  ``gat_attend.launches`` counts the
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.gat_attend.ref import gat_attend_ref

__all__ = ["MAX_F", "MAX_HEADS", "gat_attend", "load_library"]

MAX_HEADS = 8
MAX_F = 1024  # 8 warps of 32 threads, one 16-byte vector each
_TEAM_WARPS = (1, 2, 4, 8)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its C ABI."""
    from repro_torch.kernels._build import build_library

    path, _ = build_library("gat_attend")
    lib = ctypes.CDLL(str(path))
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.dci_gat_attend.argtypes = [p, p, p, p, ll, ll, i, ll, i, f, i, p]
    lib.dci_gat_attend.restype = ctypes.c_int
    return lib


def _team(f: int) -> int:
    """Warps per destination for rows of ``f`` floats (at most ``MAX_F``):
    the fewest that give each of the row's 16-byte vectors a thread."""
    return next(w for w in _TEAM_WARPS if 128 * w >= f)


def gat_attend(
    x: torch.Tensor,
    idx: torch.Tensor | None,
    u: torch.Tensor,
    *,
    num_dst: int,
    fanout: int,
    negative_slope: float,
) -> torch.Tensor:
    """Per-head attention-weighted sums of a sampled layer's input rows,
    ``[num_dst, H, F]``, reading ``x`` through ``idx``.

    ``x [R, F]`` holds rows (a frontier's distinct rows, possibly
    pow2-padded: rows no index names are never read); ``idx`` is an int32
    index of ``num_dst * (1 + fanout)`` positions in the ``[self |
    neighbours]`` layout of ``sample_blocks``, or None for the dense form
    (position ``i`` is row ``i``, and ``x`` has exactly that many rows).
    ``u [2, H, F]`` holds the score vectors folded through each head's map,
    source half first (see ``ref.py``).  The kernel adds the slots in
    order, so the indexed and the dense form of the same rows give the same
    bits.  Indices must lie in ``[0, R)``: the plain version raises on one
    outside, the kernel clamps it (reading it back to check would wait for
    the card)."""
    if x.dim() != 2:
        raise ValueError(f"x must be [R, F], got shape {tuple(x.shape)}")
    if num_dst < 0 or fanout < 1:
        raise ValueError(f"need num_dst >= 0 and fanout >= 1, got {num_dst} and {fanout}")
    f = x.shape[1]
    if u.dim() != 3 or u.shape[0] != 2 or u.shape[2] != f:
        raise ValueError(f"u must be [2, H, {f}], got shape {tuple(u.shape)}")
    heads = u.shape[1]
    positions = num_dst * (1 + fanout)
    if idx is None:
        if x.shape[0] != positions:
            raise ValueError(f"the dense form needs {positions} rows, got {x.shape[0]}")
    else:
        if idx.dtype != torch.int32:
            raise ValueError(f"idx must be int32, got {idx.dtype}")
        if idx.shape != (positions,):
            raise ValueError(f"idx must be [{positions}], got shape {tuple(idx.shape)}")
        if idx.device != x.device:
            raise ValueError(f"idx on {idx.device}, x on {x.device}")
    if x.device.type == "cpu":
        return gat_attend_ref(x, idx, u, num_dst=num_dst, fanout=fanout,
                              negative_slope=negative_slope)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"gat_attend takes float32, got {x.dtype} and {u.dtype}")
    if u.device != x.device:
        raise ValueError(f"u on {u.device}, x on {x.device}")
    if not 1 <= heads <= MAX_HEADS:
        raise ValueError(f"gat_attend takes 1 to {MAX_HEADS} heads, got {heads}")
    if f % 4 or not 0 < f <= MAX_F:
        raise ValueError(f"gat_attend on a card takes rows of a multiple of 4 floats, at most "
                         f"{MAX_F}, got {f}")
    if num_dst > 0 and x.shape[0] == 0:
        raise ValueError("x has no rows for idx to name")
    # A base past a 16-byte boundary (an offset view) is copied to a fresh one.
    x, u = (t.contiguous() if t.data_ptr() % 16 == 0
            else t.clone(memory_format=torch.contiguous_format) for t in (x, u))
    idx = None if idx is None else idx.contiguous()
    out = torch.empty((num_dst, heads, f), dtype=x.dtype, device=x.device)
    if num_dst == 0:  # nothing to attend; skip the launch
        return out
    status = load_library().dci_gat_attend(
        x.data_ptr(), None if idx is None else idx.data_ptr(), u.data_ptr(), out.data_ptr(),
        x.shape[0], num_dst, fanout, f, heads, float(negative_slope), _team(f),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"dci_gat_attend launch failed: CUDA error {status}")
    gat_attend.launches += 1
    return out


gat_attend.launches = 0
