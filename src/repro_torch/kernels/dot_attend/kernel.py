"""CUDA kernel for the Graph Transformer's attention over a sampled block
(H100, sm_90a).

The wrapper around ``csrc/dot_attend.cu``, built with ``nvcc`` at first use
and loaded with ``ctypes`` (``kernels/_build.py``).

:func:`dot_attend` replaces no Pallas kernel (the JAX reference has no
Graph Transformer).  For each destination and head it scores the
destination's sampled neighbours' rows by the dot product with the
destination's own query folded through the head's key map, softmaxes the
scores with a running maximum and writes the weighted sum of the layer's
input rows, ``[num_dst, H, F]``; the heads' value maps follow as one batched
matmul (``models/gnn/models.py``).  Its indexed form reads a sampled layer
0's distinct frontier rows through the dedup inverse map, as
``gat_attend`` does, so no tensor of every position's row, key or value is
written.  The source note in the ``.cu`` file says more of the design.

Routing: on a CPU tensor the wrapper computes the plain version
(``ref.py``); on a CUDA tensor it launches the kernel or raises — there is
no fallback.  On a card it takes rows of a multiple of 4 floats, at most
1,024 (the configuration's rows: 100 at a sampled layer 0, 512 after), up
to ``MAX_HEADS`` heads, and copies a tensor whose base is not 16-byte
aligned, so the kernel reads every row in 16-byte vectors.
``dot_attend.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.dot_attend.ref import dot_attend_ref

__all__ = ["MAX_F", "MAX_HEADS", "dot_attend", "load_library"]

MAX_HEADS = 8
MAX_F = 1024  # 8 warps of 32 threads, one 16-byte vector each
_TEAM_WARPS = (1, 2, 4, 8)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its C ABI."""
    from repro_torch.kernels._build import build_library

    path, _ = build_library("dot_attend")
    lib = ctypes.CDLL(str(path))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dci_dot_attend.argtypes = [p, p, p, p, ll, ll, i, ll, i, i, p]
    lib.dci_dot_attend.restype = ctypes.c_int
    return lib


def _team(f: int) -> int:
    """Warps per destination for rows of ``f`` floats (at most ``MAX_F``):
    the fewest that give each of the row's 16-byte vectors a thread."""
    return next(w for w in _TEAM_WARPS if 128 * w >= f)


def dot_attend(
    x: torch.Tensor,
    idx: torch.Tensor | None,
    u: torch.Tensor,
    *,
    num_dst: int,
    fanout: int,
) -> torch.Tensor:
    """Per-head attention-weighted sums of a sampled layer's neighbour rows,
    ``[num_dst, H, F]``, reading ``x`` through ``idx``.

    ``x [R, F]`` holds rows (a frontier's distinct rows, possibly
    pow2-padded: rows no index names are never read); ``idx`` is an int32
    index of ``num_dst * (1 + fanout)`` positions in the ``[self |
    neighbours]`` layout of ``sample_blocks``, or None for the dense form
    (position ``i`` is row ``i``, and ``x`` has exactly that many rows).
    Only the neighbour positions are read.  ``u [num_dst, H, F]`` holds
    each destination's queries folded through the heads' key maps (see
    ``ref.py``).  The kernel adds the slots in order, so the indexed and the
    dense form of the same rows give the same bits.  Indices must lie in
    ``[0, R)``: the plain version raises on one outside, the kernel clamps it
    (reading it back to check would wait for the card)."""
    if x.dim() != 2:
        raise ValueError(f"x must be [R, F], got shape {tuple(x.shape)}")
    if num_dst < 0 or fanout < 1:
        raise ValueError(f"need num_dst >= 0 and fanout >= 1, got {num_dst} and {fanout}")
    f = x.shape[1]
    if u.dim() != 3 or u.shape[0] != num_dst or u.shape[2] != f:
        raise ValueError(f"u must be [{num_dst}, H, {f}], got shape {tuple(u.shape)}")
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
        return dot_attend_ref(x, idx, u, num_dst=num_dst, fanout=fanout)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"dot_attend takes float32, got {x.dtype} and {u.dtype}")
    if u.device != x.device:
        raise ValueError(f"u on {u.device}, x on {x.device}")
    if not 1 <= heads <= MAX_HEADS:
        raise ValueError(f"dot_attend takes 1 to {MAX_HEADS} heads, got {heads}")
    if f % 4 or not 0 < f <= MAX_F:
        raise ValueError(f"dot_attend on a card takes rows of a multiple of 4 floats, at most "
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
    status = load_library().dci_dot_attend(
        x.data_ptr(), None if idx is None else idx.data_ptr(), u.data_ptr(), out.data_ptr(),
        x.shape[0], num_dst, fanout, f, heads, _team(f),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"dci_dot_attend launch failed: CUDA error {status}")
    dot_attend.launches += 1
    return out


dot_attend.launches = 0
