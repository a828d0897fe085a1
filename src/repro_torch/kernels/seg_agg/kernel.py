"""CUDA kernels for GNN neighbourhood aggregation (H100, sm_90a).

The wrappers around ``csrc/seg_agg.cu``, built with ``nvcc`` at first use
and loaded with ``ctypes`` (``kernels/_build.py``).

- :func:`seg_agg` replaces the Pallas TPU kernel ``seg_agg`` of the
  reference's ``src/repro/kernels/seg_agg/kernel.py``: ``[S, fanout, F] ->
  [S, F]``, the sum or the mean over the fanout axis, in float32 or
  bfloat16, the output in the input's type.  What bounds it is bytes (each
  input element is read once, with one add).
- :func:`seg_agg_indexed` replaces no Pallas kernel.  It fuses the
  reference's ``input_feats[inverse_index]``
  (``src/repro/models/gnn/models.py:79``) with that aggregation: a sampled
  GNN's first layer reads the deepest frontier's distinct rows through the
  inverse map, so the tensor of every duplicate row is never written.
  Bytes bound it too, read as random rows: one warp per destination
  shares the row's indices by shuffles, and the fanout loop is unrolled
  so that a chunk's row loads are all in flight at once.

The source note in the ``.cu`` file says more of each design.

Routing: on a CPU tensor a wrapper computes the plain version
(``ref.py``); on a CUDA tensor it launches the kernel or raises — there is
no fallback.  ``seg_agg.launches`` and ``seg_agg_indexed.launches`` count
the launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.seg_agg.ref import seg_agg_indexed_ref, seg_agg_ref

__all__ = ["load_library", "seg_agg", "seg_agg_indexed"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its C ABI."""
    from repro_torch.kernels._build import build_library

    path, _ = build_library("seg_agg")
    lib = ctypes.CDLL(str(path))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dci_seg_agg.argtypes = [p, p, ll, i, ll, i, i, i, p]
    lib.dci_seg_agg.restype = ctypes.c_int
    lib.dci_seg_agg_indexed.argtypes = [p, p, p, p, ll, ll, i, ll, i, i, p]
    lib.dci_seg_agg_indexed.restype = ctypes.c_int
    return lib


def seg_agg(nbr_feats: torch.Tensor, *, mode: str = "sum") -> torch.Tensor:
    """Sum or mean of ``nbr_feats [S, fanout, F]`` over the fanout axis."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"unknown mode {mode!r}")
    if nbr_feats.dim() != 3:
        raise ValueError(f"nbr_feats must be [S, fanout, F], got shape {tuple(nbr_feats.shape)}")
    if nbr_feats.device.type == "cpu":
        return seg_agg_ref(nbr_feats, mode=mode)
    if not nbr_feats.is_cuda:
        raise ValueError(f"unsupported device {nbr_feats.device}")
    if nbr_feats.dtype not in _DTYPES:
        raise ValueError(f"seg_agg takes float32 or bfloat16, got {nbr_feats.dtype}")
    s, fanout, f = nbr_feats.shape
    if fanout < 1 or f < 1:
        raise ValueError(f"fanout and F must be >= 1, got {fanout} and {f}")
    x = nbr_feats.contiguous()
    out = torch.empty((s, f), dtype=x.dtype, device=x.device)
    if s == 0:  # nothing to reduce; skip the launch
        return out
    es = x.element_size()
    g = math.gcd(f * es, x.data_ptr(), out.data_ptr(), 16)
    vec = next(v for v in (16, 8, 4, 2) if g % v == 0 and v >= es)
    status = load_library().dci_seg_agg(
        x.data_ptr(), out.data_ptr(), s, fanout, f, _DTYPES[x.dtype], vec,
        int(mode == "mean"), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"dci_seg_agg launch failed: CUDA error {status}")
    seg_agg.launches += 1
    return out


seg_agg.launches = 0


def seg_agg_indexed(
    x: torch.Tensor,
    idx: torch.Tensor | None,
    *,
    num_dst: int,
    fanout: int,
    mode: str,
) -> tuple[torch.Tensor, torch.Tensor] | torch.Tensor:
    """A sampled layer's self-and-fanout aggregation, reading ``x`` through
    ``idx``.

    ``x [R, F]`` holds rows (a frontier's distinct rows, possibly
    pow2-padded: rows no index names are never read); ``idx`` is an int32
    index of ``num_dst * (1 + fanout)`` positions in the ``[self |
    neighbours]`` layout of ``sample_blocks``, or None for the dense form
    (position ``i`` is row ``i``, and ``x`` has exactly that many rows).
    ``mode="sage"`` returns ``(self rows, neighbour sums)``, each ``[num_dst,
    F]`` (in the dense form the self rows are a view of ``x``'s first
    rows); ``mode="gcn"`` returns ``(self + sum) / (fanout + 1)``.  Sums are
    fp32 from zero in ascending slot order.  Indices must lie in ``[0,
    R)``: the plain version raises on one outside, the kernel clamps it
    (reading it back to check would wait for the card)."""
    if mode not in ("sage", "gcn"):
        raise ValueError(f"unknown mode {mode!r}")
    if x.dim() != 2:
        raise ValueError(f"x must be [R, F], got shape {tuple(x.shape)}")
    if num_dst < 0 or fanout < 1:
        raise ValueError(f"need num_dst >= 0 and fanout >= 1, got {num_dst} and {fanout}")
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
        return seg_agg_indexed_ref(x, idx, num_dst=num_dst, fanout=fanout, mode=mode)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"seg_agg_indexed takes float32, got {x.dtype}")
    f = x.shape[1]
    if num_dst > 0 and x.shape[0] == 0:
        raise ValueError("x has no rows for idx to name")
    x = x.contiguous()
    idx = None if idx is None else idx.contiguous()
    agg_out = torch.empty((num_dst, f), dtype=x.dtype, device=x.device)
    self_out = written = None  # written: the self rows the kernel stores
    if mode == "sage":
        # The dense form's self rows are x's first rows: a view, not a copy.
        if idx is None:
            self_out = x[:num_dst]
        else:
            self_out = written = torch.empty((num_dst, f), dtype=x.dtype, device=x.device)
    result = (self_out, agg_out) if mode == "sage" else agg_out
    if num_dst == 0 or f == 0:  # nothing to reduce; skip the launch
        return result
    outs = [t.data_ptr() for t in (written, agg_out) if t is not None]
    g = math.gcd(f * x.element_size(), x.data_ptr(), *outs, 16)
    vec = next(v for v in (16, 8, 4) if g % v == 0)
    status = load_library().dci_seg_agg_indexed(
        x.data_ptr(), None if idx is None else idx.data_ptr(),
        None if written is None else written.data_ptr(), agg_out.data_ptr(),
        x.shape[0], num_dst, fanout, f, vec, int(mode == "gcn"),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"dci_seg_agg_indexed launch failed: CUDA error {status}")
    seg_agg_indexed.launches += 1
    return result


seg_agg_indexed.launches = 0
