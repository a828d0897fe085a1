"""CUDA kernel for GNN neighbourhood aggregation (H100, sm_90a).

The wrapper around ``csrc/seg_agg.cu``, built with ``nvcc`` at first use
and loaded with ``ctypes`` (``kernels/_build.py``).  It replaces the
Pallas TPU kernel ``seg_agg`` of the reference's
``src/repro/kernels/seg_agg/kernel.py``: ``[S, fanout, F] -> [S, F]``, the
sum or the mean over the fanout axis, in float32 or bfloat16, the output
in the input's type.  What bounds it is bytes (each input element is read
once, with one add); the source note in the ``.cu`` file says what the
design does about it.

Routing: on a CPU tensor the wrapper computes the plain version
(``ref.py``); on a CUDA tensor it launches the kernel or raises — there is
no fallback.  ``seg_agg.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.seg_agg.ref import seg_agg_ref

__all__ = ["load_library", "seg_agg"]

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
