"""Public op: padded-neighbourhood aggregation (sum/mean).

The GNN layers sample a fixed ``fanout`` per destination node, so the
neighbourhood tensor is dense — aggregation is a segment reduction with a
static segment length.  ``use_kernel=True`` routes through
:func:`~repro_torch.kernels.seg_agg.kernel.seg_agg` (the CUDA kernel on a
CUDA tensor, the plain version on a CPU tensor); ``use_kernel=False``
takes CPU tensors only, which the same wrapper hands to the plain version
(``ref.py``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.seg_agg.kernel import seg_agg

__all__ = ["aggregate_neighbors"]


def aggregate_neighbors(
    nbr_feats: torch.Tensor, *, mode: str = "sum", use_kernel: bool = False
) -> torch.Tensor:
    """Reduce each node's padded neighbourhood to one vector.

    Args:
      nbr_feats: ``[S, fanout, F]`` float32 or bfloat16 — for each of
        ``S`` destination nodes, its ``fanout`` sampled neighbours' rows.
      mode: ``"sum"`` or ``"mean"`` (mean divides by the static fanout —
        sampling is with replacement, so there are no empty slots).
      use_kernel: route through the CUDA kernel wrapper; required for
        CUDA tensors.  On a CPU tensor both settings compute the plain
        version.

    Returns:
      ``[S, F]`` in the input's dtype.
    """
    if not use_kernel and nbr_feats.is_cuda:
        raise ValueError("aggregate_neighbors on a CUDA tensor needs use_kernel=True")
    return seg_agg(nbr_feats, mode=mode)
