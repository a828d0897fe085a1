"""Plain-torch version of GAT's attention over a sampled block.

The CPU route of :func:`~repro_torch.kernels.gat_attend.kernel.gat_attend`
and the oracle the CUDA kernel is held to.
"""

from __future__ import annotations

import torch

__all__ = ["gat_attend_ref"]


def gat_attend_ref(
    x: torch.Tensor,
    idx: torch.Tensor | None,
    u: torch.Tensor,
    *,
    num_dst: int,
    fanout: int,
    negative_slope: float,
) -> torch.Tensor:
    """Each destination's per-head softmax-weighted sum of its own row and
    its ``fanout`` neighbours' rows of ``x[idx]``, ``[num_dst, H, F]``.

    ``x[idx]`` (``x`` itself when ``idx`` is None) has the ``[self |
    neighbours]`` layout of ``sample_blocks``.  ``u [2, H, F]`` holds the
    score vectors folded through each head's map, the source half ``u[0]``
    and the destination half ``u[1]``: head ``k``'s score of row ``j`` for
    destination ``i`` is ``LeakyReLU(x_i . u[1, k] + x_j . u[0, k])``,
    softmaxed over the ``1 + fanout`` rows (self first).  That is GAT's
    ``LeakyReLU(a_k^T [W_k x_i || W_k x_j])`` with ``u[., k] = W_k a_k``."""
    h = x if idx is None else x[idx.to(torch.int64)]
    f = h.shape[-1]
    self_h = h[:num_dst]
    rows = torch.cat([self_h[:, None], h[num_dst:].reshape(num_dst, fanout, f)], dim=1)
    scores = (self_h @ u[1].T)[:, None, :] + rows @ u[0].T  # [num_dst, 1 + fanout, H]
    alpha = torch.softmax(torch.nn.functional.leaky_relu(scores, negative_slope), dim=1)
    return torch.einsum("nsh,nsf->nhf", alpha, rows)
