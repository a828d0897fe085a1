"""Plain-torch version of the Graph Transformer's attention over a sampled
block.

The CPU route of :func:`~repro_torch.kernels.dot_attend.kernel.dot_attend`
and the oracle the CUDA kernel is held to.
"""

from __future__ import annotations

import torch

__all__ = ["dot_attend_ref"]


def dot_attend_ref(
    x: torch.Tensor,
    idx: torch.Tensor | None,
    u: torch.Tensor,
    *,
    num_dst: int,
    fanout: int,
) -> torch.Tensor:
    """Each destination's per-head softmax-weighted sum of its ``fanout``
    neighbours' rows of ``x[idx]``, ``[num_dst, H, F]``.

    ``x[idx]`` (``x`` itself when ``idx`` is None) has the ``[self |
    neighbours]`` layout of ``sample_blocks``; the self slots are not read.
    ``u [num_dst, H, F]`` holds each destination's queries folded through
    the heads' key maps: head ``k``'s score of neighbour row ``x_j`` for
    destination ``i`` is ``u[i, k] . x_j``, softmaxed over the ``fanout``
    neighbour slots.  That is the Graph Transformer's ``q_i^k . k_j^k /
    sqrt(D)`` with ``u[i, k] = W_k^k q_i^k / sqrt(D)``; the key bias adds the
    same to every slot of a destination, so the softmax cancels it."""
    f = x.shape[-1]
    nbr = x[num_dst:] if idx is None else x[idx[num_dst:].to(torch.int64)]
    nbr = nbr.reshape(num_dst, fanout, f)
    alpha = torch.softmax(torch.bmm(nbr, u.transpose(1, 2)), dim=1)  # [num_dst, fanout, H]
    return torch.bmm(alpha.transpose(1, 2), nbr)
