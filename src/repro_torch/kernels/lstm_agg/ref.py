"""Plain-torch version of GraphSAGE-LSTM's recurrence over a sampled block.

The CPU route of :func:`~repro_torch.kernels.lstm_agg.kernel.lstm_agg` and the
oracle the CUDA kernel is held to.
"""

from __future__ import annotations

import torch

__all__ = ["FORGET_BIAS", "lstm_agg_ref", "lstm_cell"]

FORGET_BIAS = 1.0  # TF's BasicLSTMCell adds it to the forget gate's input


def lstm_agg_ref(
    g: torch.Tensor,
    idx: torch.Tensor | None,
    w_hh: torch.Tensor,
    *,
    num_dst: int,
    fanout: int,
) -> torch.Tensor:
    """The last hidden state of an LSTM run over each destination's
    ``fanout`` neighbour slots in draw order, ``[num_dst, H]``.

    ``g`` holds gate rows ``x W_ih + b`` (``4H`` wide): read through ``idx``
    (int32, the ``[self | neighbours]`` layout of ``sample_blocks``, slot
    ``t`` of destination ``d`` at position ``num_dst + d * fanout + t``; the
    self positions are not read), or, where ``idx`` is None, ``g`` holds the
    ``num_dst * fanout`` neighbour rows themselves in slot order.  ``w_hh
    [H, 4H]`` maps the previous hidden state.  From ``h = c = 0``, a step
    splits ``z = g_t + h w_hh`` into the gates ``(i, j, f, o)`` in TF's
    ``BasicLSTMCell`` order: ``c = sigmoid(f + 1) c + sigmoid(i) tanh(j)``,
    ``h = sigmoid(o) tanh(c)``.  The first step adds no product: its
    ``h`` is 0."""
    seq = g if idx is None else g[idx[num_dst:].to(torch.int64)]
    seq = seq.reshape(num_dst, fanout, g.shape[1])
    h, c = lstm_cell(seq[:, 0], None)
    for t in range(1, fanout):
        h, c = lstm_cell(torch.addmm(seq[:, t], h, w_hh), c)
    return h


def lstm_cell(z: torch.Tensor, c: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of the cell from the gate sums ``z [rows, 4H]`` and the
    previous cell state ``c`` (None: 0, the first step): ``(h, c)``."""
    i, j, f, o = z.chunk(4, dim=1)
    ij = torch.sigmoid(i) * torch.tanh(j)
    c = ij if c is None else torch.sigmoid(f + FORGET_BIAS) * c + ij
    return torch.sigmoid(o) * torch.tanh(c), c
