"""CUDA kernel for GraphSAGE-LSTM's recurrence over a sampled block (H100,
sm_90a).

The wrapper around ``csrc/lstm_agg.cu``, built with ``nvcc`` at first use and
loaded with ``ctypes`` (``kernels/_build.py``).

:func:`lstm_agg` replaces no Pallas kernel (the JAX reference has no LSTM
aggregator).  For each destination it runs the LSTM of GraphSAGE's
aggregator over its ``fanout`` sampled neighbours in draw order, from gate
rows ``x W_ih + b`` mapped beforehand by one SGEMM, and writes the last
hidden state ``[num_dst, H]``; the self and neighbour maps follow
(``models/gnn/models.py``).  Its indexed form reads a sampled layer 0's
gate rows, one per distinct frontier row, through the dedup inverse map, as
``gat_attend`` and ``dot_attend`` read theirs, so no tensor of every
position's gate row is written.  ``h`` and ``c`` never leave the chip until
the end.  The source note in the ``.cu`` file says more of the design.

Routing: on a CPU tensor the wrapper computes the plain version
(``ref.py``); on a CUDA tensor it launches the kernel or raises — there is
no fallback.  On a card it takes ``H = CARD_HIDDEN`` (128, GraphSAGE's
"small" LSTM) and fan-outs up to ``MAX_FANOUT``, and copies a tensor whose
base is not 16-byte aligned.  ``lstm_agg.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.lstm_agg.ref import lstm_agg_ref

__all__ = ["CARD_HIDDEN", "MAX_FANOUT", "load_library", "lstm_agg"]

CARD_HIDDEN = 128
MAX_FANOUT = 64


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its C ABI."""
    from repro_torch.kernels._build import build_library

    path, _ = build_library("lstm_agg")
    lib = ctypes.CDLL(str(path))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dci_lstm_agg.argtypes = [p, p, p, p, ll, ll, i, p]
    lib.dci_lstm_agg.restype = ctypes.c_int
    return lib


def lstm_agg(
    g: torch.Tensor,
    idx: torch.Tensor | None,
    w_hh: torch.Tensor,
    *,
    num_dst: int,
    fanout: int,
) -> torch.Tensor:
    """Each destination's last LSTM hidden state over its neighbour slots,
    ``[num_dst, H]``, reading the gate rows ``g [R, 4H]`` through ``idx``.

    ``idx`` is an int32 index of ``num_dst * (1 + fanout)`` positions in the
    ``[self | neighbours]`` layout of ``sample_blocks`` (only the neighbour
    positions are read: rows no index names are never read), or None for
    the dense form, where ``g`` holds the ``num_dst * fanout`` neighbour
    rows in slot order.  ``w_hh [H, 4H]``; the gates and the cell are
    ``ref.py``'s.  The kernel takes the steps in slot order and each sum in
    order of ``k``, so every run gives the same bits.  Indices must lie in
    ``[0, R)``: the plain version raises on one outside, the kernel clamps
    it (reading it back to check would wait for the card)."""
    if g.dim() != 2 or w_hh.dim() != 2:
        raise ValueError(f"g and w_hh must be 2-D, got {tuple(g.shape)} and {tuple(w_hh.shape)}")
    hidden = w_hh.shape[0]
    if w_hh.shape[1] != 4 * hidden or g.shape[1] != 4 * hidden:
        raise ValueError(f"w_hh must be [H, 4H] and g [R, 4H], got {tuple(w_hh.shape)} and "
                         f"{tuple(g.shape)}")
    if num_dst < 0 or fanout < 1:
        raise ValueError(f"need num_dst >= 0 and fanout >= 1, got {num_dst} and {fanout}")
    if idx is None:
        if g.shape[0] != num_dst * fanout:
            raise ValueError(f"the dense form needs {num_dst * fanout} rows, got {g.shape[0]}")
    else:
        positions = num_dst * (1 + fanout)
        if idx.dtype != torch.int32:
            raise ValueError(f"idx must be int32, got {idx.dtype}")
        if idx.shape != (positions,):
            raise ValueError(f"idx must be [{positions}], got shape {tuple(idx.shape)}")
        if idx.device != g.device:
            raise ValueError(f"idx on {idx.device}, g on {g.device}")
    if g.device.type == "cpu":
        return lstm_agg_ref(g, idx, w_hh, num_dst=num_dst, fanout=fanout)
    if not g.is_cuda:
        raise ValueError(f"unsupported device {g.device}")
    if g.dtype != torch.float32 or w_hh.dtype != torch.float32:
        raise ValueError(f"lstm_agg takes float32, got {g.dtype} and {w_hh.dtype}")
    if w_hh.device != g.device:
        raise ValueError(f"w_hh on {w_hh.device}, g on {g.device}")
    if hidden != CARD_HIDDEN:
        raise ValueError(f"lstm_agg on a card takes H = {CARD_HIDDEN}, got {hidden}")
    if fanout > MAX_FANOUT:
        raise ValueError(f"lstm_agg on a card takes fan-outs up to {MAX_FANOUT}, got {fanout}")
    if num_dst > 0 and not 0 < g.shape[0] < 2**31:
        raise ValueError(f"g must have 1 to 2**31 - 1 rows, got {g.shape[0]}")
    out = torch.empty((num_dst, hidden), dtype=g.dtype, device=g.device)
    if num_dst == 0:  # no destination; skip the launch
        return out
    # A base past a 16-byte boundary (an offset view) is copied to a fresh one.
    g, w_hh = (t.contiguous() if t.data_ptr() % 16 == 0
               else t.clone(memory_format=torch.contiguous_format) for t in (g, w_hh))
    idx = None if idx is None else idx.contiguous()
    status = load_library().dci_lstm_agg(
        g.data_ptr(), None if idx is None else idx.data_ptr(), w_hh.data_ptr(), out.data_ptr(),
        g.shape[0], num_dst, fanout, torch.cuda.current_stream(g.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"dci_lstm_agg launch failed: CUDA error {status}")
    lstm_agg.launches += 1
    return out


lstm_agg.launches = 0
