"""What a step costs, counted from the ops it dispatches: the dry-run's
counterpart of the reference's HLO analysis.

The reference compiles each step with XLA and parses the optimized HLO
text (``src/repro/analysis/hlo.py``): dot FLOPs and dot bytes, collective
bytes, entry-parameter bytes, with ``while`` trip counts recovered so a
scanned layer stack counts every layer.  Nothing in torch emits HLO, so
that parser has no input here.  Its counterpart runs the step once, on
``"meta"`` tensors (shapes and dtypes, no storage), under a
``TorchDispatchMode`` that sees every aten op the step dispatches,
forward and backward:

* ``flops``: matmul FLOPs as ``torch.utils.flop_counter.FlopCounterMode``
  counts them (``2 * m * n * k`` per product; ``einsum`` and ``matmul``
  reach it as ``mm`` / ``bmm``);
* ``dot_bytes``: the two operands and the result of every ``mm``,
  ``addmm``, ``bmm`` and ``baddbmm``, as ``analyze_hlo`` counts a ``dot``
  (an ``addmm`` addend is not a dot operand);
* ``collective_bytes`` / ``collective_counts``: the collectives the
  program itself records through :func:`record_collective` (the
  tensor- and expert-parallel psums of ``models/lm/tp.py`` and
  ``moe.py``), in the reference's five kinds;
* ``bytes_accessed``: the tensor inputs and outputs of every op that
  moves data (views, ``_unsafe_view`` and ``empty`` excluded), the
  counterpart of XLA's ``bytes accessed``; unlike XLA's it counts no
  fusion, so each elementwise op reads and writes its tensors;
* ``parameter_bytes``: the bytes of the step's inputs;
* ``num_whiles`` / ``unresolved_trip_counts``: always 0, since the port's
  layer loops are Python loops that the count walks through.

The step runs as a Python program, so every op is counted as often as it
runs; there is no loop to recover and no compiler to fuse or elide ops.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.utils.tree import tree_leaves

__all__ = ["StepCounts", "count_step", "record_collective", "COLLECTIVES", "nbytes"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

_aten = torch.ops.aten
# (op, index of the first matrix operand): addmm's and baddbmm's first
# argument is the addend.
_PRODUCTS = {_aten.mm: 0, _aten.bmm: 0, _aten.addmm: 1, _aten.baddbmm: 1}

_NO_DATA = {_aten._unsafe_view, _aten.empty, _aten.empty_like, _aten.empty_strided}

_ACTIVE: list["_Bytes"] = []  # the counters of the steps being counted


@dataclasses.dataclass
class StepCounts:
    """The reference's ``HLOSummary`` fields, for one run of a step."""

    flops: float
    dot_bytes: float
    bytes_accessed: float
    collective_bytes: dict
    collective_counts: dict
    parameter_bytes: int
    num_whiles: int = 0
    unresolved_trip_counts: int = 0


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensor_bytes(tree) -> int:
    return sum(nbytes(t) for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


class _Bytes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.dot_bytes = 0
        self.bytes_accessed = 0
        self.collective_bytes = dict.fromkeys(COLLECTIVES, 0.0)
        self.collective_counts = dict.fromkeys(COLLECTIVES, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        first = _PRODUCTS.get(packet)
        if first is not None:
            self.dot_bytes += nbytes(args[first]) + nbytes(args[first + 1]) + nbytes(out)
        if not func.is_view and packet not in _NO_DATA:
            self.bytes_accessed += (_tensor_bytes(list(args)) + _tensor_bytes(dict(kwargs or {}))
                                    + _tensor_bytes(out if isinstance(out, (tuple, list))
                                                    else [out]))
        return out


def record_collective(kind: str, nbytes_per_device: float) -> None:
    """Record one collective of ``kind`` moving ``nbytes_per_device`` per
    device into every step being counted (nothing when none is)."""
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}; have {COLLECTIVES}")
    for c in _ACTIVE:
        c.collective_bytes[kind] += float(nbytes_per_device)
        c.collective_counts[kind] += 1


def count_step(fn, *args) -> tuple[object, StepCounts]:
    """Run ``fn(*args)`` once under the counters; returns its result and
    the counts.  ``parameter_bytes`` is the bytes of every tensor in
    ``args`` (the step's inputs, as the entry parameters of its HLO)."""
    counted = _Bytes()
    _ACTIVE.append(counted)
    try:
        with FlopCounterMode(display=False) as flops, counted:
            out = fn(*args)
    finally:
        _ACTIVE.remove(counted)
    return out, StepCounts(
        flops=float(flops.get_total_flops()),
        dot_bytes=float(counted.dot_bytes),
        bytes_accessed=float(counted.bytes_accessed),
        collective_bytes=dict(counted.collective_bytes),
        collective_counts=dict(counted.collective_counts),
        parameter_bytes=_tensor_bytes(list(args)),
    )
