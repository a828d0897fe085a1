"""CUDA kernel for one layer of neighbour sampling (H100, sm_90a).

The wrapper around ``csrc/sample_layer.cu``, built with ``nvcc`` at first
use and loaded with ``ctypes`` (``kernels/_build.py``).

:func:`sample_layer` replaces no Pallas kernel (the JAX reference samples
in plain jnp ops, which XLA fuses).  For every draw of a layer it turns
the uniform ``u`` into a slot (or takes the slot ``r``), applies DCI's
hit test, reads only the winning neighbour list, applies the isolated-node
rule, writes the neighbour into the frontier buffer's tail, the hit flag
and the unclamped edge slot, and adds the layer's hits to a device total:
one launch where the eager chain took some 36, and no concatenation after
it.  The source note in the ``.cu`` file says more of the design.

Routing: on CPU tensors the wrapper computes the plain version
(``ref.py``); on CUDA tensors it launches the kernel or raises — there is
no fallback.  What the kernel reads is chosen by the draws' type: float64
uniforms or int32 slots.  ``sample_layer.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.sample_layer.ref import sample_layer_ref

__all__ = ["load_library", "sample_layer"]

_GRAPH_FIELDS = ("col_ptr", "row_index", "cache_ptr", "cache_row_index", "cached_len")


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its C ABI."""
    from repro_torch.kernels._build import build_library

    path, _ = build_library("sample_layer")
    lib = ctypes.CDLL(str(path))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dci_sample_layer.argtypes = [p, ll, p, ll, p, p, ll, p, p, ll, i, p, p, p, p, p, p, p]
    lib.dci_sample_layer.restype = ctypes.c_int
    return lib


def _check(graph, seeds, draws, nbr, hit_count) -> None:
    device = seeds.device
    for name in _GRAPH_FIELDS:
        t = getattr(graph, name)
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"graph.{name} must be a contiguous 1-D int32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"graph.{name} on {t.device}, seeds on {device}")
    if seeds.dtype != torch.int32 or seeds.dim() != 1:
        raise ValueError(f"seeds must be a 1-D int32 tensor, got {seeds.dtype} "
                         f"{tuple(seeds.shape)}")
    if draws.dtype not in (torch.float64, torch.int32):
        raise ValueError(f"draws must be float64 uniforms or int32 slots, got {draws.dtype}")
    if draws.dim() != 2 or draws.shape[0] != seeds.shape[0] or draws.shape[1] < 1:
        raise ValueError(f"draws must be [{seeds.shape[0]}, fanout >= 1], got shape "
                         f"{tuple(draws.shape)}")
    if nbr.dtype != torch.int32 or nbr.shape != (draws.numel(),):
        raise ValueError(f"nbr must be int32 [{draws.numel()}], got {nbr.dtype} "
                         f"{tuple(nbr.shape)}")
    if not nbr.is_contiguous():
        raise ValueError("nbr must be contiguous (a slice of the frontier buffer)")
    if hit_count.dtype != torch.int64 or hit_count.shape != ():
        raise ValueError(f"hit_count must be an int64 scalar, got {hit_count.dtype} "
                         f"{tuple(hit_count.shape)}")
    for name, t in (("draws", draws), ("nbr", nbr), ("hit_count", hit_count)):
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, seeds on {device}")


def sample_layer(
    graph,
    seeds: torch.Tensor,
    draws: torch.Tensor,
    nbr: torch.Tensor,
    hit_count: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample one layer: ``fanout`` in-neighbours of each of ``seeds``.

    ``graph`` is a :class:`~repro_torch.graph.sampling.DeviceGraph` (its
    five int32 tensors); ``seeds`` int32 ``[S]``; ``draws`` ``[S, fanout]``,
    float64 uniforms in ``[0, 1)`` or int32 slots in ``[0, max(deg, 1))``.
    The neighbours are written into ``nbr`` (int32 ``[S * fanout]``,
    contiguous, in place) and the layer's hits added to ``hit_count`` (an
    int64 scalar).  Returns ``(hits[S, fanout] bool, edge_slots[S, fanout]
    int32)``, the slots unclamped.  ``nbr`` may be the tail of the buffer
    whose head ``seeds`` is: the two must not overlap.  Seed ids must lie
    in ``[0, N)``: the plain version raises on one outside, the kernel
    clamps its reads (reading it back to check would wait for the card)."""
    _check(graph, seeds, draws, nbr, hit_count)
    if seeds.device.type == "cpu":
        return sample_layer_ref(graph, seeds, draws, nbr, hit_count)
    if not seeds.is_cuda:
        raise ValueError(f"unsupported device {seeds.device}")
    num_nodes = graph.col_ptr.shape[0] - 1
    if num_nodes < 1:
        raise ValueError("the graph has no nodes")
    if graph.cache_row_index.shape[0] < 1:
        raise ValueError("graph.cache_row_index must hold at least one entry")
    num_seeds, fanout = draws.shape
    if not seeds.is_contiguous():
        seeds = seeds.contiguous()
    if not draws.is_contiguous():
        draws = draws.contiguous()
    hit = torch.empty((num_seeds, fanout), dtype=torch.bool, device=seeds.device)
    edge_slots = torch.empty((num_seeds, fanout), dtype=torch.int32, device=seeds.device)
    if num_seeds == 0:  # nothing to sample; skip the launch
        return hit, edge_slots
    u, r = (draws, None) if draws.dtype == torch.float64 else (None, draws)
    status = load_library().dci_sample_layer(
        graph.col_ptr.data_ptr(), num_nodes, graph.row_index.data_ptr(),
        graph.row_index.shape[0], graph.cache_ptr.data_ptr(), graph.cache_row_index.data_ptr(),
        graph.cache_row_index.shape[0], graph.cached_len.data_ptr(), seeds.data_ptr(),
        num_seeds, fanout, None if u is None else u.data_ptr(),
        None if r is None else r.data_ptr(), nbr.data_ptr(), hit.data_ptr(),
        edge_slots.data_ptr(), hit_count.data_ptr(),
        torch.cuda.current_stream(seeds.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"dci_sample_layer launch failed: CUDA error {status}")
    sample_layer.launches += 1
    return hit, edge_slots


sample_layer.launches = 0
