"""Tensor-parallel helpers and the dry-run's switches.

``maybe_row_parallel`` is the row-parallel matmul ``h @ w``.  With a
tensor-parallel mesh set (``set_tp_context``, the dry-run's
``tp_shardmap`` variant) the reference routes it through a ``shard_map``
whose bf16 ``psum`` over the model axis sums the partial products.  Here
the mesh is the abstract one of ``launch/mesh.py`` and the behaviour goes
by the size of its model axis:

* 1: the psum over one device is the identity, and the product runs on
  real tensors on any device;
* more than 1, on ``"meta"`` tensors (the dry-run): the product is
  computed in its global view, and the psum is recorded
  (``analysis.counts.record_collective``) as one ``all-reduce`` of its
  per-device operand, ``[T_local, D]`` in ``h``'s dtype, with T_local the
  tokens of one data shard;
* more than 1, on real tensors: raises, since running tensor parallelism
  takes several cards.

``set_bf16_barrier`` is a flag only: the reference pins the psum to bf16
with ``lax.optimization_barrier`` so XLA cannot sink a norm's fp32 upcast
below it; torch has no compiler to reorder the cast, so ``maybe_barrier``
is the identity.  ``set_remat_policy("dots")`` (variant ``remat_dots``)
saves the products' outputs under each repeat's checkpoint
(``checkpoint_kwargs``).  ``set_rwkv_chunked(True)`` routes RWKV-6
prefill to the chunked WKV6 (``blocks.block_prefill``).
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from repro_torch.analysis.counts import nbytes, record_collective

__all__ = [
    "set_tp_context",
    "maybe_row_parallel",
    "set_bf16_barrier",
    "maybe_barrier",
    "set_remat_policy",
    "remat_policy",
    "checkpoint_kwargs",
    "set_rwkv_chunked",
    "rwkv_chunked",
    "model_axis_psum",
]

_TP_CTX: tuple | None = None  # (mesh, model_axis)
_BF16_BARRIER = False
_REMAT_POLICY: str | None = None
_RWKV_CHUNKED = False
_REMAT_POLICIES = (None, "dots")


def set_remat_policy(name: str | None) -> None:
    """Variant ``remat_dots``: under each repeat's checkpoint, keep the
    outputs of the products with no batch dims and recompute the rest."""
    if name not in _REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {name!r}; have {_REMAT_POLICIES}")
    global _REMAT_POLICY
    _REMAT_POLICY = name


def remat_policy() -> str | None:
    return _REMAT_POLICY


# ``aten.mm`` and ``aten.addmm`` are the products with no batch dims (every
# ``x @ w`` of an activation by a weight); ``bmm`` (attention scores, the
# MoE experts) has one and is recomputed, as under the reference's
# ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``.
_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED else CheckpointPolicy.PREFER_RECOMPUTE


def checkpoint_kwargs() -> dict:
    """Extra arguments of ``torch.utils.checkpoint.checkpoint`` for the
    remat policy set: none for whole-repeat remat; for ``"dots"`` a
    selective-checkpoint context that saves every ``mm`` / ``addmm``
    output."""
    if _REMAT_POLICY == "dots":
        return {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                                _dots_policy)}
    return {}


def set_rwkv_chunked(on: bool) -> None:
    """Select the chunked WKV6 prefill instead of the per-token scan."""
    global _RWKV_CHUNKED
    _RWKV_CHUNKED = bool(on)


def rwkv_chunked() -> bool:
    return _RWKV_CHUNKED


def set_bf16_barrier(on: bool) -> None:
    """Variant ``bf16_psum``: a flag; :func:`maybe_barrier` stays the identity."""
    global _BF16_BARRIER
    _BF16_BARRIER = bool(on)


def maybe_barrier(x: torch.Tensor) -> torch.Tensor:
    return x


def set_tp_context(mesh=None, model_axis: str = "model") -> None:
    """Set (or with ``mesh=None`` clear) the tensor-parallel mesh."""
    global _TP_CTX
    _TP_CTX = None if mesh is None else (mesh, model_axis)


def _data_shards(mesh, model_axis: str, rows: int) -> int:
    """How many data shards split ``rows`` leading rows: the product of
    the mesh's other axes where it divides ``rows``, else 1 (replicated)."""
    n = math.prod(size for name, size in mesh.shape.items() if name != model_axis)
    return n if rows % n == 0 else 1


def model_axis_psum(out: torch.Tensor, mesh, model_axis: str, data_axes: tuple | None = None,
                    ) -> torch.Tensor:
    """The psum of ``out`` over ``model_axis``.  Identity on a model axis
    of 1; on ``"meta"`` records one all-reduce of the per-device operand
    (``out``'s bytes over the data shards: the axes ``data_axes`` names,
    or, where it is None, every other axis that divides ``out``'s leading
    dim); on real tensors with a larger axis raises."""
    m = mesh.shape[model_axis]
    if m == 1:
        return out
    if out.device.type != "meta":
        raise RuntimeError(
            f"a model axis of {m} devices needs {m} cards in one process group; this program "
            "runs tensor and expert parallelism only on meta tensors (the dry-run)")
    if data_axes is None:
        shards = _data_shards(mesh, model_axis, out.shape[0])
    else:
        shards = math.prod(mesh.shape[a] for a in data_axes)
    record_collective("all-reduce", nbytes(out) / shards)
    return out


def maybe_row_parallel(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` with ``w`` row-parallel on the model axis when a mesh is
    set; ``h``'s last dim is model-sharded (a column-parallel product's
    output), ``w`` is ``[F, D]``, and the psum runs in ``h``'s dtype."""
    if _TP_CTX is None:
        return h @ w
    mesh, model_axis = _TP_CTX
    if w.shape[0] % mesh.shape[model_axis] != 0:
        return h @ w  # not evenly shardable; the reference leaves it to GSPMD
    return model_axis_psum(h @ w, mesh, model_axis)
