"""Tensor-parallel helpers, one-device part.

The reference routes the row-parallel matmul through a ``shard_map`` with
an explicit bf16 ``psum`` when a tensor-parallel mesh is set, and can pin
it with an optimization barrier.  On one device both are plain: the
row-parallel matmul is ``h @ w`` and the barrier is the identity.  Setting
a mesh raises: sharded LM execution comes with the dry-runs (ROADMAP
A-item 19).  ``set_rwkv_chunked(True)`` routes RWKV-6 prefill to the
chunked WKV6 (``blocks.block_prefill``); the remat flag keeps its setter
and getter for training (A-item 18.4).
"""

from __future__ import annotations

import torch

__all__ = [
    "set_tp_context",
    "maybe_row_parallel",
    "maybe_barrier",
    "set_remat_policy",
    "remat_policy",
    "set_rwkv_chunked",
    "rwkv_chunked",
]

_REMAT_POLICY: str | None = None
_RWKV_CHUNKED = False


def set_remat_policy(name: str | None) -> None:
    """Name the layer-stack remat policy (``"dots"`` or None), as the
    reference's training variant ``remat_dots`` does."""
    global _REMAT_POLICY
    _REMAT_POLICY = name


def remat_policy() -> str | None:
    return _REMAT_POLICY


def set_rwkv_chunked(on: bool) -> None:
    """Select the chunked WKV6 prefill instead of the per-token scan."""
    global _RWKV_CHUNKED
    _RWKV_CHUNKED = bool(on)


def rwkv_chunked() -> bool:
    return _RWKV_CHUNKED


def set_tp_context(mesh=None, model_axis: str = "model") -> None:
    """Only ``mesh=None`` (one device) is ported."""
    if mesh is not None:
        raise NotImplementedError(
            "tensor-parallel LM meshes are not ported yet (ROADMAP A-item 19: dry-runs "
            "and sharding)"
        )


def maybe_row_parallel(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` (one device: no row-parallel psum)."""
    return h @ w


def maybe_barrier(x: torch.Tensor) -> torch.Tensor:
    return x
