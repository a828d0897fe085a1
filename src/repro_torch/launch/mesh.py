"""The sharded-serving mesh: a flat list of ``torch.device``s, one per shard.

The reference's serving mesh is a 1-D ``jax.sharding.Mesh`` over local
devices.  Here a mesh is the list of devices the shards map onto, round
robin.  It clamps to the cards present, so on one card
``make_serving_mesh(4)`` is ``[cuda:0]``: the sharded server then keeps
its four shards co-resident there (same partition, same accounting, no
copies between devices).  On the CPU the mesh is the one CPU device.
Functions, not module constants: importing this module touches no device.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device

__all__ = ["make_serving_mesh", "serving_devices"]


def make_serving_mesh(num_shards: int, *, device: torch.device | str | None = None) -> list:
    """The first ``num_shards`` devices of ``device``'s type (CUDA unless
    ``"cpu"`` is asked for), clamped to the cards present; the CPU has
    one device."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(min(num_shards, torch.cuda.device_count()))]


def serving_devices(mesh) -> list:
    """The mesh's devices as a flat per-shard list."""
    return [torch.device(d) for d in mesh]
