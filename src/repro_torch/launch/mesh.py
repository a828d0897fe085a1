"""Production meshes for the dry-run, and the sharded-serving mesh.

``make_production_mesh`` is the reference's pod topology as an abstract
mesh: axis names and sizes, ``(data=16, model=16)`` for one pod of 256
devices or ``(pod=2, data=16, model=16)`` for two, with no process group
and no devices behind it.  The dry-run reads its axis sizes to split a
step's counts per device.  A real ``DeviceMesh`` over running processes
is built by ``launch/distributed.py`` on a cluster.  ``HW`` holds the
card's published peaks for the dry-run's roofline terms.

The sharded-serving mesh is a flat list of ``torch.device``s, one per shard.

The reference's serving mesh is a 1-D ``jax.sharding.Mesh`` over local
devices.  Here a mesh is the list of devices the shards map onto, round
robin.  It clamps to the cards present, so on one card
``make_serving_mesh(4)`` is ``[cuda:0]``: the sharded server then keeps
its four shards co-resident there (same partition, same accounting, no
copies between devices).  On the CPU the mesh is the one CPU device.
Functions, not module constants: importing this module touches no device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device

__all__ = ["AbstractMesh", "make_production_mesh", "make_serving_mesh", "serving_devices", "HW"]

# NVIDIA H100 SXM (the "H100 80GB HBM3"), per card: published, not measured.
HW = {
    "peak_flops_bf16": 989.4e12,  # FLOP/s, dense bf16 tensor-core peak (published, not measured)
    "hbm_bw": 3.35e12,  # B/s, HBM3 (published, not measured)
    # B/s per direction per GPU over NVLink 4: 900 GB/s both ways (published, not measured)
    "ici_bw_per_link": 450e9,
}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Named mesh axes and their sizes, with no devices behind them."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def label(self) -> str:
        """``"16x16"``, ``"2x16x16"``: the dry-run record's ``mesh``."""
        return "x".join(str(n) for n in self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """One pod as ``(data=16, model=16)``; two as ``(pod=2, data=16, model=16)``."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


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
