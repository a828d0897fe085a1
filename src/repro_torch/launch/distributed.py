"""Multi-process bootstrap for a real cluster of cards.

Each process drives one card and runs the same program.
``initialize_from_env`` starts ``torch.distributed`` from the environment
torchrun sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``)
or from the reference's variables (``COORDINATOR_ADDRESS`` as
``host:port``, ``NUM_PROCESSES``, ``PROCESS_ID``), with NCCL on CUDA and
gloo on the CPU; it never falls back from one to the other.
``assert_production_topology`` checks the world against the production
mesh, and ``device_mesh`` builds the ``DeviceMesh`` of an abstract mesh
(``launch/mesh.py``) over the running processes.  The dry-run never calls
this module: its meshes are abstract.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device

__all__ = ["initialize_from_env", "assert_production_topology", "device_mesh"]


def _rendezvous() -> tuple[str, int, int]:
    """``(init_method, world_size, rank)`` from the environment."""
    env = os.environ
    if "MASTER_ADDR" in env:
        return (f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}", int(env["WORLD_SIZE"]),
                int(env["RANK"]))
    if "COORDINATOR_ADDRESS" in env:
        return (f"tcp://{env['COORDINATOR_ADDRESS']}", int(env["NUM_PROCESSES"]),
                int(env["PROCESS_ID"]))
    raise RuntimeError("set MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK (torchrun) or "
                       "COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID")


def initialize_from_env(device: torch.device | str | None = None) -> None:
    """``init_process_group`` from the environment: NCCL when ``device``
    is CUDA (the default; this process takes card ``LOCAL_RANK``, else
    ``rank % cards``), gloo when it is ``"cpu"``."""
    init_method, world, rank = _rendezvous()
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
                            world_size=world, rank=rank)


def assert_production_topology(*, multi_pod: bool) -> None:
    want = 512 if multi_pod else 256
    got = dist.get_world_size()
    if got != want:
        raise RuntimeError(
            f"production mesh needs {want} chips, found {got} ({got} processes x 1 local)")


def device_mesh(mesh, device_type: str = "cuda"):
    """The ``DeviceMesh`` of abstract ``mesh`` over the process group,
    whose world size must be ``mesh.size``."""
    if dist.get_world_size() != mesh.size:
        raise RuntimeError(f"mesh {mesh.label()} needs {mesh.size} processes, the group has "
                           f"{dist.get_world_size()}")
    return init_device_mesh(device_type, mesh.axis_sizes, mesh_dim_names=mesh.axis_names)
