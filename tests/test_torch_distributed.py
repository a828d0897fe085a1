"""``launch/distributed.py`` on the CPU: a gloo world of 1 started from
torchrun's and from the reference's environment variables, the production
topology check with the reference's counts, and a 1 x 1 ``DeviceMesh``."""

import socket

import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import distributed
from repro_torch.launch.mesh import AbstractMesh


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


ENVS = {
    "torchrun": lambda port: {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                              "WORLD_SIZE": "1", "RANK": "0"},
    "reference": lambda port: {"COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "NUM_PROCESSES": "1",
                               "PROCESS_ID": "0"},
}


@pytest.fixture
def world(request, monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "COORDINATOR_ADDRESS",
                "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    for var, value in ENVS[request.param](_free_port()).items():
        monkeypatch.setenv(var, value)
    distributed.initialize_from_env(device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


@pytest.mark.parametrize("world", list(ENVS), indirect=True)
def test_gloo_world_of_one(world):
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1 and dist.get_rank() == 0
    x = torch.arange(4.0)
    dist.all_reduce(x)
    assert torch.equal(x, torch.arange(4.0))
    mesh = distributed.device_mesh(AbstractMesh(("data", "model"), (1, 1)), "cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    with pytest.raises(RuntimeError, match="needs 256 processes"):
        distributed.device_mesh(AbstractMesh(("data", "model"), (16, 16)), "cpu")


@pytest.mark.parametrize("multi_pod,want", [(False, 256), (True, 512)])
@pytest.mark.parametrize("world", ["torchrun"], indirect=True)
def test_production_topology_names_the_counts(world, multi_pod, want):
    with pytest.raises(RuntimeError, match=f"needs {want} chips, found 1 "
                                           r"\(1 processes x 1 local\)"):
        distributed.assert_production_topology(multi_pod=multi_pod)


def test_no_rendezvous_and_no_card_raise(monkeypatch):
    for var in ("MASTER_ADDR", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        distributed.initialize_from_env(device="cpu")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize_from_env()
    assert not dist.is_initialized()
