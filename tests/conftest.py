import numpy as np
import pytest

from repro.graph.datasets import load_dataset


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skipped (by a fixture) where there is none"
    )


@pytest.fixture(scope="session")
def small_dataset():
    return load_dataset("ogbn-products", scale=0.002, seed=0)


@pytest.fixture(scope="session")
def jit_warm(small_dataset):
    """Compile the presample/sample/gather programs once per process.

    jit compilation is per-process and would otherwise be charged to
    whichever timing-sensitive test (prep-cost comparisons, stage-time
    assertions) happens to run first in a cold process.  Tests that
    compare wall clocks depend on this fixture instead of each warming
    inline."""
    from repro.core.policies import prepare

    prepare(
        "dci",
        small_dataset,
        total_cache_bytes=200_000,
        fanouts=(3, 2),
        batch_size=64,
        n_presample=2,
    )


@pytest.fixture(scope="session")
def tiny_dataset():
    return load_dataset("reddit", scale=0.001, seed=1)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def cpu_mesh():
    """A 4-device 1-D serving mesh, shared by every mesh-placement test.

    Real device placement needs >= 4 jax devices; on CPU that means the
    process started with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
    (set before jax initializes — tests/test_mesh_respawn.py respawns the
    suite that way when the inline process only sees one device, and the
    tier1-mesh CI job sets it in the job env).  Skips when the devices
    are not there, so the inline single-device run stays green."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip(
            "needs >= 4 jax devices "
            "(XLA_FLAGS=--xla_force_host_platform_device_count=4)"
        )
    from repro.launch.mesh import make_serving_mesh

    return make_serving_mesh(4)
