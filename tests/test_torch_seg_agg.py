"""The port's neighbourhood aggregation against the JAX ``seg_agg``, on the CPU.

The JAX side runs the Pallas kernel in interpret mode, as
tests/test_kernels.py does, and its jnp oracle.  The same numpy inputs go
through both packages.  Tolerances: float32 1e-6 (XLA:CPU and torch sum
the fanout in different orders), bfloat16 2e-2 (the two frameworks round
bf16 sums at different places).  The CUDA route is held to ``ref.py`` on
the card by tests/test_torch_kernels_gpu.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.seg_agg.kernel import seg_agg as jax_seg_agg
from repro.kernels.seg_agg.ref import seg_agg_ref as jax_seg_agg_ref
from repro_torch.kernels import aggregate_neighbors
from repro_torch.kernels.seg_agg import kernel as tk
from repro_torch.kernels.seg_agg.ref import seg_agg_ref

torch.set_num_threads(1)

TOL = {np.float32: 1e-6, ml_dtypes.bfloat16: 2e-2}


def _torch(x: np.ndarray) -> torch.Tensor:
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("s,fo,f", [(32, 5, 128), (7, 2, 602), (100, 15, 64), (1, 1, 1)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_aggregate_neighbors_matches_jax(s, fo, f, mode, dtype):
    rng = np.random.default_rng(s * 100 + fo)
    x = rng.standard_normal((s, fo, f)).astype(dtype)
    kernel_route = aggregate_neighbors(_torch(x), mode=mode, use_kernel=True)
    plain_route = aggregate_neighbors(_torch(x), mode=mode)
    assert kernel_route.shape == (s, f) and kernel_route.dtype == _torch(x).dtype
    torch.testing.assert_close(kernel_route, plain_route, rtol=0, atol=0)
    tol = TOL[dtype]
    for want in (jax_seg_agg(jnp.asarray(x), mode=mode), jax_seg_agg_ref(jnp.asarray(x), mode=mode)):
        np.testing.assert_allclose(_np32(kernel_route), _np32(want), rtol=tol, atol=tol)


def test_seg_agg_cpu_route_and_errors():
    x = torch.randn(6, 3, 10)
    before = tk.seg_agg.launches
    torch.testing.assert_close(tk.seg_agg(x, mode="mean"), x.mean(1), rtol=0, atol=0)
    torch.testing.assert_close(seg_agg_ref(x), x.sum(1), rtol=0, atol=0)
    assert tk.seg_agg.launches == before  # the CPU route launches nothing
    with pytest.raises(ValueError):
        tk.seg_agg(x, mode="max")
    with pytest.raises(ValueError):
        seg_agg_ref(x, mode="max")
    with pytest.raises(ValueError):
        tk.seg_agg(x[0])
