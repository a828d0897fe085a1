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
from repro.models.gnn.layers import split_frontier as jax_split_frontier
from repro_torch.kernels import aggregate_neighbors
from repro_torch.kernels.seg_agg import kernel as tk
from repro_torch.kernels.seg_agg.ref import seg_agg_indexed_ref, seg_agg_ref

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


# ---------------------------------------------------------------- indexed form
# A sampled layer's self-and-fanout aggregation read through the inverse
# map: held to the JAX package's ``input_feats[inverse]`` followed by its
# own layer split and sum.  Pad rows of the table are NaN, so one read
# would show in every output it reaches.


def _indexed_inputs(num_dst, fanout, f, dense, seed):
    rng = np.random.default_rng(seed)
    positions = num_dst * (1 + fanout)
    if dense:
        return rng.standard_normal((positions, f)).astype(np.float32), None
    live = max(positions // 3, 1)
    table = np.full((live + 5, f), np.nan, np.float32)  # rows past `live` are pad
    table[:live] = rng.standard_normal((live, f))
    return table, rng.integers(0, live, positions).astype(np.int32)


def _jax_indexed(table, idx, num_dst, fanout, mode):
    h = jnp.asarray(table) if idx is None else jnp.asarray(table)[jnp.asarray(idx)]
    self_h, nbr_h = jax_split_frontier(h, num_dst, fanout)
    if mode == "sage":
        return np.asarray(self_h), np.asarray(nbr_h.sum(axis=1))
    return (np.asarray((self_h + nbr_h.sum(axis=1)) / (fanout + 1)),)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("fanout", [1, 5, 15])
@pytest.mark.parametrize("f", [3, 100, 602])
@pytest.mark.parametrize("mode", ["sage", "gcn"])
def test_seg_agg_indexed_matches_jax_inverse_then_layer_sum(mode, f, fanout, dense):
    num_dst = 37
    table, idx = _indexed_inputs(num_dst, fanout, f, dense, seed=f * 100 + fanout)
    before = tk.seg_agg_indexed.launches
    got = tk.seg_agg_indexed(
        torch.from_numpy(table), None if idx is None else torch.from_numpy(idx),
        num_dst=num_dst, fanout=fanout, mode=mode,
    )
    assert tk.seg_agg_indexed.launches == before  # the CPU route launches nothing
    got = got if mode == "sage" else (got,)
    want = _jax_indexed(table, idx, num_dst, fanout, mode)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == (num_dst, f) and g.dtype == torch.float32
        assert not torch.isnan(g).any()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
    # The dense form of the same positions gives the same bits.
    if idx is not None:
        dense_got = seg_agg_indexed_ref(torch.from_numpy(table[idx]), None, num_dst=num_dst,
                                        fanout=fanout, mode=mode)
        dense_got = dense_got if mode == "sage" else (dense_got,)
        for g, d in zip(got, dense_got):
            assert torch.equal(g, d)


@pytest.mark.parametrize("mode", ["sage", "gcn"])
@pytest.mark.parametrize("dense", [False, True])
def test_seg_agg_indexed_no_destinations(mode, dense):
    idx = None if dense else torch.empty(0, dtype=torch.int32)
    rows = torch.empty((0 if dense else 4), 7)
    got = tk.seg_agg_indexed(rows, idx, num_dst=0, fanout=5, mode=mode)
    for g in got if mode == "sage" else (got,):
        assert g.shape == (0, 7)


def test_seg_agg_indexed_gcn_divides_by_fanout_plus_one():
    """One destination, fanout 2: the mean is over {self} and both draws,
    read in any order through the index."""
    table = torch.tensor([[2.0, 2.0], [3.0, 0.0], [9.0, 9.0], [1.0, 1.0]])  # row 2 never read
    idx = torch.tensor([1, 3, 0], dtype=torch.int32)  # self row 1, neighbours rows 3 and 0
    mean = tk.seg_agg_indexed(table, idx, num_dst=1, fanout=2, mode="gcn")
    torch.testing.assert_close(mean, torch.tensor([[2.0, 1.0]]), rtol=0, atol=0)
    self_h, agg = tk.seg_agg_indexed(table, idx, num_dst=1, fanout=2, mode="sage")
    torch.testing.assert_close(self_h, torch.tensor([[3.0, 0.0]]), rtol=0, atol=0)
    torch.testing.assert_close(agg, torch.tensor([[3.0, 3.0]]), rtol=0, atol=0)


def test_seg_agg_indexed_refusals():
    table = torch.randn(10, 4)
    idx = torch.zeros(3 * 6, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        tk.seg_agg_indexed(table, idx.long(), num_dst=3, fanout=5, mode="sage")
    with pytest.raises(ValueError, match="idx must be"):
        tk.seg_agg_indexed(table, idx[:-1], num_dst=3, fanout=5, mode="sage")
    with pytest.raises(ValueError, match=r"\[R, F\]"):
        tk.seg_agg_indexed(table[None], idx, num_dst=3, fanout=5, mode="sage")
    with pytest.raises(ValueError, match="dense form"):
        tk.seg_agg_indexed(table, None, num_dst=3, fanout=5, mode="gcn")
    with pytest.raises(ValueError, match="mode"):
        tk.seg_agg_indexed(table, idx, num_dst=3, fanout=5, mode="mean")
    with pytest.raises(ValueError, match="fanout"):
        tk.seg_agg_indexed(table, idx, num_dst=3, fanout=0, mode="gcn")
    with pytest.raises(ValueError, match="mode"):
        seg_agg_indexed_ref(table, idx, num_dst=3, fanout=5, mode="mean")
