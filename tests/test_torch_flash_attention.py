"""The port's attention against the JAX ``flash_attention_2d``, on the CPU.

The JAX side runs the Pallas kernel in interpret mode, as
tests/test_kernels.py does, and its jnp oracle ``attention_ref``.  The same
numpy inputs go through both packages.  Tolerances: float32 3e-4 (the
kernel's online softmax sums in another order than a dense softmax),
bfloat16 5e-2 (probabilities are rounded to bf16 before the product with
v).  The CUDA route is held to ``ref.py`` on the card by
tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_2d as jax_flash_2d
from repro.kernels.flash_attention.ops import multi_head_attention as jax_mha
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels import multi_head_attention
from repro_torch.kernels.flash_attention import kernel as tk
from repro_torch.kernels.flash_attention.ref import attention_ref, expand_kv

torch.set_num_threads(1)

F32, BF16 = 3e-4, 5e-2


def _torch(x: np.ndarray) -> torch.Tensor:
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _qkv(rng, shape_q, shape_kv, dtype=np.float32):
    return tuple(rng.standard_normal(s).astype(dtype) for s in (shape_q, shape_kv, shape_kv))


def _against_jax_2d(q, k, v, tol, **kw):
    got = tk.flash_attention_2d(_torch(q), _torch(k), _torch(v), **kw)
    assert got.shape == q.shape and got.dtype == _torch(q).dtype
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for want in (jax_flash_2d(jq, jk, jv, **kw), jax_attention_ref(jq, jk, jv, **kw)):
        np.testing.assert_allclose(_np32(got), _np32(want), rtol=tol, atol=tol)
    return got


@pytest.mark.parametrize(
    "sq,sk,d,causal,window,cap",
    [
        (128, 128, 64, True, None, None),
        (256, 256, 128, True, None, 50.0),
        (200, 200, 64, True, 64, None),
        (128, 128, 64, False, None, None),
        (96, 160, 64, False, None, None),
        (64, 64, 128, True, 16, 30.0),
    ],
)
def test_flash_attention_2d_matches_jax(sq, sk, d, causal, window, cap):
    rng = np.random.default_rng(sq + sk + d)
    q, k, v = _qkv(rng, (sq, d), (sk, d))
    _against_jax_2d(q, k, v, F32, causal=causal, window=window, softcap=cap)


def test_flash_attention_2d_bf16():
    q, k, v = _qkv(np.random.default_rng(1), (128, 64), (128, 64), ml_dtypes.bfloat16)
    _against_jax_2d(q, k, v, BF16, causal=True)


def test_flash_attention_decode_shape():
    """Sq = 1 against a long kv, without and with the causal mask (aligned
    at position 0, so the causal query sees key 0 only)."""
    q, k, v = _qkv(np.random.default_rng(2), (1, 64), (1024, 64))
    _against_jax_2d(q, k, v, F32, causal=False, window=None)
    got = _against_jax_2d(q, k, v, F32, causal=True)
    np.testing.assert_allclose(got.numpy()[0], v[0], rtol=1e-6, atol=1e-6)


def test_flash_attention_fully_masked_rows_output_zero():
    """Non-causal window 64 over 64 keys: query rows from 127 on keep no
    key and output 0 (not NaN), in both packages."""
    q, k, v = _qkv(np.random.default_rng(3), (200, 32), (64, 32))
    got = _against_jax_2d(q, k, v, F32, causal=False, window=64)
    assert np.isfinite(got.numpy()).all()
    assert not got.numpy()[127:].any() and got.numpy()[:127].any(axis=1).all()


@pytest.mark.parametrize("dtype,tol", [(np.float32, F32), (ml_dtypes.bfloat16, BF16)])
@pytest.mark.parametrize("hkv", [2, 1, 8])
def test_multi_head_attention_gqa_matches_jax(dtype, tol, hkv):
    b, hq, s, d = 2, 8, 64, 32
    q, k, v = _qkv(np.random.default_rng(hkv), (b, hq, s, d), (b, hkv, s, d), dtype)
    kernel_route = multi_head_attention(_torch(q), _torch(k), _torch(v), use_kernel=True)
    plain_route = multi_head_attention(_torch(q), _torch(k), _torch(v))
    assert kernel_route.shape == (b, hq, s, d)
    torch.testing.assert_close(kernel_route, plain_route, rtol=0, atol=0)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for use_kernel in (True, False):
        want = jax_mha(jq, jk, jv, use_kernel=use_kernel)
        np.testing.assert_allclose(_np32(kernel_route), _np32(want), rtol=tol, atol=tol)


def test_multi_head_attention_gemma2_variant():
    """Gemma-2's local-attention variant (window and softcap) at a small
    size, GQA 4:2, against the JAX op."""
    q, k, v = _qkv(np.random.default_rng(4), (1, 4, 96, 48), (1, 2, 96, 48))
    kw = dict(causal=True, window=32, softcap=50.0)
    got = multi_head_attention(_torch(q), _torch(k), _torch(v), use_kernel=True, **kw)
    want = jax_mha(*(jnp.asarray(a) for a in (q, k, v)), use_kernel=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32, atol=F32)


def test_flash_attention_cpu_route_and_errors():
    q = torch.randn(1, 4, 8, 16)
    k = torch.randn(1, 2, 8, 16)
    before = tk.flash_attention.launches
    torch.testing.assert_close(
        tk.flash_attention(q, k, k), attention_ref(q, expand_kv(k, 4), expand_kv(k, 4)),
        rtol=0, atol=0,
    )
    assert tk.flash_attention.launches == before  # the CPU route launches nothing
    with pytest.raises(ValueError):
        tk.flash_attention(q, torch.randn(1, 3, 8, 16), torch.randn(1, 3, 8, 16))  # 4 % 3
    with pytest.raises(ValueError):
        tk.flash_attention(q, k, k, softcap=0.0)
    with pytest.raises(ValueError):
        tk.flash_attention_2d(q, k, k)
    with pytest.raises(ValueError):
        multi_head_attention(q, torch.randn(1, 3, 8, 16), torch.randn(1, 3, 8, 16))
    assert jax.default_backend() == "cpu"
