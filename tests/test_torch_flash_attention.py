"""The port's attention against the JAX ``flash_attention_2d``, on the CPU.

The JAX side runs the Pallas kernel in interpret mode, as
tests/test_kernels.py does, and its jnp oracle ``attention_ref``.  The same
numpy inputs go through both packages.  Tolerances: float32 3e-4 (the
kernel's online softmax sums in another order than a dense softmax),
bfloat16 5e-2 (probabilities are rounded to bf16 before the product with
v).  The split-key decode's plain statement, ``attention_split_ref``, is
held to ``attention_ref`` and to the JAX kernel within 1e-5 (float32) and
5e-2 (bfloat16), and the routing rule ``plan`` is checked shape by shape.
The CUDA route is held to ``ref.py`` on the card by
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
from repro_torch.kernels.flash_attention.ref import (attention_ref, attention_split_ref,
                                                      expand_kv)

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
    designs = dict(tk.flash_attention.design_launches)
    torch.testing.assert_close(
        tk.flash_attention(q[:, :, :1], k, k),
        attention_ref(q[:, :, :1], expand_kv(k, 4), expand_kv(k, 4)), rtol=0, atol=0,
    )
    assert tk.flash_attention.launches == before  # the CPU route launches nothing
    assert tk.flash_attention.design_launches == designs
    with pytest.raises(ValueError):
        tk.flash_attention(q, torch.randn(1, 3, 8, 16), torch.randn(1, 3, 8, 16))  # 4 % 3
    with pytest.raises(ValueError):
        tk.flash_attention(q, k, k, softcap=0.0)
    with pytest.raises(ValueError):
        tk.flash_attention_2d(q, k, k)
    with pytest.raises(ValueError):
        multi_head_attention(q, torch.randn(1, 3, 8, 16), torch.randn(1, 3, 8, 16))
    assert jax.default_backend() == "cpu"


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (ml_dtypes.bfloat16, BF16)])
@pytest.mark.parametrize(
    "b,hq,hkv,sq,sk,d,causal,window,cap,chunk",
    [
        (1, 2, 2, 1, 300, 32, False, None, None, 64),  # group 1, Sk not a multiple of the chunk
        (1, 8, 1, 1, 256, 32, True, None, None, 64),  # group 8, causal Sq 1: key 0 only
        (2, 8, 1, 2, 130, 16, False, None, 30.0, 64),  # group 8, ragged last chunk
        (1, 4, 2, 3, 129, 32, False, 50, None, 32),  # group 2
        (1, 2, 1, 200, 200, 32, True, 20, None, 64),  # window shorter than a chunk
    ],
)
def test_attention_split_ref_matches_ref_and_jax(dtype, tol, b, hq, hkv, sq, sk, d, causal,
                                                 window, cap, chunk):
    """The split-key decode's arithmetic, chunk by chunk and combined,
    against the dense plain version and the JAX kernel (interpret mode),
    with chunks that keep no key."""
    q, k, v = _qkv(np.random.default_rng(sk + d), (b, hq, sq, d), (b, hkv, sk, d), dtype)
    kw = dict(causal=causal, window=window, softcap=cap)
    tq, tk, tv = _torch(q), expand_kv(_torch(k), hq), expand_kv(_torch(v), hq)
    got = attention_split_ref(tq, tk, tv, chunk=chunk, **kw)
    assert got.shape == (b, hq, sq, d) and got.dtype == tq.dtype
    assert np.isfinite(_np32(got)).all()
    ref = attention_ref(tq.float(), tk.float(), tv.float(), **kw)
    np.testing.assert_allclose(_np32(got), _np32(ref), rtol=tol, atol=tol)
    want = jax_mha(*(jnp.asarray(a) for a in (q, k, v)), use_kernel=True, **kw)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=tol, atol=tol)
    if causal and sq == 1:  # only key 0 is kept: the output is v[0] in every head
        np.testing.assert_allclose(_np32(got)[:, :, 0], _np32(tv)[:, :, 0], rtol=tol, atol=tol)


def test_plan_routes_each_shape_to_its_design():
    """Gemma-2 27B's prefill in bf16 takes the tensor cores, its decode the
    split (chunks of whole 64-key tiles covering Sk, about four CTAs per
    SM), float32 prefill and bf16 with D % 8 != 0 the FMA kernel."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert tk.plan(bf16, 1, 32, 16, 4096, 4096, 128, 132) == ("wgmma", 0, 0)
    decode = tk.plan(bf16, 1, 32, 16, 1, 4096, 128, 132)
    assert decode.design == "split" and decode.chunk % tk.SPLIT_TILE == 0
    assert decode.chunk * decode.n_chunks >= 4096 > decode.chunk * (decode.n_chunks - 1)
    assert 2 * 132 <= 16 * decode.n_chunks <= 4 * 132
    assert tk.plan(f32, 1, 32, 16, 1, 4096, 128, 132).design == "split"
    assert tk.plan(f32, 1, 32, 16, 4096, 4096, 128, 132).design == "fma"
    assert tk.plan(bf16, 2, 8, 2, 77, 130, 20, 132).design == "fma"
    # The split takes a kv head with at most 16 query rows (group * Sq).
    assert tk.plan(bf16, 1, 8, 1, 2, 64, 64, 132).design == "split"
    assert tk.plan(bf16, 1, 8, 1, 3, 64, 64, 132).design == "wgmma"
    assert tk.plan(bf16, 64, 32, 32, 16, 8192, 64, 132).design == "split"
    assert tk.plan(bf16, 64, 32, 32, 17, 8192, 64, 132).design == "wgmma"
    # Long keys over few heads: chunks stop at SPLIT_MAX_CHUNK.
    long = tk.plan(bf16, 1, 1, 1, 1, 10**6, 64, 132)
    assert long.chunk == tk.SPLIT_MAX_CHUNK and long.chunk * long.n_chunks >= 10**6
    # Many heads: one chunk each.
    assert tk.plan(bf16, 70000, 1, 1, 1, 4, 32, 132) == ("split", 64, 1)
