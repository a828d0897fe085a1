"""The port's Mamba and RWKV-6 mixers (``models/lm/mamba.py``,
``models/lm/rwkv6.py``) against the JAX package's, on the CPU.

Parameters come from the reference's init functions (a PRNG key) and go
to the port through numpy, with every leaf the reference initialises to a
constant perturbed first (``conv_b`` 0, ``dt_bias`` 0, ``d_skip`` 1,
``u_bonus`` 0, ``w0`` -1, ``mu`` 0.5, ``ln_x`` 1), so that a mishandled
term shows.  Inputs are numpy from a seed.  float32 at atol = rtol = 1e-4,
bfloat16 at atol 3e-2 / rtol 1e-2 on outputs and 6e-2 / 1e-2 on the
float32 states (tests/test_torch_lm_model.py's tolerances: the two
frameworks round bfloat16 activations at other places); Mamba's bfloat16
cases widen atol to twice the reference's own distance from its float32
run (``tests/_torch_lm.py`` says why).  The chunked WKV6
is held to the scan at the reference's own tolerance
(tests/test_rwkv_chunked.py: rtol 2e-4, atol 2e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_lm import widened

from repro.configs import get_smoke as jax_smoke
from repro.models.lm import mamba as JMa
from repro.models.lm import rwkv6 as JR
from repro_torch.configs import get_smoke
from repro_torch.models.lm import mamba as TMa
from repro_torch.models.lm import rwkv6 as TR
from repro_torch.models.lm.model import params_from_jax

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=1e-2)
BF16_CACHE = dict(atol=6e-2, rtol=1e-2)
CHUNK_TOL = dict(rtol=2e-4, atol=2e-5)


def _cfg(arch, dtype):
    return (dataclasses.replace(jax_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke(arch), dtype=dtype))


def _perturbed(jp: dict, rng, constants: dict) -> dict:
    """``jp`` with each named constant leaf replaced by its value plus
    noise (scale given), in the leaf's dtype."""
    out = dict(jp)
    for key, scale in constants.items():
        leaf = np.asarray(jp[key], np.float32)
        out[key] = jnp.asarray(leaf + scale * rng.standard_normal(leaf.shape)).astype(
            jp[key].dtype)
    return out


def _both(jp):
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _x(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _caches_close(got: dict, want: dict, tol, want32: dict | None = None):
    """Leaf by leaf; with ``want32`` (the reference's float32 run) each
    leaf's tolerance is ``widened``."""
    assert sorted(got) == sorted(want)
    for key in want:
        w32 = None if want32 is None else want32[key]
        if isinstance(want[key], dict):
            _caches_close(got[key], want[key], tol, w32)
        else:
            assert tuple(got[key].shape) == want[key].shape
            assert str(got[key].dtype) == f"torch.{want[key].dtype}", key
            _close(got[key], want[key], tol if w32 is None else widened(tol, want[key], w32))


def _tols(dtype):
    return (TOL, TOL) if dtype == "float32" else (BF16, BF16_CACHE)


# ------------------------------------------------------------------ Mamba


def _mamba(dtype, seed=0, dt_shift=0.0):
    jcfg, cfg = _cfg("jamba-v0.1-52b", dtype)
    jp = JMa.init_mamba_params(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dtype))
    jp = _perturbed(jp, np.random.default_rng(seed + 10),
                    {"conv_b": 0.3, "dt_bias": 0.5, "d_skip": 0.5})
    if dt_shift:
        jp["dt_bias"] = jp["dt_bias"] + dt_shift
    return (jcfg, cfg, *_both(jp))


def _f32(fn, jp, jcfg, *args):
    """The reference's float32 run of ``fn`` on the same (upcast) values."""
    up = lambda t: jax.tree.map(lambda a: a.astype(jnp.float32), t)
    return fn(up(jp), *(up(a) for a in args), dataclasses.replace(jcfg, dtype="float32"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [3, 9, 24])
def test_mamba_prefill_matches_reference(dtype, s):
    jcfg, cfg, jp, tp = _mamba(dtype)
    jx, tx = _x(np.random.default_rng(s), (2, s, cfg.d_model), dtype)
    out, cache = TMa.mamba_prefill(tp, tx, cfg)
    jout, jcache = JMa.mamba_prefill(jp, jx, jcfg)
    tol, cache_tol = _tols(dtype)
    assert out.dtype == tx.dtype
    if dtype == "float32":
        _close(out, jout, tol)
        _caches_close(cache, jcache, cache_tol)
    else:
        out32, cache32 = _f32(JMa.mamba_prefill, jp, jcfg, jx)
        _close(out, jout, widened(tol, jout, out32))
        _caches_close(cache, jcache, cache_tol, cache32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_prefill_then_decode_matches_reference(dtype):
    """Prefill 7 tokens, then decode 5 one at a time on each package's own
    caches; and the decode alone from the reference's caches."""
    jcfg, cfg, jp, tp = _mamba(dtype, seed=1)
    rng = np.random.default_rng(2)
    jx, tx = _x(rng, (2, 7, cfg.d_model), dtype)
    _, cache = TMa.mamba_prefill(tp, tx, cfg)
    _, jcache = JMa.mamba_prefill(jp, jx, jcfg)
    jcache32 = jcache if dtype == "float32" else _f32(JMa.mamba_prefill, jp, jcfg, jx)[1]
    tol, cache_tol = _tols(dtype)
    for _ in range(5):
        jxt, txt = _x(rng, (2, 1, cfg.d_model), dtype)
        alone, _ = TMa.mamba_decode(tp, txt, params_from_jax(jax.tree.map(np.asarray, jcache)),
                                    cfg)
        out, cache = TMa.mamba_decode(tp, txt, cache, cfg)
        jout, jcache = JMa.mamba_decode(jp, jxt, jcache, jcfg)
        out32, jcache32 = ((jout, jcache) if dtype == "float32"
                           else _f32(JMa.mamba_decode, jp, jcfg, jxt, jcache32))
        _close(out, jout, widened(tol, jout, out32))
        _close(alone, jout, widened(tol, jout, out32))
        _caches_close(cache, jcache, cache_tol, jcache32)


def test_mamba_prefill_then_decode_equals_a_longer_prefill():
    jcfg, cfg, _, tp = _mamba("float32", seed=3)
    _, tx = _x(np.random.default_rng(4), (2, 12, cfg.d_model), "float32")
    full, full_cache = TMa.mamba_prefill(tp, tx, cfg)
    _, cache = TMa.mamba_prefill(tp, tx[:, :11], cfg)
    out, cache = TMa.mamba_decode(tp, tx[:, 11:], cache, cfg)
    torch.testing.assert_close(out, full[:, 11:], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(cache["ssm"], full_cache["ssm"], atol=1e-5, rtol=1e-5)
    assert torch.equal(cache["conv"], full_cache["conv"])


def test_mamba_softplus_past_its_threshold_matches_reference():
    """``dt_bias`` shifted by 25: ``dt`` runs far past 20, where
    ``torch.nn.functional.softplus`` would switch to the identity and
    ``jax.nn.softplus`` (``logaddexp(x, 0)``) does not."""
    jcfg, cfg, jp, tp = _mamba("float32", seed=5, dt_shift=25.0)
    jx, tx = _x(np.random.default_rng(6), (2, 6, cfg.d_model), "float32")
    u = torch.nn.functional.silu(tx @ tp["in_proj"][:, : 2 * cfg.d_model])
    dt, _, _ = TMa._ssm_inputs(tp, u)
    jdt, _, _ = JMa._ssm_inputs(jp, jnp.asarray(u.numpy()))
    assert float(dt.min()) > 20.0
    _close(dt, jdt, TOL)
    z = torch.linspace(-60.0, 60.0, 241)
    np.testing.assert_allclose(TMa._softplus(z).numpy(), np.asarray(jax.nn.softplus(
        jnp.asarray(z.numpy()))), rtol=1e-6, atol=1e-6)
    out, cache = TMa.mamba_prefill(tp, tx, cfg)
    jout, jcache = JMa.mamba_prefill(jp, jx, jcfg)
    _close(out, jout, TOL)
    _caches_close(cache, jcache, TOL)


def test_mamba_init_has_the_reference_layout_and_constants():
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = _cfg("jamba-v0.1-52b", dtype)
        jp = JMa.init_mamba_params(jax.random.PRNGKey(0), jcfg, jnp.dtype(dtype))
        tp = TMa.init_mamba_params(torch.Generator().manual_seed(0), cfg, getattr(torch, dtype),
                                   device="cpu")
        assert sorted(tp) == sorted(jp)
        for key in jp:
            assert tuple(tp[key].shape) == jp[key].shape
            assert str(tp[key].dtype) == f"torch.{jp[key].dtype}", key
            if key in ("conv_b", "dt_bias", "d_skip"):
                np.testing.assert_array_equal(tp[key].float().numpy(),
                                              np.asarray(jp[key], np.float32))
            elif key == "a_log":  # log(1..d_state): the two logs differ by an ulp
                np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]), rtol=1e-6)
            else:
                np.testing.assert_allclose(tp[key].float().numpy().std(),
                                           np.asarray(jp[key], np.float32).std(), rtol=0.1)
        cache = TMa.init_mamba_cache(cfg, 3, getattr(torch, dtype))
        jcache = JMa.init_mamba_cache(jcfg, 3, jnp.dtype(dtype))
        for key in jcache:
            assert tuple(cache[key].shape) == jcache[key].shape and not cache[key].any()
            assert str(cache[key].dtype) == f"torch.{jcache[key].dtype}"


# ----------------------------------------------------------------- RWKV-6


def _rwkv(dtype, seed=0):
    jcfg, cfg = _cfg("rwkv6-3b", dtype)
    rng = np.random.default_rng(seed + 20)
    tm = JR.init_rwkv_params(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dtype))
    tm = _perturbed(tm, rng, {"mu": 0.2, "w0": 0.5, "u_bonus": 0.5})
    tm["ln_x"] = {"scale": jnp.asarray(1.0 + 0.2 * rng.standard_normal(cfg.d_model),
                                       jnp.float32)}
    cm = JR.init_rwkv_cm_params(jax.random.PRNGKey(seed + 1), jcfg, jnp.dtype(dtype))
    cm = _perturbed(cm, rng, {"mu": 0.2})
    return jcfg, cfg, *_both(tm), *_both(cm)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 5, 20])
def test_rwkv_time_mix_scan_matches_reference(dtype, s):
    jcfg, cfg, jtm, ttm, _, _ = _rwkv(dtype)
    jx, tx = _x(np.random.default_rng(s), (2, s, cfg.d_model), dtype)
    out, cache = TR.rwkv_time_mix_prefill(ttm, tx, cfg)
    jout, jcache = JR.rwkv_time_mix_prefill(jtm, jx, jcfg)
    tol, cache_tol = _tols(dtype)
    assert out.dtype == tx.dtype
    _close(out, jout, tol)
    _caches_close(cache, jcache, cache_tol)


@pytest.mark.parametrize("s", [1, 7, 32, 64, 130])
@pytest.mark.parametrize("chunk", [16, 32])
def test_rwkv_chunked_matches_the_scan_and_the_reference(s, chunk):
    """tests/test_rwkv_chunked.py's grid: the port's chunked form against
    its scan at the reference's tolerance, and against the reference's
    chunked form at 1e-4."""
    jcfg, cfg, jtm, ttm, _, _ = _rwkv("float32", seed=1)
    jx, tx = _x(np.random.default_rng(100 + s), (2, s, cfg.d_model), "float32")
    y_scan, c_scan = TR.rwkv_time_mix_prefill(ttm, tx, cfg)
    y_chunk, c_chunk = TR.rwkv_time_mix_prefill_chunked(ttm, tx, cfg, chunk=chunk)
    torch.testing.assert_close(y_chunk, y_scan, **CHUNK_TOL)
    torch.testing.assert_close(c_chunk["state"], c_scan["state"], **CHUNK_TOL)
    assert torch.equal(c_chunk["shift"], c_scan["shift"])
    jy, jc = JR.rwkv_time_mix_prefill_chunked(jtm, jx, jcfg, chunk=chunk)
    _close(y_chunk, jy, TOL)
    _caches_close(c_chunk, jc, TOL)


def test_rwkv_chunked_then_decode_continues_the_scan():
    jcfg, cfg, _, ttm, _, _ = _rwkv("float32", seed=2)
    _, tx = _x(np.random.default_rng(3), (2, 34, cfg.d_model), "float32")
    y_full, _ = TR.rwkv_time_mix_prefill(ttm, tx, cfg)
    _, cache = TR.rwkv_time_mix_prefill_chunked(ttm, tx[:, :33], cfg, chunk=16)
    y_dec, _ = TR.rwkv_time_mix_decode(ttm, tx[:, 33:], cache, cfg)
    torch.testing.assert_close(y_dec, y_full[:, -1:], **CHUNK_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_decode_and_channel_mix_match_reference(dtype):
    """Time-mix and channel-mix prefill of 6 tokens, then 4 decode steps
    each, on each package's own caches."""
    jcfg, cfg, jtm, ttm, jcm, tcm = _rwkv(dtype, seed=3)
    rng = np.random.default_rng(4)
    jx, tx = _x(rng, (2, 6, cfg.d_model), dtype)
    tol, cache_tol = _tols(dtype)
    _, tcache = TR.rwkv_time_mix_prefill(ttm, tx, cfg)
    _, jtcache = JR.rwkv_time_mix_prefill(jtm, jx, jcfg)
    out, ccache = TR.rwkv_channel_mix_prefill(tcm, tx, cfg)
    jout, jccache = JR.rwkv_channel_mix_prefill(jcm, jx, jcfg)
    assert out.dtype == tx.dtype
    _close(out, jout, tol)
    _caches_close(ccache, jccache, TOL)  # the shift: the input itself, in float32
    for _ in range(4):
        jxt, txt = _x(rng, (2, 1, cfg.d_model), dtype)
        out, tcache = TR.rwkv_time_mix_decode(ttm, txt, tcache, cfg)
        jout, jtcache = JR.rwkv_time_mix_decode(jtm, jxt, jtcache, jcfg)
        _close(out, jout, tol)
        _caches_close(tcache, jtcache, cache_tol)
        out, ccache = TR.rwkv_channel_mix_decode(tcm, txt, ccache, cfg)
        jout, jccache = JR.rwkv_channel_mix_decode(jcm, jxt, jccache, jcfg)
        _close(out, jout, tol)
        _caches_close(ccache, jccache, TOL)


def test_rwkv_group_norm_uses_the_population_variance():
    jcfg, cfg, jtm, ttm, _, _ = _rwkv("float32")
    h, dh = TR._heads(cfg)
    x = np.random.default_rng(5).standard_normal((3, 4, h, dh)).astype(np.float32)
    got = TR._group_norm(ttm, torch.from_numpy(x), h, dh)
    want = jax.vmap(lambda o: JR._group_norm(jtm, o, h, dh), in_axes=1, out_axes=1)(
        jnp.asarray(x))
    _close(got, want, TOL)
    centred = x - x.mean(-1, keepdims=True)
    pop = (centred / np.sqrt((centred ** 2).mean(-1, keepdims=True) + 1e-5)).reshape(3, 4, -1)
    np.testing.assert_allclose(got.numpy(), pop * np.asarray(jtm["ln_x"]["scale"]),
                               rtol=1e-4, atol=1e-4)


def test_rwkv_init_has_the_reference_layout_and_constants():
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = _cfg("rwkv6-3b", dtype)
        gen = torch.Generator().manual_seed(0)
        for jp, tp in ((JR.init_rwkv_params(jax.random.PRNGKey(0), jcfg, jnp.dtype(dtype)),
                        TR.init_rwkv_params(gen, cfg, getattr(torch, dtype), device="cpu")),
                       (JR.init_rwkv_cm_params(jax.random.PRNGKey(1), jcfg, jnp.dtype(dtype)),
                        TR.init_rwkv_cm_params(gen, cfg, getattr(torch, dtype), device="cpu"))):
            assert jax.tree.structure(jp) == jax.tree.structure(tp)
            for (path, j), t in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                                    jax.tree.leaves(tp)):
                name = jax.tree_util.keystr(path)
                assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}", name
                a, b = t.float().numpy(), np.asarray(j, np.float32)
                if name in ("['mu']", "['w0']", "['u_bonus']", "['ln_x']['scale']"):
                    np.testing.assert_array_equal(a, b)
                else:
                    np.testing.assert_allclose(a.std(), b.std(), rtol=0.1, err_msg=name)
        cache = TR.init_rwkv_cache(cfg, 3)
        jcache = JR.init_rwkv_cache(jcfg, 3)
        for key in jcache:
            assert tuple(cache[key].shape) == jcache[key].shape and not cache[key].any()
            assert cache[key].dtype == torch.float32
