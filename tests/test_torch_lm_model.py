"""The port's LM (``prefill``/``decode_step``) against the JAX package's,
on the CPU, over the four dense decoder-only archs.

The reference's parameters (``init_params`` from a PRNG key) are carried
over by ``params_from_jax``; tokens are numpy from a seed.  Smoke configs
in float32: logits at atol = rtol = 1e-4 and greedy tokens equal over a
few decode steps, caches too.  One bfloat16 case is held at atol 3e-2 /
rtol 1e-2 (about eight bf16 ulps at the logits' scale, 0.7: the two
frameworks round activations at other places), with its caches at 6e-2.
The long-context ring (``long_mode``) and the local layers' window ring
are decoded past their wrap.  The port's own invariant, prefill then
decode equals a longer prefill, is held in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models.lm import model as JM
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.models.lm import model as TM

torch.set_num_threads(1)

DENSE = ["gemma-2b", "gemma2-27b", "yi-6b", "granite-3-8b"]
TOL = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=1e-2)
BF16_CACHE = dict(atol=6e-2, rtol=1e-2)
B = 2


def _pair(arch, dtype="float32", **overrides):
    """(jax cfg, jax params, port cfg, port params) from one PRNG key."""
    jcfg = dataclasses.replace(jax_smoke(arch), dtype=dtype, **overrides)
    cfg = dataclasses.replace(get_smoke(arch), dtype=dtype, **overrides)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, TM.params_from_jax(jax.tree.map(np.asarray, jp))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)


def _caches_close(tc, jc, tol):
    got, want = jax.tree.leaves(tc), jax.tree.leaves(jc)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g.float(), w, tol)


def _run_both(jcfg, jp, cfg, tp, toks, *, steps, cache_size, tol, cache_tol, long_mode=False):
    """Prefill and greedy decode in both packages; the port decodes from
    the reference's tokens so that a near-tie cannot fork the runs."""
    s = toks.shape[1]
    jl, jc = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, cache_size=cache_size,
                        long_mode=long_mode)
    tl, tc = TM.prefill(tp, {"tokens": torch.from_numpy(toks)}, cfg, cache_size=cache_size,
                        long_mode=long_mode)
    _close(tl, jl, tol)
    _caches_close(tc, jc, cache_tol)
    for i in range(steps):
        want_tok = np.asarray(jnp.argmax(jl[:, : jcfg.vocab], -1)).astype(np.int32)
        got_tok = torch.argmax(tl[:, : cfg.vocab], -1).numpy()
        if tol is TOL:
            np.testing.assert_array_equal(got_tok, want_tok)
        nxt = want_tok[:, None]
        jl, jc = JM.decode_step(jp, jnp.asarray(nxt), jc, jnp.int32(s + i), jcfg,
                                long_mode=long_mode)
        tl, tc = TM.decode_step(tp, torch.from_numpy(nxt), tc, s + i, cfg, long_mode=long_mode)
        _close(tl, jl, tol)
    _caches_close(tc, jc, cache_tol)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch):
    jcfg, jp, cfg, tp = _pair(arch)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, 17)).astype(np.int32)
    _run_both(jcfg, jp, cfg, tp, toks, steps=4, cache_size=24, tol=TOL, cache_tol=TOL)


def test_prefill_and_decode_match_reference_in_bfloat16():
    jcfg, jp, cfg, tp = _pair("gemma-2b", dtype="bfloat16")
    assert tp["embed"].dtype == torch.bfloat16
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, 17)).astype(np.int32)
    _run_both(jcfg, jp, cfg, tp, toks, steps=3, cache_size=24, tol=BF16, cache_tol=BF16_CACHE)


def test_long_mode_ring_wraps_like_the_reference():
    """A prompt longer than the long-context window, then decode past it
    (tests/test_lm_archs.py's ring-buffer case), against the reference."""
    jcfg, jp, cfg, tp = _pair("granite-3-8b", long_context_window=8)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, 16)).astype(np.int32)
    _run_both(jcfg, jp, cfg, tp, toks, steps=14, cache_size=8, tol=TOL, cache_tol=TOL,
              long_mode=True)


def test_local_layers_ring_wraps_like_the_reference():
    """Gemma-2's local layers keep a window-long ring (16 in the smoke
    config): a 20-token prompt has already wrapped it, decode goes on."""
    jcfg, jp, cfg, tp = _pair("gemma2-27b")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (B, 20)).astype(np.int32)
    _run_both(jcfg, jp, cfg, tp, toks, steps=6, cache_size=32, tol=TOL, cache_tol=TOL)


def test_embeds_and_mrope_prefill_match_reference():
    jcfg, jp, cfg, tp = _pair("qwen2-vl-2b")
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((B, 12, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32)[None, :, None], (B, 12, 3)).copy()
    pos[:, :6, 1] += 7
    jl, _ = JM.prefill(jp, {"embeds": jnp.asarray(emb), "positions": jnp.asarray(pos)}, jcfg,
                       cache_size=12)
    tl, _ = TM.prefill(tp, {"embeds": torch.from_numpy(emb), "positions": torch.from_numpy(pos)},
                       cfg, cache_size=12)
    _close(tl, jl, TOL)
    np.testing.assert_array_equal(TM.default_positions(cfg, B, 12).numpy(),
                                  np.asarray(JM.default_positions(jcfg, B, 12)))


@pytest.mark.parametrize("arch", ["granite-3-8b", "gemma2-27b"])
def test_prefill_then_decode_equals_a_longer_prefill(arch):
    """The reference's invariant (tests/test_lm_archs.py), on the port."""
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    tp = TM.init_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    s = 17
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (B, s + 1)))
    lf, _ = TM.prefill(tp, {"tokens": toks}, cfg, cache_size=s + 8)
    _, caches = TM.prefill(tp, {"tokens": toks[:, :s]}, cfg, cache_size=s + 8)
    ld, _ = TM.decode_step(tp, toks[:, s : s + 1], caches, s, cfg)
    torch.testing.assert_close(ld, lf, atol=2e-4, rtol=2e-4)


def test_init_params_has_the_reference_layout_and_distributions():
    cfg = get_smoke("gemma2-27b")
    jp = JM.init_params(jax.random.PRNGKey(0), jax_smoke("gemma2-27b"))
    tp = TM.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.structure(jp) == jax.tree.structure(tp)
    for t, j in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}"
        a, b = t.float().numpy(), np.asarray(j, np.float32)
        if a.size >= 4096:  # the draw's spread (normal x scale), within 5%
            np.testing.assert_allclose(a.std(), b.std(), rtol=0.05)
        else:
            np.testing.assert_array_equal(a, b)  # norm scales: ones


def test_params_from_jax_carries_bfloat16_bits():
    a = (np.arange(12, dtype=np.float32) / 7).astype(ml_dtypes.bfloat16).reshape(3, 4)
    t = TM.params_from_jax({"w": a, "n": (np.ones(2, np.float32),)})
    assert t["w"].dtype == torch.bfloat16 and isinstance(t["n"], tuple)
    np.testing.assert_array_equal(t["w"].view(torch.int16).numpy(), a.view(np.int16))


@pytest.mark.parametrize("arch,item", [
    ("phi3.5-moe-42b-a6.6b", "A-item 18.2"), ("deepseek-v2-236b", "A-item 18.2"),
    ("jamba-v0.1-52b", "A-item 18.2"), ("rwkv6-3b", "A-item 18.2"),
    ("seamless-m4t-medium", "A-item 18.3"),
])
def test_unported_archs_raise_naming_their_roadmap_item(arch, item):
    with pytest.raises(NotImplementedError, match=item):
        TM.init_params(get_smoke(arch), generator=torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError, match="A-item 18.4"):
        TM.train_loss({}, {}, get_smoke(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_are_the_reference_copies(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        __import__("repro.configs", fromlist=["get_config"]).get_config(arch))
    assert dataclasses.asdict(get_smoke(arch)) == dataclasses.asdict(jax_smoke(arch))
