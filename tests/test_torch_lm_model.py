"""The port's LM (``prefill``/``decode_step``) against the JAX package's,
on the CPU, over the dense decoder-only archs and the MoE and state-space
ones (Phi-3.5-MoE, DeepSeek-V2, Jamba, RWKV-6).

The reference's parameters (``init_params`` from a PRNG key) are carried
over by ``params_from_jax``; tokens are numpy from a seed.  Smoke configs
in float32: logits at atol = rtol = 1e-4 and greedy tokens equal over a
few decode steps, caches too.  One bfloat16 case is held at atol 3e-2 /
rtol 1e-2 (about eight bf16 ulps at the logits' scale, 0.7: the two
frameworks round activations at other places), with its caches at 6e-2.
The long-context ring (``long_mode``) and the local layers' window ring
are decoded past their wrap.  The port's own invariant, prefill then
decode equals a longer prefill, is held in float32.  Jamba's and RWKV-6's
bfloat16 caches widen atol to twice the reference's own distance from its
float32 run (``tests/_torch_lm.py``): there the reference's bfloat16
states lie further from its float32 ones than 6e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from _torch_lm import widened

from repro.configs import get_smoke as jax_smoke
from repro.models.lm import model as JM
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.models.lm import model as TM

torch.set_num_threads(1)

DENSE = ["gemma-2b", "gemma2-27b", "yi-6b", "granite-3-8b"]
MOE_SSM = ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b", "jamba-v0.1-52b", "rwkv6-3b"]
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


def _caches_close(tc, jc, tol, jc32=None):
    """Leaf by leaf; with ``jc32`` (the reference's float32 run) each
    leaf's tolerance is ``widened``."""
    got, want = jax.tree.leaves(tc), jax.tree.leaves(jc)
    want32 = want if jc32 is None else jax.tree.leaves(jc32)
    assert len(got) == len(want) == len(want32)
    for g, w, w32 in zip(got, want, want32):
        assert tuple(g.shape) == w.shape and str(g.dtype) == f"torch.{w.dtype}"
        _close(g.float(), w, widened(tol, w, w32))


def _run_both(jcfg, jp, cfg, tp, toks, *, steps, cache_size, tol, cache_tol, long_mode=False,
              spread=False):
    """Prefill and greedy decode in both packages; the port decodes from
    the reference's tokens so that a near-tie cannot fork the runs.  With
    ``spread`` the caches are held at ``cache_tol`` widened by the
    reference's float32 run on the same (upcast) parameters."""
    s = toks.shape[1]
    jl, jc = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, cache_size=cache_size,
                        long_mode=long_mode)
    tl, tc = TM.prefill(tp, {"tokens": torch.from_numpy(toks)}, cfg, cache_size=cache_size,
                        long_mode=long_mode)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    jc32 = JM.prefill(jp32, {"tokens": jnp.asarray(toks)}, jcfg32, cache_size=cache_size,
                      long_mode=long_mode)[1] if spread else None
    _close(tl, jl, tol)
    _caches_close(tc, jc, cache_tol, jc32)
    for i in range(steps):
        want_tok = np.asarray(jnp.argmax(jl[:, : jcfg.vocab], -1)).astype(np.int32)
        got_tok = torch.argmax(tl[:, : cfg.vocab], -1).numpy()
        if tol is TOL:
            np.testing.assert_array_equal(got_tok, want_tok)
        nxt = want_tok[:, None]
        jl, jc = JM.decode_step(jp, jnp.asarray(nxt), jc, jnp.int32(s + i), jcfg,
                                long_mode=long_mode)
        tl, tc = TM.decode_step(tp, torch.from_numpy(nxt), tc, s + i, cfg, long_mode=long_mode)
        if spread:
            jc32 = JM.decode_step(jp32, jnp.asarray(nxt), jc32, jnp.int32(s + i), jcfg32,
                                  long_mode=long_mode)[1]
        _close(tl, jl, tol)
    _caches_close(tc, jc, cache_tol, jc32)


@pytest.mark.parametrize("arch", DENSE + MOE_SSM)
def test_prefill_and_decode_match_reference(arch):
    jcfg, jp, cfg, tp = _pair(arch)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, 17)).astype(np.int32)
    _run_both(jcfg, jp, cfg, tp, toks, steps=4, cache_size=24, tol=TOL, cache_tol=TOL)


def test_prefill_and_decode_match_reference_in_bfloat16():
    jcfg, jp, cfg, tp = _pair("gemma-2b", dtype="bfloat16")
    assert tp["embed"].dtype == torch.bfloat16
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, 17)).astype(np.int32)
    _run_both(jcfg, jp, cfg, tp, toks, steps=3, cache_size=24, tol=BF16, cache_tol=BF16_CACHE)


@pytest.mark.parametrize("arch", MOE_SSM)
def test_moe_and_ssm_archs_match_reference_in_bfloat16(arch):
    """Logits at the bfloat16 tolerance over prefill and 4 decode steps;
    caches at theirs, widened for Jamba and RWKV-6 (the module docstring)."""
    jcfg, jp, cfg, tp = _pair(arch, dtype="bfloat16")
    assert tp["embed"].dtype == torch.bfloat16
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, 17)).astype(np.int32)
    _run_both(jcfg, jp, cfg, tp, toks, steps=4, cache_size=24, tol=BF16, cache_tol=BF16_CACHE,
              spread=arch in ("jamba-v0.1-52b", "rwkv6-3b"))


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


@pytest.mark.parametrize("arch", ["granite-3-8b", "gemma2-27b"] + MOE_SSM)
def test_prefill_then_decode_equals_a_longer_prefill(arch):
    """The reference's invariant (tests/test_lm_archs.py), on the port; as
    there, an MoE's capacity factor is raised to 8 so that the prefill
    drops no rows the decode would keep."""
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    tp = TM.init_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    s = 17
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (B, s + 1)))
    lf, _ = TM.prefill(tp, {"tokens": toks}, cfg, cache_size=s + 8)
    _, caches = TM.prefill(tp, {"tokens": toks[:, :s]}, cfg, cache_size=s + 8)
    ld, _ = TM.decode_step(tp, toks[:, s : s + 1], caches, s, cfg)
    torch.testing.assert_close(ld, lf, atol=2e-4, rtol=2e-4)


# Leaves the reference initialises to constants (norm scales, SSM and
# RWKV-6 terms): equal to the reference's; ``a_log`` is log(1..d_state),
# where the two packages' logs may part by an ulp.
CONSTANT_LEAVES = ("scale", "conv_b", "dt_bias", "d_skip", "mu", "w0", "u_bonus")


def test_init_params_has_the_reference_layout_and_distributions():
    """Layout, per-leaf dtypes (bfloat16 models keep their float32 leaves),
    constant leaves exactly, and each random leaf's spread (normal x
    scale) within 5%, or 15% for a leaf of under 4096 draws."""
    for arch in ["gemma2-27b", "seamless-m4t-medium"] + MOE_SSM:
        cfg = get_smoke(arch)
        jp = JM.init_params(jax.random.PRNGKey(0), jax_smoke(arch))
        tp = TM.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        assert jax.tree.structure(jp) == jax.tree.structure(tp), arch
        for (path, j), t in zip(jax.tree_util.tree_flatten_with_path(jp)[0], jax.tree.leaves(tp)):
            name = f"{arch} {jax.tree_util.keystr(path)}"
            assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}", name
            a, b = t.float().numpy(), np.asarray(j, np.float32)
            key = str(path[-1].key)
            if key in CONSTANT_LEAVES:
                np.testing.assert_array_equal(a, b, err_msg=name)
            elif key == "a_log":
                np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
            else:
                np.testing.assert_allclose(a.std(), b.std(), rtol=0.05 if a.size >= 4096 else 0.15,
                                           err_msg=name)


def test_params_from_jax_carries_bfloat16_bits():
    a = (np.arange(12, dtype=np.float32) / 7).astype(ml_dtypes.bfloat16).reshape(3, 4)
    t = TM.params_from_jax({"w": a, "n": (np.ones(2, np.float32),)})
    assert t["w"].dtype == torch.bfloat16 and isinstance(t["n"], tuple)
    np.testing.assert_array_equal(t["w"].view(torch.int16).numpy(), a.view(np.int16))


@pytest.mark.parametrize("arch", MOE_SSM)
def test_train_loss_raises_naming_its_roadmap_item(arch):
    """Only the dry-run's ``"dots"`` remat policy is left unported."""
    from repro_torch.models.lm import tp as lm_tp

    lm_tp.set_remat_policy("dots")
    try:
        with pytest.raises(NotImplementedError, match="A-item 19"):
            TM.train_loss({}, {}, get_smoke(arch))
    finally:
        lm_tp.set_remat_policy(None)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_are_the_reference_copies(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        __import__("repro.configs", fromlist=["get_config"]).get_config(arch))
    assert dataclasses.asdict(get_smoke(arch)) == dataclasses.asdict(jax_smoke(arch))
