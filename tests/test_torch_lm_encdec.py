"""The encoder-decoder arch (SeamlessM4T) in the port against the JAX
package's, on the CPU: ``init_params``' tree, ``params_from_jax`` of the
``encoder`` subtree, and ``prefill`` (encoder stack, decoder with
cross-attention) then greedy decode steps through the step functions of
``launch/steps.py``.

Smoke config in float32: logits and caches (self and cross KV) at atol =
rtol = 1e-4, greedy tokens equal; the source frames are longer than the
target prompt, so the cross-attention runs ``Sq != Sk``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke as jax_smoke
from repro.launch import steps as JS
from repro.models.lm import model as JM
from repro_torch.configs import get_smoke
from repro_torch.launch import steps as TS
from repro_torch.models.lm import model as TM

torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
TOL = dict(atol=1e-4, rtol=1e-4)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want, np.float32), **TOL)


def test_encoder_config_is_the_references():
    got, want = TM.encoder_config(get_smoke(ARCH)), JM.encoder_config(jax_smoke(ARCH))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.block_pattern == ("attn",) and got.n_layers == got.encoder_layers


def test_init_params_has_the_reference_tree_and_params_from_jax_carries_it():
    cfg = get_smoke(ARCH)
    jp = JM.init_params(jax.random.PRNGKey(0), jax_smoke(ARCH))
    tp = TM.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert set(tp) == set(jp) and set(tp["encoder"]) == {"blocks", "final_norm"}
    assert "cross" in tp["blocks"][0] and "cross" not in tp["encoder"]["blocks"][0]
    carried = TM.params_from_jax(jax.tree.map(np.asarray, jp))
    for tree in (tp, carried):
        assert jax.tree.structure(tree) == jax.tree.structure(jp)
        for t, j in zip(jax.tree.leaves(tree), jax.tree.leaves(jp)):
            assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}"
    for t, j in zip(jax.tree.leaves(carried["encoder"]), jax.tree.leaves(jp["encoder"])):
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


def test_prefill_and_decode_match_the_reference():
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    cfg = dataclasses.replace(get_smoke(ARCH), dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg)
    tp = TM.params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(0)
    b, s, se, steps, cache = 2, 11, 19, 4, 16
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    src = rng.standard_normal((b, se, cfg.d_model)).astype(np.float32)
    jl, jc = JS.make_prefill_step(jcfg, cache_size=cache)(
        jp, {"tokens": jnp.asarray(toks), "src_embeds": jnp.asarray(src)})
    tl, tc = TS.make_prefill_step(cfg, cache_size=cache)(
        tp, {"tokens": torch.from_numpy(toks), "src_embeds": torch.from_numpy(src)})
    assert tc[0]["cross_kv"]["k"].shape == (cfg.n_repeats, b, se, cfg.n_kv_heads, cfg.head_dim)
    jserve, tserve = JS.make_serve_step(jcfg), TS.make_serve_step(cfg)
    for i in range(steps + 1):
        _close(tl, jl)
        got, want = jax.tree.leaves(tc), jax.tree.leaves(jc)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            _close(g, w)
        if i == steps:
            break
        nxt = np.asarray(jnp.argmax(jl[:, : jcfg.vocab], -1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(torch.argmax(tl[:, : cfg.vocab], -1).numpy(), nxt[:, 0])
        jl, jc = jserve(jp, jnp.asarray(nxt), jc, jnp.int32(s + i))
        tl, tc = tserve(tp, torch.from_numpy(nxt), tc, s + i)
