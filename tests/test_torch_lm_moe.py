"""The port's top-k MoE (``models/lm/moe.py``) against the JAX package's,
on the CPU.

Parameters come from the reference's ``init_moe_params`` (a PRNG key) and
go to the port through numpy; inputs are numpy from a seed.  float32 at
atol = rtol = 1e-4 (output and the load-balance ``aux``), bfloat16 at
atol 3e-2 / rtol 1e-2 (the whole-model tolerance of
tests/test_torch_lm_model.py: the frameworks round activations at other
places); ``aux`` is float32 in both dtypes and held at 1e-4.  The expert
dispatch (stable sort, capacity, overflow drops) is integer work, so a
router that sends every token to expert 0 must drop exactly the
reference's rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.models.lm import moe as JMoE
from repro_torch.configs import get_config, get_smoke
from repro_torch.models.lm import moe as TMoE
from repro_torch.models.lm.model import params_from_jax

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=1e-2)
ARCHS = ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b", "jamba-v0.1-52b"]


def _cfgs(arch, dtype="float32", **moe):
    jcfg = dataclasses.replace(jax_smoke(arch), dtype=dtype)
    cfg = dataclasses.replace(get_smoke(arch), dtype=dtype)
    if moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return jcfg, cfg


def _params(jcfg, seed=0):
    jp = JMoE.init_moe_params(jax.random.PRNGKey(seed), jcfg, jnp.dtype(jcfg.dtype))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if torch.is_tensor(got) else got,
                                          np.float32),
                               np.asarray(want, np.float32), **tol)


def _run(jp, tp, jcfg, cfg, x):
    dtype = jnp.dtype(jcfg.dtype)
    jout, jaux = JMoE.moe_ffn(jp, jnp.asarray(x).astype(dtype), jcfg)
    tout, taux = TMoE.moe_ffn(tp, torch.from_numpy(x).to(getattr(torch, jcfg.dtype)), cfg)
    assert tout.dtype == getattr(torch, jcfg.dtype) and taux.dtype == torch.float32
    return tout, taux, jout, jaux


@pytest.mark.parametrize("tokens", [1, 2, 7, 8, 33, 100, 1024, 4096])
@pytest.mark.parametrize("arch,size,cf", [
    ("phi3.5-moe-42b-a6.6b", "smoke", None), ("deepseek-v2-236b", "smoke", None),
    ("jamba-v0.1-52b", "smoke", 0.5), ("jamba-v0.1-52b", "smoke", 8.0),
    ("phi3.5-moe-42b-a6.6b", "full", None), ("deepseek-v2-236b", "full", None),
    ("jamba-v0.1-52b", "full", None),
])
def test_moe_capacity_matches_reference(arch, size, cf, tokens):
    if size == "full":
        jcfg, cfg = jax_config(arch), get_config(arch)
    else:
        jcfg, cfg = _cfgs(arch, **({} if cf is None else dict(capacity_factor=cf)))
    assert TMoE.moe_capacity(tokens, cfg) == JMoE.moe_capacity(tokens, jcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, dtype):
    """Output and aux on each MoE arch's smoke config: phi3.5 (top-2),
    deepseek (shared experts) and jamba (MoE every other layer), with the
    default capacity factor (1.25), so some rows overflow."""
    jcfg, cfg = _cfgs(arch, dtype)
    jp, tp = _params(jcfg)
    x = np.random.default_rng(0).standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    tout, taux, jout, jaux = _run(jp, tp, jcfg, cfg, x)
    _close(tout, jout, TOL if dtype == "float32" else BF16)
    _close(taux, jaux, TOL)


def _to_expert_zero(tp, jp):
    """A router that sends every token to expert 0 first (a large logit for
    every input of positive mean), the others ranked by small distinct
    logits, in both packages."""
    router = np.asarray(jp["router"]).copy() * 0.1
    router[:, 0] = 0.2
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    return jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_overflow_drops_the_reference_rows(arch, dtype):
    """Every token's first choice is expert 0, over its capacity: the
    dropped assignments (those past capacity in the stable sort) must be
    the reference's, so the output equals it; with ample capacity (a
    factor of 16) nothing drops and the output changes."""
    jcfg, cfg = _cfgs(arch, dtype)
    jp, tp = _to_expert_zero(*reversed(_params(jcfg, seed=3)))
    x = (1.0 + 0.3 * np.random.default_rng(1).standard_normal((2, 16, cfg.d_model))).astype(
        np.float32)
    t = x.shape[0] * x.shape[1]
    cap = TMoE.moe_capacity(t, cfg)
    probs = torch.softmax(torch.from_numpy(x).reshape(t, -1) @ tp["router"], -1)
    assert bool((probs.argmax(-1) == 0).all()) and cap < t  # expert 0 overflows
    tout, taux, jout, jaux = _run(jp, tp, jcfg, cfg, x)
    _close(tout, jout, TOL if dtype == "float32" else BF16)
    _close(taux, jaux, TOL)
    roomy_j, roomy_t = _cfgs(arch, dtype, capacity_factor=16.0)
    rout, _, jrout, _ = _run(jp, tp, roomy_j, roomy_t, x)
    _close(rout, jrout, TOL if dtype == "float32" else BF16)
    assert not torch.allclose(rout.float(), tout.float(), atol=1e-3)


def test_top6_bfloat16_dispatch_repeats_bit_for_bit():
    """Top-6 in bfloat16 (DeepSeek-V2's k): the combine adds each token's
    rows in a fixed order, so two runs give the same bits (on the card
    too: tests/test_torch_kernels_gpu.py), and the result is the
    reference's at the bfloat16 tolerance."""
    jcfg, cfg = _cfgs("deepseek-v2-236b", "bfloat16", n_experts=8, top_k=6)
    jp, tp = _params(jcfg, seed=5)
    x = np.random.default_rng(2).standard_normal((3, 11, cfg.d_model)).astype(np.float32)
    a, _, jout, _ = _run(jp, tp, jcfg, cfg, x)
    b, _ = TMoE.moe_ffn(tp, torch.from_numpy(x).bfloat16(), cfg)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    _close(a, jout, BF16)


def test_init_moe_params_has_the_reference_layout_and_distributions():
    for arch in ARCHS:
        jcfg, cfg = _cfgs(arch, "bfloat16")
        jp = JMoE.init_moe_params(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
        tp = TMoE.init_moe_params(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                                  device="cpu")
        assert jax.tree.structure(jp) == jax.tree.structure(tp)
        for t, j in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
            assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}"
            np.testing.assert_allclose(t.float().numpy().std(), np.asarray(j, np.float32).std(),
                                       rtol=0.05)


def test_shard_map_context_raises_for_a_mesh_naming_the_roadmap_item():
    TMoE.set_shard_map_context(None)
    with pytest.raises(NotImplementedError, match="A-item 19"):
        TMoE.set_shard_map_context(object(), ("data",), "model")
