"""The port's ``train_loss`` and its gradients against the JAX package's
``jax.value_and_grad(train_loss)``, on the CPU, for every arch.

Smoke configs in float32 (TF32 off), the reference's parameters carried
over by ``params_from_jax``, batches from a numpy seed with some labels
−100: the loss at rtol 1e-4, every gradient leaf at atol 1e-4 × the
leaf's largest |g|.  The encoder-decoder takes ``src_embeds`` of another
length than its targets, the embeds arch (Qwen2-VL) takes ``embeds`` and
M-RoPE positions.  One case runs 1024 tokens, two 512-token loss chunks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from repro.configs import get_smoke as jax_smoke
from repro.models.lm import model as JM
from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.models.lm import model as TM
from repro_torch.models.lm import tp as lm_tp
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

RTOL = 1e-4


def _pair(arch):
    jcfg = dataclasses.replace(jax_smoke(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, TM.params_from_jax(jax.tree.map(np.asarray, jp))


def _batch(cfg, jcfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :3] = -100
    if cfg.input_mode == "embeds" and cfg.encoder_layers == 0:
        batch["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        del batch["tokens"]
    if cfg.encoder_layers > 0:
        batch["src_embeds"] = rng.standard_normal((b, s - 4, cfg.d_model)).astype(np.float32)
    if cfg.rope_kind == "mrope":
        batch["positions"] = np.array(JM.default_positions(jcfg, b, s))
    return batch


def _by_path(tree) -> dict:
    return {keystr(p): np.asarray(leaf) for p, leaf in tree_flatten_with_path(tree)[0]}


def _loss_and_grads(params, batch, cfg):
    """The port's loss and gradients (a tree like ``params``)."""
    tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = TM.train_loss(tracked, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, tree_leaves(tracked))
    return loss.item(), tree_unflatten(params, [g.numpy() for g in grads])


def _check(jcfg, jp, cfg, tp, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(lambda p: JM.train_loss(p, jb, jcfg)))(jp)
    tl, tg = _loss_and_grads(tp, batch, cfg)
    np.testing.assert_allclose(tl, float(jl), rtol=RTOL)
    got, want = _by_path(tg), _by_path(jg)
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].shape == w.shape and got[name].dtype == w.dtype, name
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
    return tl


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_loss_and_gradients_match_the_reference(arch):
    jcfg, jp, cfg, tp = _pair(arch)
    loss = _check(jcfg, jp, cfg, tp, _batch(cfg, jcfg, 2, 16))
    assert 0.9 * np.log(cfg.vocab) < loss < 1.1 * np.log(cfg.vocab)


def test_train_loss_over_two_512_token_chunks_matches_the_reference():
    jcfg, jp, cfg, tp = _pair("gemma-2b")
    batch = _batch(cfg, jcfg, 1, 1024, seed=1)
    batch["labels"][0, 500:530] = -100  # across the chunk boundary
    _check(jcfg, jp, cfg, tp, batch)


def test_rematerialisation_changes_no_value(monkeypatch):
    """The checkpointed repeats and loss chunks give the loss and gradients
    of a run that keeps every activation."""
    _, _, cfg, tp = _pair("jamba-v0.1-52b")
    batch = _batch(cfg, None, 2, 16)
    tl, tg = _loss_and_grads(tp, batch, cfg)
    calls = []
    monkeypatch.setattr(TM, "checkpoint",
                        lambda fn, *args, use_reentrant: calls.append(fn) or fn(*args))
    pl, pg = _loss_and_grads(tp, batch, cfg)
    assert len(calls) == cfg.n_repeats + 1  # every repeat and the one loss chunk
    assert tl == pl
    for a, b in zip(tree_leaves(tg), tree_leaves(pg)):
        np.testing.assert_array_equal(a, b)


def test_dots_remat_policy_saves_every_product_output_and_keeps_the_gradients():
    """Under ``"dots"`` each repeat's checkpoint gets a selective context
    whose policy saves ``mm`` / ``addmm`` outputs and recomputes the rest;
    the loss and gradients equal whole remat's and the reference's."""
    from torch.utils.checkpoint import CheckpointPolicy

    jcfg, jp, cfg, tp = _pair("yi-6b")
    batch = _batch(cfg, jcfg, 1, 8)
    kwargs = []
    real = TM.checkpoint
    lm_tp.set_remat_policy("dots")
    try:
        policy = lm_tp.checkpoint_kwargs()["context_fn"].args[0]
        assert policy(None, torch.ops.aten.mm.default) == CheckpointPolicy.MUST_SAVE
        assert policy(None, torch.ops.aten.addmm.default) == CheckpointPolicy.MUST_SAVE
        assert policy(None, torch.ops.aten.bmm.default) == CheckpointPolicy.PREFER_RECOMPUTE
        TM.checkpoint = lambda fn, *a, **kw: kwargs.append(kw) or real(fn, *a, **kw)
        _check(jcfg, jp, cfg, tp, batch)
    finally:
        TM.checkpoint = real
        lm_tp.set_remat_policy(None)
    assert sum("context_fn" in kw for kw in kwargs) == cfg.n_repeats  # the loss chunk keeps none
