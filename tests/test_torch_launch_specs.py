"""The dry-run's abstract inputs: meta tensors with the reference's shapes
and dtypes, and caches that match what ``prefill`` returns.

For every arch and input shape the port's abstract train, prefill and
decode inputs equal the reference's ``ShapeDtypeStruct``s leaf for leaf
(full configs; nothing is allocated, every leaf is on ``"meta"``).  As in
the reference's tests/test_launch_specs.py, the abstract caches match the
caches the port's ``prefill`` returns (run on meta) for all ten archs,
and ``decode_step`` accepts them.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.tree_util import DictKey

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as jax_config
from repro.launch import specs as JS
from repro.models.lm import model as JM
from repro.optim.adamw import init_adamw as jax_init_adamw
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, get_smoke
from repro_torch.launch import specs as TS
from repro_torch.models.lm import model as TM
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

B, S = 2, 16


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return JM.abstract_params(jax_config(arch))


def _same(got, want):
    """Leaf for leaf by path (the reference's leaves as ShapeDtypeStructs;
    JAX orders dict keys, the port keeps insertion order)."""
    want_by_path = {
        tuple(k.key if isinstance(k, DictKey) else k.idx for k in path): w
        for path, w in jax.tree_util.tree_leaves_with_path(want)}
    got_by_path = dict(tree_leaves_with_path(got))
    assert got_by_path.keys() == want_by_path.keys()
    for path, g in got_by_path.items():
        w = want_by_path[path]
        assert g.device.type == "meta"
        assert tuple(g.shape) == w.shape and str(g.dtype) == f"torch.{w.dtype}", (path, g, w)


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_inputs_equal_the_reference(arch, shape):
    cfg, jcfg, sh = get_config(arch), jax_config(arch), INPUT_SHAPES[shape]
    jparams = _ref_params(arch)
    if sh.kind == "train":
        params, opt, batch = TS.abstract_train_inputs(cfg, sh)
        _same(opt, jax.eval_shape(jax_init_adamw, jparams))
        _same(batch, JS._batch_dict(jcfg, sh.global_batch, sh.seq_len, labels=True))
    elif sh.kind == "prefill":
        params, batch = TS.abstract_prefill_inputs(cfg, sh)
        _same(batch, JS._batch_dict(jcfg, sh.global_batch, sh.seq_len, labels=False))
    else:
        long_mode = shape == "long_500k"
        params, tokens, caches, cache_len = TS.abstract_decode_inputs(cfg, sh, long_mode=long_mode)
        _same([tokens, cache_len], [jax.ShapeDtypeStruct((sh.global_batch, 1), jnp.int32),
                                    jax.ShapeDtypeStruct((), jnp.int32)])
        _same(caches, JS.abstract_caches(jcfg, sh.global_batch, sh.seq_len, long_mode=long_mode))
    _same(params, jparams)
    assert J_SHAPES[shape].__dict__ == sh.__dict__


def _prefill_batch(cfg):
    if cfg.encoder_layers > 0:
        return {"src_embeds": torch.zeros((B, S, cfg.d_model), device="meta"),
                "tokens": torch.zeros((B, S), dtype=torch.int32, device="meta")}
    if cfg.input_mode == "embeds":
        return {"embeds": torch.zeros((B, S, cfg.d_model), device="meta")}
    return {"tokens": torch.zeros((B, S), dtype=torch.int32, device="meta")}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_caches_match_prefill_and_decode_accepts_them(arch, monkeypatch):
    """Structure, shapes and dtypes of the caches ``prefill`` returns (on
    meta, the enc-dec's encoder length aligned) equal ``abstract_caches``;
    ``decode_step`` takes those and returns the same tree."""
    cfg = get_smoke(arch)
    params = TM.abstract_params(cfg)
    _, caches = TM.prefill(params, _prefill_batch(cfg), cfg, cache_size=S)
    monkeypatch.setattr(TS, "DECODE_ENC_LEN", S)
    abstract = TS.abstract_caches(cfg, B, S, long_mode=False)
    assert [p for p, _ in tree_leaves_with_path(caches)] == [
        p for p, _ in tree_leaves_with_path(abstract)]
    for got, want in zip(tree_leaves(caches), tree_leaves(abstract)):
        assert got.shape == want.shape and got.dtype == want.dtype, (arch, got, want)
    tokens = torch.zeros((B, 1), dtype=torch.int32, device="meta")
    logits, new = TM.decode_step(params, tokens, abstract, S - 1, cfg)
    assert logits.shape == (B, cfg.vocab_padded)
    assert [p for p, _ in tree_leaves_with_path(new)] == [
        p for p, _ in tree_leaves_with_path(abstract)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_allocate_nothing_and_draw_nothing(arch):
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    params = TM.init_params(get_config(arch), generator=gen, device="meta")
    assert all(t.device.type == "meta" for t in tree_leaves(params))
    assert torch.equal(gen.get_state(), state)
    _same(params, _ref_params(arch))


def test_gemma_2b_parameter_bytes():
    params = TM.abstract_params(get_config("gemma-2b"))
    assert sum(t.numel() * t.element_size() for t in tree_leaves(params)) == 5_012_496_384


def test_cpu_init_draws_as_before():
    """Meta aside, init is unchanged: the first leaf (``embed``) is the
    generator's first draw, and one seed gives the same tree."""
    cfg = get_smoke("gemma-2b")
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    first = torch.randn((cfg.vocab_padded, cfg.d_model), generator=torch.Generator().manual_seed(0))
    assert torch.equal(params["embed"], (first * 0.02).to(params["embed"].dtype))
    again = TM.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(again)))
    with pytest.raises(ValueError, match="unsupported device"):
        TM.resolve_device("meta")


def test_concrete_from_abstract_is_seeded():
    params, batch = TS.abstract_prefill_inputs(get_smoke("yi-6b"), INPUT_SHAPES["prefill_32k"]
                                               .__class__("smoke", S, B, "prefill"))
    tree = {"params": params, "batch": batch}
    a = TS.concrete_from_abstract(tree, seed=1, device="cpu")
    b = TS.concrete_from_abstract(tree, seed=1, device="cpu")
    for x, y, m in zip(tree_leaves(a), tree_leaves(b), tree_leaves(tree)):
        assert x.device.type == "cpu" and x.shape == m.shape and x.dtype == m.dtype
        assert torch.equal(x, y)
    assert set(torch.unique(a["batch"]["tokens"]).tolist()) <= {0, 1}
