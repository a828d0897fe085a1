"""The port's LM layers against the JAX package's, on the CPU.

Inputs and weights are numpy arrays made from a seed and go through both
packages; every comparison is float32 at atol = rtol = 1e-4.  On the CPU
the port's attention is its plain fp32 route (``attention._attend``), the
port of the reference's ``_chunked_scores_softmax``; decode with one host
``cache_len`` attends over the ring slots ``_ring_slots`` keeps, which
must be exactly the slots of the reference's ``_ring_mask``.  The CUDA
route (the flash-attention kernel) is held to this one on the card by
tests/test_torch_kernels_gpu.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models.lm import attention as J
from repro.models.lm import blocks as JB
from repro.models.lm import moe as JMoE
from repro.models.lm.norms import rms_norm as jax_rms_norm
from repro.models.lm.rope import apply_rope as jax_apply_rope
from repro.models.lm.rope import rope_angles as jax_rope_angles
from repro_torch.configs import get_smoke
from repro_torch.models.lm import attention as T
from repro_torch.models.lm import blocks as TB
from repro_torch.models.lm import moe as TMoE
from repro_torch.models.lm import tp
from repro_torch.models.lm.norms import rms_norm
from repro_torch.models.lm.rope import apply_rope, rope_angles

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)


def _tree(rng, shapes: dict, scale=0.2) -> dict:
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}


def _both(params_np: dict):
    """The same numpy tree as JAX arrays and as torch tensors."""
    def conv(fn, tree):
        return {k: conv(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}
    return conv(jnp.asarray, params_np), conv(torch.from_numpy, params_np)


def _gqa_params(rng, cfg):
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return _tree(rng, {"wq": (d, h * dh), "wk": (d, hkv * dh), "wv": (d, hkv * dh),
                       "wo": (h * dh, d)}, scale=d ** -0.5)


# ------------------------------------------------------------ leaves


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    scale = rng.standard_normal(48).astype(np.float32)
    got = rms_norm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x).to(getattr(torch, dtype)))
    want = jax_rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x).astype(dtype))
    assert got.dtype == getattr(torch, dtype)
    # bf16: the same fp32 math rounded once to bf16 (one ulp at |y| < 16).
    _close(got.float(), want, TOL if dtype == "float32" else dict(atol=0.07, rtol=1e-2))


@pytest.mark.parametrize("kind,sections", [("default", (4, 6, 6)), ("mrope", (4, 6, 6)),
                                           ("mrope", (2, 7, 7))])
def test_rope_matches_reference(kind, sections):
    rng = np.random.default_rng(1)
    b, s, h, d = 2, 9, 3, 32
    if kind == "default":
        pos = rng.integers(0, 3000, (b, s)).astype(np.int32)
    else:
        pos = rng.integers(0, 3000, (b, s, 3)).astype(np.int32)
    x = rng.standard_normal((b, s, h, d)).astype(np.float32)
    cos, sin = rope_angles(torch.from_numpy(pos), d, 10_000.0, kind, sections)
    jcos, jsin = jax_rope_angles(jnp.asarray(pos), d, 10_000.0, kind, sections)
    # Angles reach 3000 rad: an ulp of the fp32 frequency moves them ~2e-4.
    _close(cos, jcos, dict(atol=5e-4, rtol=0))
    _close(sin, jsin, dict(atol=5e-4, rtol=0))
    # The rotation itself on the same angles.
    _close(apply_rope(torch.from_numpy(x), cos, sin),
           jax_apply_rope(jnp.asarray(x), jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())))
    # Half-split, not interleaved: position 0 is the identity, and the
    # first half pairs with the second.
    c0, s0 = rope_angles(torch.zeros((1, 1) if kind == "default" else (1, 1, 3), dtype=torch.int32),
                         d, 10_000.0, kind, sections)
    assert torch.equal(apply_rope(torch.from_numpy(x[:1, :1]), c0, s0), torch.from_numpy(x[:1, :1]))


def test_rope_small_positions_match_reference_tightly():
    pos = np.arange(40, dtype=np.int32).reshape(2, 20)
    cos, sin = rope_angles(torch.from_numpy(pos), 64, 5_000_000.0, "default", (16, 24, 24))
    jcos, jsin = jax_rope_angles(jnp.asarray(pos), 64, 5_000_000.0, "default", (16, 24, 24))
    _close(cos, jcos)
    _close(sin, jsin)


@pytest.mark.parametrize("activation", ["geglu", "silu", "gelu"])
def test_dense_ffn_matches_reference(activation):
    rng = np.random.default_rng(2)
    d, ff = 32, 80
    shapes = {"w1": (d, ff), "w2": (ff, d)}
    if activation != "gelu":
        shapes["w3"] = (d, ff)
    jp, tp_ = _both(_tree(rng, shapes, scale=0.4))
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    _close(TMoE.dense_ffn(tp_, torch.from_numpy(x), activation),
           JMoE.dense_ffn(jp, jnp.asarray(x), activation))


@pytest.mark.parametrize("model", [1, 4])
def test_row_parallel_psum_goes_by_the_model_axis_size(model):
    """A model axis of 1: the psum is the identity on real tensors.  Larger:
    on meta tensors the product runs in its global view and one all-reduce
    of the per-device operand [T_local, D] in h's dtype is recorded (T_local
    over the 2 data shards); on real tensors it raises."""
    from repro_torch.analysis.counts import count_step
    from repro_torch.launch.mesh import AbstractMesh

    mesh = AbstractMesh(("data", "model"), (2, model))
    x, w = torch.randn(4, 3, 8), torch.randn(8, 5)
    tp.set_tp_context(mesh, "model")
    try:
        if model == 1:
            assert torch.equal(tp.maybe_row_parallel(x, w), x @ w)
        else:
            with pytest.raises(RuntimeError, match="cards"):
                tp.maybe_row_parallel(x, w)
        xm, wm = x.to("meta").bfloat16(), w.to("meta").bfloat16()
        out, counts = count_step(tp.maybe_row_parallel, xm, wm)
    finally:
        tp.set_tp_context(None)
    assert out.shape == (4, 3, 5) and out.device.type == "meta"
    assert counts.flops == 2 * 4 * 3 * 8 * 5
    want = {} if model == 1 else {"all-reduce": 4 // 2 * 3 * 5 * 2}
    assert {k: v for k, v in counts.collective_bytes.items() if v} == want
    assert counts.collective_counts["all-reduce"] == (0 if model == 1 else 1)


def test_switches_set_and_reset():
    """``maybe_barrier`` stays the identity under ``bf16_psum`` (torch has no
    compiler to pin); an unknown remat policy is refused."""
    x = torch.randn(3, 4)
    tp.set_bf16_barrier(True)
    tp.set_remat_policy("dots")
    tp.set_rwkv_chunked(True)
    try:
        assert tp.maybe_barrier(x) is x
        assert tp.remat_policy() == "dots" and tp.rwkv_chunked()
        assert "context_fn" in tp.checkpoint_kwargs()
        with pytest.raises(ValueError, match="remat policy"):
            tp.set_remat_policy("everything")
    finally:
        tp.set_bf16_barrier(False)
        tp.set_remat_policy(None)
        tp.set_rwkv_chunked(False)
    assert tp.remat_policy() is None and not tp.rwkv_chunked() and tp.checkpoint_kwargs() == {}


# --------------------------------------------------------------- GQA


GQA_CASES = [  # arch, window, softcap
    ("granite-3-8b", None, None),
    ("gemma2-27b", 5, 50.0),
    ("gemma-2b", None, None),
    ("yi-6b", 3, None),
]


@pytest.mark.parametrize("arch,window,softcap", GQA_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_prefill_matches_reference(arch, window, softcap, causal):
    cfg = dataclasses.replace(_f32(get_smoke(arch)), attn_softcap=softcap)
    jcfg = dataclasses.replace(_f32(jax_smoke(arch)), attn_softcap=softcap)
    rng = np.random.default_rng(3)
    jp, tp_ = _both(_gqa_params(rng, cfg))
    b, s = 2, 11
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    out, cache = T.gqa_prefill(tp_, torch.from_numpy(x), torch.from_numpy(pos), cfg,
                               window=window, causal=causal)
    jout, jcache = J.gqa_prefill(jp, jnp.asarray(x), jnp.asarray(pos), jcfg, window=window,
                                 causal=causal)
    _close(out, jout)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


def test_chunked_scores_softmax_chunks_like_the_reference():
    """S = 1024 takes two 512-row chunks, with a q offset and a short kv."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 1024, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 1100, 2, 16)).astype(np.float32) for _ in range(2))
    kw = dict(q_offset=60, kv_valid_len=1050, window=300, softcap=30.0, causal=True, n_rep=2)
    _close(T._chunked_scores_softmax(*(torch.from_numpy(a) for a in (q, k, v)), **kw),
           J._chunked_scores_softmax(*(jnp.asarray(a) for a in (q, k, v)), **kw))


@pytest.mark.parametrize("sc", [1, 2, 5, 8, 13])
@pytest.mark.parametrize("window", [None, 1, 3, 8, 20])
def test_ring_slots_are_the_ring_mask(sc, window):
    """The host-integer route's kept slots equal ``_ring_mask`` (and the
    reference's) at every position, unwrapped and wrapped."""
    lens = np.arange(0, 3 * sc + 4, dtype=np.int32)
    want = np.asarray(J._ring_mask(jnp.asarray(lens), sc, window))
    got = T._ring_mask(torch.from_numpy(lens).long(), sc, window).numpy()
    np.testing.assert_array_equal(got, want)
    for i, cl in enumerate(lens):
        kept = np.zeros(sc, bool)
        for a, e in T._ring_slots(int(cl), sc, window):
            assert 0 <= a < e <= sc and not kept[a:e].any()
            kept[a:e] = True
        np.testing.assert_array_equal(kept, want[i], err_msg=f"cache_len {cl}")


@pytest.mark.parametrize("arch,window,softcap", GQA_CASES)
@pytest.mark.parametrize("per_slot", [False, True])
def test_gqa_decode_matches_reference(arch, window, softcap, per_slot):
    """Decode from a filled ring at positions before, at and past the
    wrap; one host integer (the kernel route) or a per-slot vector."""
    cfg = dataclasses.replace(_f32(get_smoke(arch)), attn_softcap=softcap)
    jcfg = dataclasses.replace(_f32(jax_smoke(arch)), attn_softcap=softcap)
    rng = np.random.default_rng(5)
    jp, tp_ = _both(_gqa_params(rng, cfg))
    b, sc = 3, 8
    shape = (b, sc, cfg.n_kv_heads, cfg.head_dim)
    ck, cv = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    for cl in (0, 4, 7, 8, 12, 21):
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        lens = np.array([cl, cl + 3, max(cl - 2, 0)], np.int32) if per_slot else cl
        tl = torch.from_numpy(lens) if per_slot else cl
        out, cache = T.gqa_decode(tp_, torch.from_numpy(x), {"k": torch.from_numpy(ck),
                                  "v": torch.from_numpy(cv)}, tl, cfg, window=window)
        jout, jcache = J.gqa_decode(jp, jnp.asarray(x), {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                                    jnp.asarray(lens, jnp.int32), jcfg, window=window)
        _close(out, jout)
        _close(cache["k"], jcache["k"])
        _close(cache["v"], jcache["v"])
        assert not np.shares_memory(cache["k"].numpy(), ck)  # functional update


# --------------------------------------------------------------- MLA


def _mla_setup(rng):
    cfg = _f32(get_smoke("deepseek-v2-236b"))
    jcfg = _f32(jax_smoke("deepseek-v2-236b"))
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    params = _tree(rng, {
        "w_dq": (d, m.q_lora_rank), "w_uq": (m.q_lora_rank, h * (m.nope_head_dim + m.rope_head_dim)),
        "w_dkv": (d, m.kv_lora_rank), "w_kr": (d, m.rope_head_dim),
        "w_uk": (m.kv_lora_rank, h * m.nope_head_dim), "w_uv": (m.kv_lora_rank, h * m.v_head_dim),
        "wo": (h * m.v_head_dim, d)}, scale=0.15)
    params["q_norm"] = {"scale": np.ones(m.q_lora_rank, np.float32)}
    params["kv_norm"] = {"scale": np.ones(m.kv_lora_rank, np.float32)}
    jp, tp_ = _both(params)
    return cfg, jcfg, jp, tp_


@pytest.mark.parametrize("window", [None, 4])
def test_mla_prefill_matches_reference(window):
    rng = np.random.default_rng(6)
    cfg, jcfg, jp, tp_ = _mla_setup(rng)
    b, s = 2, 9
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    out, cache = T.mla_prefill(tp_, torch.from_numpy(x), torch.from_numpy(pos), cfg, window=window)
    jout, jcache = J.mla_prefill(jp, jnp.asarray(x), jnp.asarray(pos), jcfg, window=window)
    _close(out, jout)
    for key in ("c_kv", "k_rope"):
        _close(cache[key], jcache[key])


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("per_slot", [False, True])
def test_mla_decode_matches_reference(absorb, per_slot):
    rng = np.random.default_rng(7)
    cfg, jcfg, jp, tp_ = _mla_setup(rng)
    b, sc, m = 2, 6, cfg.mla
    c_kv = rng.standard_normal((b, sc, m.kv_lora_rank)).astype(np.float32)
    k_rope = rng.standard_normal((b, sc, m.rope_head_dim)).astype(np.float32)
    for cl in (2, 5, 9):
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        lens = np.array([cl, cl + 1], np.int32) if per_slot else cl
        out, cache = T.mla_decode(tp_, torch.from_numpy(x), {"c_kv": torch.from_numpy(c_kv),
                                  "k_rope": torch.from_numpy(k_rope)},
                                  torch.from_numpy(lens) if per_slot else cl, cfg, window=None,
                                  absorb=absorb)
        jout, jcache = J.mla_decode(jp, jnp.asarray(x), {"c_kv": jnp.asarray(c_kv),
                                    "k_rope": jnp.asarray(k_rope)}, jnp.asarray(lens, jnp.int32),
                                    jcfg, window=None, absorb=absorb)
        _close(out, jout)
        for key in ("c_kv", "k_rope"):
            _close(cache[key], jcache[key])


def test_cross_attention_matches_reference():
    cfg = _f32(get_smoke("gemma2-27b"))
    jcfg = _f32(jax_smoke("gemma2-27b"))
    rng = np.random.default_rng(8)
    jp, tp_ = _both(_gqa_params(rng, cfg))
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    kv = T.encode_cross_kv(tp_, torch.from_numpy(enc), cfg)
    jkv = J.encode_cross_kv(jp, jnp.asarray(enc), jcfg)
    _close(kv["k"], jkv["k"])
    _close(T.cross_attention(tp_, torch.from_numpy(x), kv, cfg),
           J.cross_attention(jp, jnp.asarray(x), jkv, jcfg))


# ------------------------------------------------------------ blocks


@pytest.mark.parametrize("s,cache_size", [(5, 8), (8, 8), (13, 8), (13, 1)])
def test_ring_from_full_matches_reference(s, cache_size):
    full = np.random.default_rng(9).standard_normal((2, s, 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(TB._ring_from_full(torch.from_numpy(full), cache_size).numpy(),
                                  np.asarray(JB._ring_from_full(jnp.asarray(full), cache_size)))


@pytest.mark.parametrize("kind,long_mode", [("attn", False), ("local", False), ("attn", True),
                                            ("mamba", False), ("rwkv", False)])
def test_window_for_and_cache_shapes_match_reference(kind, long_mode):
    """Every arch whose pattern has ``kind`` (Gemma-2 27B, Phi-3.5-MoE,
    DeepSeek-V2's MLA, Jamba, RWKV-6): window, and the cache's layout,
    shapes and dtypes (a bfloat16 model's SSM states are float32), zeros."""
    for arch in ("gemma2-27b", "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b", "jamba-v0.1-52b",
                 "rwkv6-3b"):
        cfg, jcfg = get_smoke(arch), jax_smoke(arch)
        if kind not in cfg.block_pattern:
            continue
        pos = cfg.block_pattern.index(kind)
        assert TB.window_for(kind, cfg, long_mode) == JB.window_for(kind, jcfg, long_mode)
        for cache_size, enc_len in ((4, 5), (40, 5), (40, None)):
            got = TB.init_block_cache(cfg, pos, 3, cache_size, torch.bfloat16,
                                      long_mode=long_mode, enc_len=enc_len)
            want = JB.init_block_cache(jcfg, pos, 3, cache_size, jnp.bfloat16,
                                       long_mode=long_mode, enc_len=enc_len)
            assert jax.tree.structure(got) == jax.tree.structure(want), arch
            for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                assert tuple(g.shape) == w.shape and str(g.dtype) == f"torch.{w.dtype}", arch
                assert not g.any()


def test_an_unknown_block_kind_raises():
    cfg = dataclasses.replace(get_smoke("gemma-2b"), block_pattern=("conv",))
    with pytest.raises(ValueError, match="conv"):
        TB.init_block_params(torch.Generator(), cfg, 0, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="conv"):
        TB.init_block_cache(cfg, 0, 1, 8, torch.float32, long_mode=False)
