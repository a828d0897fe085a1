"""The port's LM serving against the JAX package's, on the CPU.

``BatchedServer`` (per-slot ``cache_len``, plain-torch masked decode)
must generate the reference server's tokens on tests/test_serve_engine.py's
prompts (float32, greedy), and the tokens of a sequential prefill + decode
of each request (the host-integer decode route).  ``build_serving_caches``
must give identical token counts, hot rows and hit rates; Eq. 1 reads wall
time, so both packages' ``allocate_capacity`` are fed the same stage laps.
The synthetic ``TokenStream`` gives the same tokens for a seed.  The CLI
runs with ``--smoke --device cpu`` and raises without a card otherwise.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.core.allocation import allocate_capacity as jax_allocate
from repro.data.tokens import TokenStream as JaxTokenStream
from repro.data.tokens import batches as jax_batches
from repro.models.lm import model as JM
from repro.runtime import lm_cache as JC
from repro.runtime.serve_engine import BatchedServer as JaxServer
from repro_torch.configs import get_smoke
from repro_torch.core.allocation import allocate_capacity
from repro_torch.data.tokens import TokenStream, batches
from repro_torch.launch import serve
from repro_torch.models.lm import model as TM
from repro_torch.runtime import lm_cache as TC
from repro_torch.runtime.serve_engine import BatchedServer

torch.set_num_threads(1)


def _pair(arch, dtype="float32"):
    jcfg = dataclasses.replace(jax_smoke(arch), dtype=dtype)
    cfg = dataclasses.replace(get_smoke(arch), dtype=dtype)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, TM.params_from_jax(jax.tree.map(np.asarray, jp))


def sequential_generate(cfg, params, prompt, max_new, max_len):
    logits, caches = TM.prefill(params, {"tokens": torch.from_numpy(prompt[None, :])}, cfg,
                                cache_size=max_len)
    toks = [int(torch.argmax(logits[0, : cfg.vocab]))]
    pos = len(prompt)
    for _ in range(max_new - 1):
        logits, caches = TM.decode_step(params, torch.tensor([[toks[-1]]]), caches, pos, cfg)
        toks.append(int(torch.argmax(logits[0, : cfg.vocab])))
        pos += 1
    return toks


@pytest.mark.parametrize("arch", ["granite-3-8b", "gemma2-27b", "jamba-v0.1-52b", "rwkv6-3b",
                                  "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"])
def test_batched_server_generates_the_reference_tokens(arch):
    jcfg, jp, cfg, tp = _pair(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (5, 9, 13, 7, 11)]
    max_new, max_len = 6, 32
    got_server = BatchedServer(cfg, tp, slots=2, max_len=max_len)
    want_server = JaxServer(jcfg, jp, slots=2, max_len=max_len)
    for i, p in enumerate(prompts):
        got_server.submit(p, max_new, req_id=i)
        want_server.submit(p, max_new, req_id=i)
    got, want = got_server.run(), want_server.run()
    assert [r.req_id for r in got] == [r.req_id for r in want] == list(range(len(prompts)))
    for g, w, prompt in zip(got, want, prompts):
        assert g.generated == w.generated, (g.req_id, g.generated, w.generated)
        assert g.done and len(g.generated) == max_new
        assert g.generated == sequential_generate(cfg, tp, prompt, max_new, max_len)


def test_batched_server_stops_at_max_len_like_the_reference():
    jcfg, jp, cfg, tp = _pair("gemma-2b")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, 12).astype(np.int32)
    got_server = BatchedServer(cfg, tp, slots=3, max_len=16)
    want_server = JaxServer(jcfg, jp, slots=3, max_len=16)
    for s in (got_server, want_server):
        s.submit(prompt, 10, req_id=0)
        s.submit(prompt[:4], 3, req_id=1)
    got, want = got_server.run(), want_server.run()
    assert [r.generated for r in got] == [r.generated for r in want]
    assert len(got[0].generated) < 10  # cut at max_len - 1


def test_server_rejects_embeds_and_encoder_archs():
    for arch in ("qwen2-vl-2b", "seamless-m4t-medium"):
        with pytest.raises(ValueError):
            BatchedServer(get_smoke(arch), params=None)


def test_serving_caches_match_the_reference():
    jcfg, jp, cfg, tp = _pair("gemma-2b")
    stream = TokenStream(vocab=cfg.vocab, seed=1)
    rng = np.random.default_rng(2)
    prompts = stream.sample(rng, 4, 24)
    sample = stream.sample(rng, 8, 24)
    for budget in (0, 10_000, 120_000, 10**9):
        got = TC.build_serving_caches(cfg, tp, sample, total_cache_bytes=budget)
        want = JC.build_serving_caches(jcfg, jp, sample, total_cache_bytes=budget)
        np.testing.assert_array_equal(got.token_counts, want.token_counts)
        np.testing.assert_array_equal(got.embed_cache.position_np(),
                                      np.asarray(want.embed_cache.position_map))
        np.testing.assert_array_equal(got.embed_cache.hot_table.numpy(),
                                      np.asarray(want.embed_cache.hot_table))
        assert got.embed_cache.num_cached == want.embed_cache.num_cached
        # Dense: Eq. 1 gives the whole budget to the embeddings.
        assert dataclasses.astuple(got.allocation) == dataclasses.astuple(want.allocation)
        assert got.hot_experts is None and want.hot_experts is None
        for toks in (prompts, sample):
            assert got.embed_hit_rate(toks) == want.embed_hit_rate(toks)
        assert got.expert_hit_rate(np.zeros(3, np.int32)) == want.expert_hit_rate(np.zeros(3))
    # Eq. 1 on one set of laps, both packages.
    _, _, _, t_embed, t_expert = TC.profile_and_allocate(cfg, tp, sample, total_cache_bytes=10**6)
    assert len(t_embed) == len(sample) and not any(t_expert)
    laps = ([0.3, 0.1, 0.2], [0.05, 0.4, 0.1])
    for lap_pair in (laps, (t_expert, t_embed)):
        assert dataclasses.astuple(allocate_capacity(*lap_pair, 10**6)) == dataclasses.astuple(
            jax_allocate(*lap_pair, 10**6))


class _Clock:
    """A ``time`` stand-in whose ``perf_counter`` steps by 1, 2, 3, ...
    ms: each package's profile makes the same calls in the same order, so
    both read the same stage laps."""

    def __init__(self):
        self.now, self.step = 0.0, 0.0

    def perf_counter(self):
        self.step += 1e-3
        self.now += self.step
        return self.now


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b", "jamba-v0.1-52b"])
def test_moe_serving_caches_match_the_reference(arch, monkeypatch):
    """The expert stage of Eq. 1 with the stage laps pinned: the same
    split, token and expert counts, hot rows, hot experts (above-mean fill
    with its stable tie order, cut or topped up to the budget), bytes per
    expert and hit rates as the reference."""
    jcfg, jp, cfg, tp = _pair(arch)
    stream = TokenStream(vocab=cfg.vocab, seed=1)
    rng = np.random.default_rng(2)
    prompts = stream.sample(rng, 4, 24)
    sample = stream.sample(rng, 8, 24)
    per_expert = JC._expert_param_bytes(jcfg) // jcfg.moe.n_experts
    hot_sizes = set()
    for experts in (0, 1, 2, 3, 100):
        budget = 2 * experts * per_expert + 50_000
        monkeypatch.setattr(TC, "time", _Clock())
        monkeypatch.setattr(JC, "time", _Clock())
        got = TC.build_serving_caches(cfg, tp, sample, total_cache_bytes=budget)
        want = JC.build_serving_caches(jcfg, jp, sample, total_cache_bytes=budget)
        assert dataclasses.astuple(got.allocation) == dataclasses.astuple(want.allocation)
        np.testing.assert_array_equal(got.token_counts, want.token_counts)
        np.testing.assert_array_equal(got.expert_counts, want.expert_counts)
        np.testing.assert_array_equal(got.embed_cache.position_np(),
                                      np.asarray(want.embed_cache.position_map))
        np.testing.assert_array_equal(got.hot_experts, want.hot_experts)
        assert got.hot_experts.dtype == np.int32
        assert got.expert_bytes_each == want.expert_bytes_each == per_expert
        hot_sizes.add(len(got.hot_experts))
        for ids in (np.arange(cfg.moe.n_experts), np.array([[0, 1], [1, 1], [3, 0]]),
                    TC.router_top_k(cfg, tp, prompts)):
            assert got.expert_hit_rate(ids) == want.expert_hit_rate(ids)
        for toks in (prompts, sample):
            assert got.embed_hit_rate(toks) == want.embed_hit_rate(toks)
    assert len(hot_sizes) >= 3  # empty, cut to the budget, and every expert
    # The live prompts' router top-k is the profile's selection rule.
    rows = jp["embed"][jnp.asarray(prompts)].astype(jnp.float32)
    router = [b for b in jp["blocks"] if "moe" in b][0]["moe"]["router"][0]
    want_top = np.asarray(jax.lax.top_k(rows @ router, jcfg.moe.top_k)[1])
    np.testing.assert_array_equal(np.sort(TC.router_top_k(cfg, tp, prompts), -1),
                                  np.sort(want_top, -1))


def test_token_stream_gives_the_reference_tokens():
    for vocab, seed in ((512, 1), (49155, 3)):
        got = TokenStream(vocab=vocab, seed=seed).sample(np.random.default_rng(seed + 1), 3, 40)
        want = JaxTokenStream(vocab=vocab, seed=seed).sample(np.random.default_rng(seed + 1), 3, 40)
        np.testing.assert_array_equal(got, want)
    for g, w in zip(batches(TokenStream(vocab=300), batch=2, seq=8, steps=2, seed=4),
                    jax_batches(JaxTokenStream(vocab=300), batch=2, seq=8, steps=2, seed=4)):
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(g[key], w[key])


def test_cli_runs_on_the_cpu_at_smoke_size(capsys):
    out = serve.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--requests", "3",
                      "--prompt-len", "16", "--gen-len", "5", "--cache-mb", "0.1"])
    printed = capsys.readouterr().out
    assert "[dci] Eq.1 split" in printed and "[serve] 3 reqs" in printed
    assert out["device"] == "cpu" and out["tokens"].shape == (3, 5)
    assert out["embed_rows"] == int(0.1e6) // (128 * 4)  # 195 fp32 rows of d_model 128
    assert 0.0 < out["prompt_hit_rate"] <= 1.0 and out["decode_tok_s"] > 0
    # The CLI's greedy tokens are its prefill + host-integer decode.
    cfg = get_smoke("gemma-2b")
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    stream = TokenStream(vocab=cfg.vocab, seed=1)
    prompts = stream.sample(np.random.default_rng(2), 3, 16)
    for i, prompt in enumerate(prompts):
        assert list(out["tokens"][i]) == sequential_generate(cfg, params, prompt, 5, 21)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-3b"])
def test_cli_runs_the_moe_and_ssm_archs_on_the_cpu(arch, capsys):
    """Jamba (Mamba + attention + MoE: the expert cache takes its Eq. 1
    share) and RWKV-6 (attention-free, dense: no expert stage) through the
    CLI; greedy tokens equal to a sequential prefill + decode."""
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "2",
                      "--prompt-len", "12", "--gen-len", "4", "--cache-mb", "0.2"])
    printed = capsys.readouterr().out
    assert "[serve] 2 reqs" in printed and out["tokens"].shape == (2, 4)
    assert out["layers"] == 2
    cut = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--layers",
                      str(len(get_smoke(arch).block_pattern)), "--requests", "1",
                      "--prompt-len", "8", "--gen-len", "2"])
    assert cut["layers"] == len(get_smoke(arch).block_pattern)
    cfg = get_smoke(arch)
    if cfg.moe is None:
        assert out["hot_experts"] is None and out["expert_bytes_each"] == 0
        assert out["adj_bytes"] == 0 and out["prompt_expert_hit_rate"] is None
    else:
        assert "expert hit rate on live prompts" in printed
        assert out["adj_bytes"] > 0 and out["expert_bytes_each"] == 3 * 128 * 256 * 2 * 2 // 2 // 4
        assert len(out["hot_experts"]) == min(out["adj_bytes"] // out["expert_bytes_each"], 4)
        assert 0.0 <= out["prompt_expert_hit_rate"] <= 1.0
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    prompts = TokenStream(vocab=cfg.vocab, seed=1).sample(np.random.default_rng(2), 2, 12)
    for i, prompt in enumerate(prompts):
        assert list(out["tokens"][i]) == sequential_generate(cfg, params, prompt, 4, 16)


def test_cli_rejects_embeds_archs_and_raises_without_a_card(monkeypatch):
    for arch in ("qwen2-vl-2b", "seamless-m4t-medium"):
        with pytest.raises(SystemExit):
            serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "gemma-2b", "--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_params(get_smoke("gemma-2b"), generator=torch.Generator())


def test_serving_imports_leave_jax_out():
    code = ("import sys, repro_torch.launch.serve, repro_torch.runtime.serve_engine; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         timeout=120)
    assert out.stdout.strip() == "[]"
