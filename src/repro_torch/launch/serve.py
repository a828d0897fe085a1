"""Serving CLI: batched prefill + decode with the DCI serving caches.

``python -m repro_torch.launch.serve --arch gemma-2b --smoke --requests 16``
runs: build model → profile a request sample → Eq.1-allocate the dual
cache (hot embeddings / hot experts) → prefill the batch → decode N tokens,
reporting tokens/s and cache hit rates.  It runs on the card unless
``--device cpu`` is given (and raises without a card otherwise); on the
card the prefill and decode times end in ``torch.cuda.synchronize()``.
Every prefill and every decode step runs its attention through the
flash-attention kernel there.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models.lm.model import decode_step, init_params, prefill
from repro_torch.runtime.lm_cache import build_serving_caches


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--cache-mb", type=float, default=4.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.encoder_layers > 0 or cfg.input_mode == "embeds":
        raise SystemExit("the serve CLI targets decoder-only token archs")
    params = init_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                         device=device)

    stream = TokenStream(vocab=cfg.vocab, seed=1)
    rng = np.random.default_rng(2)
    prompts = stream.sample(rng, args.requests, args.prompt_len)

    # ---- DCI: profile + allocate + fill the serving dual cache ----------
    sample = stream.sample(rng, 8, args.prompt_len)
    caches_dci = build_serving_caches(
        cfg, params, sample, total_cache_bytes=int(args.cache_mb * 1e6)
    )
    a = caches_dci.allocation
    print(
        f"[dci] Eq.1 split: embed {a.feat_bytes/1e6:.2f} MB "
        f"({caches_dci.embed_cache.num_cached} rows), "
        f"expert {a.adj_bytes/1e6:.2f} MB "
        f"({0 if caches_dci.hot_experts is None else len(caches_dci.hot_experts)} experts)"
    )
    prompt_hit = caches_dci.embed_hit_rate(prompts)
    print(f"[dci] embed hit rate on live prompts: {prompt_hit:.3f}")

    # ---- batched prefill + decode ---------------------------------------
    cache_size = args.prompt_len + args.gen_len
    toks = torch.as_tensor(prompts, device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits, kv = prefill(params, {"tokens": toks}, cfg, cache_size=cache_size)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out_tokens = [torch.argmax(logits, -1)[:, None].int()]
    t0 = time.perf_counter()
    for i in range(args.gen_len - 1):
        logits, kv = decode_step(params, out_tokens[-1], kv, args.prompt_len + i, cfg)
        out_tokens.append(torch.argmax(logits, -1)[:, None].int())
    _sync(device)
    t_decode = time.perf_counter() - t0

    gen = torch.cat(out_tokens, dim=1).cpu().numpy()
    tput = args.requests * (args.gen_len - 1) / max(t_decode, 1e-9)
    gen_hit = caches_dci.embed_hit_rate(gen)
    print(
        f"[serve] {args.requests} reqs: prefill {t_prefill:.2f}s, "
        f"decode {t_decode:.2f}s ({tput:.1f} tok/s), gen hit rate "
        f"{gen_hit:.3f}"
    )
    return {
        "arch": cfg.arch_id, "device": str(device), "embed_rows": caches_dci.embed_cache.num_cached,
        "feat_bytes": a.feat_bytes, "adj_bytes": a.adj_bytes, "prompt_hit_rate": prompt_hit,
        "prefill_s": t_prefill, "decode_s": t_decode, "decode_tok_s": tput,
        "gen_hit_rate": gen_hit, "tokens": gen,
    }


if __name__ == "__main__":
    main()
