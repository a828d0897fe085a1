"""Block assembly: norm → mixer → residual → norm → FFN/MoE → residual.

A block's *kind* (one entry of ``cfg.block_pattern``) picks the mixer:
``attn`` (full causal GQA/MLA), ``local`` (sliding window), ``mamba``,
``rwkv`` (whose channel-mix replaces the FFN).  MoE replaces the dense FFN
at positions where ``cfg.is_moe_position`` holds.  Decoder blocks of an
encoder-decoder additionally carry cross-attention after self-attention.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import mamba as mamba_mod
from repro_torch.models.lm import rwkv6 as rwkv_mod
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.moe import dense_ffn, init_dense_ffn, init_moe_params, moe_ffn
from repro_torch.models.lm.norms import init_rms_norm, rms_norm
from repro_torch.models.lm.tp import maybe_barrier, rwkv_chunked
from repro_torch.utils.tree import tree_map

__all__ = ["init_block_params", "block_prefill", "block_decode", "window_for", "init_block_cache"]


def window_for(kind: str, cfg: LMConfig, long_mode: bool) -> int | None:
    if kind == "local":
        return cfg.window
    if kind == "attn" and long_mode:
        return cfg.long_context_window  # dense long-context carve-in
    return None


def init_block_params(
    generator: torch.Generator, cfg: LMConfig, pos: int, dtype, *, cross: bool = False, device
) -> dict:
    kind = cfg.block_pattern[pos]
    p: dict = {"ln1": init_rms_norm(cfg.d_model, device=device)}
    if kind in ("attn", "local"):
        if cfg.attn_kind == "mla":
            p["mla"] = attn.init_mla_params(generator, cfg, dtype, device=device)
        else:
            p["attn"] = attn.init_gqa_params(generator, cfg, dtype, device=device)
    elif kind == "mamba":
        p["mamba"] = mamba_mod.init_mamba_params(generator, cfg, dtype, device=device)
    elif kind == "rwkv":
        p["tm"] = rwkv_mod.init_rwkv_params(generator, cfg, dtype, device=device)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    if cross:
        p["ln_cross"] = init_rms_norm(cfg.d_model, device=device)
        p["cross"] = attn.init_cross_params(generator, cfg, dtype, device=device)
    p["ln2"] = init_rms_norm(cfg.d_model, device=device)
    if kind == "rwkv":
        p["cm"] = rwkv_mod.init_rwkv_cm_params(generator, cfg, dtype, device=device)
    elif cfg.is_moe_position(pos):
        p["moe"] = init_moe_params(generator, cfg, dtype, device=device)
    else:
        p["ffn"] = init_dense_ffn(generator, cfg.d_model, cfg.d_ff, cfg.activation, dtype,
                                  device=device)
    return p


def init_block_cache(
    cfg: LMConfig,
    pos: int,
    batch: int,
    cache_size: int,
    dtype,
    *,
    long_mode: bool,
    enc_len: int | None = None,
    device: torch.device | str = "cpu",
):
    """Zero cache for one pattern position; ``enc_len`` adds the
    cross-attention KV (encoder-decoder decode)."""
    base = _init_self_cache(cfg, pos, batch, cache_size, dtype, long_mode=long_mode, device=device)
    if enc_len is not None:
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
        return {
            "self": base,
            "cross_kv": {"k": torch.zeros(shape, dtype=dtype, device=device),
                         "v": torch.zeros(shape, dtype=dtype, device=device)},
        }
    return base


def _init_self_cache(cfg: LMConfig, pos: int, batch: int, cache_size: int, dtype, *,
                     long_mode: bool, device):
    kind = cfg.block_pattern[pos]
    if kind in ("attn", "local"):
        w = window_for(kind, cfg, long_mode)
        sc = min(cache_size, w) if w is not None else cache_size
        if cfg.attn_kind == "mla":
            m = cfg.mla
            return {
                "c_kv": torch.zeros((batch, sc, m.kv_lora_rank), dtype=dtype, device=device),
                "k_rope": torch.zeros((batch, sc, m.rope_head_dim), dtype=dtype, device=device),
            }
        shape = (batch, sc, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "mamba":
        return mamba_mod.init_mamba_cache(cfg, batch, dtype, device=device)
    if kind == "rwkv":
        return {
            "tm": rwkv_mod.init_rwkv_cache(cfg, batch, device=device),
            "cm": {"shift": torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                                        device=device)},
        }
    raise ValueError(kind)


def _ring_from_full(full: torch.Tensor, cache_size: int) -> torch.Tensor:
    """Convert full-sequence KV [B, S, ...] to a ring cache of ``cache_size``."""
    s = full.shape[1]
    if s <= cache_size:
        pad = [0, 0] * (full.dim() - 2) + [0, cache_size - s]  # last dim first
        return F.pad(full, pad)
    win = full[:, -cache_size:]
    return torch.roll(win, shifts=(s - cache_size) % cache_size, dims=1)


def block_prefill(
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: LMConfig,
    pos: int,
    *,
    causal: bool = True,
    enc_out: torch.Tensor | None = None,
    long_mode: bool = False,
    cache_size: int | None = None,
):
    """Returns (x, cache, aux_loss).  ``cache_size`` trims KV to a ring."""
    kind = cfg.block_pattern[pos]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(params["ln1"], x)
    if kind in ("attn", "local"):
        w = window_for(kind, cfg, long_mode)
        if cfg.attn_kind == "mla":
            out, cache = attn.mla_prefill(params["mla"], h, positions, cfg, window=w,
                                          causal=causal)
        else:
            out, cache = attn.gqa_prefill(params["attn"], h, positions, cfg, window=w,
                                          causal=causal)
        if cache_size is not None:
            sc = min(cache_size, w) if w is not None else cache_size
            cache = tree_map(lambda a: _ring_from_full(a, sc), cache)
    elif kind == "mamba":
        out, cache = mamba_mod.mamba_prefill(params["mamba"], h, cfg)
    elif rwkv_chunked():
        out, cache = rwkv_mod.rwkv_time_mix_prefill_chunked(params["tm"], h, cfg)
    else:
        out, cache = rwkv_mod.rwkv_time_mix_prefill(params["tm"], h, cfg)
    x = x + maybe_barrier(out)

    if "cross" in params:
        hc = rms_norm(params["ln_cross"], x)
        cross_kv = attn.encode_cross_kv(params["cross"], enc_out, cfg)
        x = x + attn.cross_attention(params["cross"], hc, cross_kv, cfg)
        cache = {"self": cache, "cross_kv": cross_kv}

    h2 = rms_norm(params["ln2"], x)
    if kind == "rwkv":
        out2, cm_cache = rwkv_mod.rwkv_channel_mix_prefill(params["cm"], h2, cfg)
        cache = {"tm": cache, "cm": cm_cache}
    elif "moe" in params:
        out2, aux = moe_ffn(params["moe"], h2, cfg)
    else:
        out2 = dense_ffn(params["ffn"], h2, cfg.activation)
    return x + maybe_barrier(out2), cache, aux


def block_decode(
    params: dict,
    x: torch.Tensor,  # [B, 1, d]
    cache,
    cache_len,
    cfg: LMConfig,
    pos: int,
    *,
    long_mode: bool = False,
    mla_absorb: bool = False,
):
    kind = cfg.block_pattern[pos]
    h = rms_norm(params["ln1"], x)
    self_cache = cache["self"] if "cross" in params else (cache["tm"] if kind == "rwkv" else cache)
    if kind in ("attn", "local"):
        w = window_for(kind, cfg, long_mode)
        if cfg.attn_kind == "mla":
            out, new_self = attn.mla_decode(
                params["mla"], h, self_cache, cache_len, cfg, window=w, absorb=mla_absorb
            )
        else:
            out, new_self = attn.gqa_decode(params["attn"], h, self_cache, cache_len, cfg,
                                            window=w)
    elif kind == "mamba":
        out, new_self = mamba_mod.mamba_decode(params["mamba"], h, self_cache, cfg)
    else:
        out, new_self = rwkv_mod.rwkv_time_mix_decode(params["tm"], h, self_cache, cfg)
    x = x + out

    if "cross" in params:
        hc = rms_norm(params["ln_cross"], x)
        x = x + attn.cross_attention(params["cross"], hc, cache["cross_kv"], cfg)

    h2 = rms_norm(params["ln2"], x)
    if kind == "rwkv":
        out2, new_cm = rwkv_mod.rwkv_channel_mix_decode(params["cm"], h2, cache["cm"], cfg)
        return x + out2, {"tm": new_self, "cm": new_cm}
    if "moe" in params:
        out2, _ = moe_ffn(params["moe"], h2, cfg)
    else:
        out2 = dense_ffn(params["ffn"], h2, cfg.activation)
    new_cache = {"self": new_self, "cross_kv": cache["cross_kv"]} if "cross" in params else new_self
    return x + out2, new_cache
