"""Top-level LM: init / train_loss / prefill / decode_step.

The parameter tree keeps the reference's layout: ``blocks`` is a tuple
over pattern positions of dicts whose leaves carry a leading repeat dim
``[R, ...]`` (R = ``n_layers / period``), and KV caches are stacked the
same way.  A Python loop over the repeats takes the place of the
reference's ``lax.scan``; the returned caches are new tensors (the ones
passed in are left as they were).  :func:`params_from_jax` carries the
reference's parameters over as they are, each leaf in its own dtype
(the float32 router, SSM and RWKV leaves of a bfloat16 model included).
Encoder-decoder configs (SeamlessM4T) run an encoder stack first (the
``encoder`` subtree); decoder blocks carry cross-attention whose KV is
cached at prefill.

``train_loss`` rematerialises each repeat of the stack (``torch.utils.
checkpoint``, as the reference's ``jax.checkpoint``, under the remat
policy ``tp.set_remat_policy`` names) and each loss chunk,
and computes the loss in 512-token chunks so the full ``[B, S, vocab]``
logits never materialise (vocab reaches 256k).  Under autograd the
attention takes the plain torch route on every device
(``attention._attend``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import randn, resolve_device
from repro_torch.models.lm.blocks import block_decode, block_prefill, init_block_params
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.norms import init_rms_norm, rms_norm
from repro_torch.models.lm.tp import checkpoint_kwargs
from repro_torch.utils.tree import tree_map

__all__ = [
    "init_params",
    "abstract_params",
    "params_from_jax",
    "train_loss",
    "prefill",
    "decode_step",
    "default_positions",
    "encoder_config",
]

AUX_WEIGHT = 0.01
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def encoder_config(cfg: LMConfig) -> LMConfig:
    """The encoder stack of an enc-dec config: plain dense attention blocks."""
    return dataclasses.replace(
        cfg,
        block_pattern=("attn",),
        moe=None,
        n_layers=cfg.encoder_layers,
        attn_kind="gqa",
        mla=None,
    )


def _dtype(cfg: LMConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _stack(layers: list):
    """Per-repeat trees stacked into one tree of ``[R, ...]`` leaves."""
    return tree_map(lambda *leaves: torch.stack(leaves), *layers)


def _stack_blocks(generator: torch.Generator, cfg: LMConfig, *, cross: bool, device) -> tuple:
    dtype = _dtype(cfg)
    return tuple(
        _stack([init_block_params(generator, cfg, pos, dtype, cross=cross, device=device)
                for _ in range(cfg.n_repeats)])
        for pos in range(cfg.pattern_period)
    )


def init_params(
    cfg: LMConfig, *, generator: torch.Generator, device: torch.device | str | None = None
) -> dict:
    """Random parameters with the reference's distributions (not its
    values), drawn from ``generator`` on its own device and placed on
    ``device`` (default ``"cuda"``).  On ``"meta"`` every leaf is an
    empty meta tensor of the reference's shape and dtype, and nothing is
    drawn (:func:`abstract_params`)."""
    device = resolve_device(device, allow_meta=True)
    dtype = _dtype(cfg)

    def normal(shape):
        w = randn(shape, generator, device) * 0.02
        return w.to(device=device, dtype=dtype)

    params: dict = {"embed": normal((cfg.vocab_padded, cfg.d_model))}
    params["blocks"] = _stack_blocks(generator, cfg, cross=cfg.encoder_layers > 0, device=device)
    params["final_norm"] = init_rms_norm(cfg.d_model, device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.d_model, cfg.vocab_padded))
    if cfg.encoder_layers > 0:
        params["encoder"] = {
            "blocks": _stack_blocks(generator, encoder_config(cfg), cross=False, device=device),
            "final_norm": init_rms_norm(cfg.d_model, device=device),
        }
    return params


def abstract_params(cfg: LMConfig) -> dict:
    """The parameter tree on ``"meta"``: the reference's keys, shapes and
    dtypes, nothing allocated (the dry-run's parameters)."""
    return init_params(cfg, generator=torch.Generator(), device="meta")


def _leaf_from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: no torch.from_numpy
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree, device: torch.device | str = "cpu"):
    """The reference's parameter tree (leaves as numpy) as torch tensors
    on ``device``, layout unchanged (tuples stay tuples)."""
    return tree_map(lambda a: _leaf_from_numpy(a).to(device), tree)


def default_positions(cfg: LMConfig, batch: int, seq: int, *,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.int32, device=device).expand(batch, seq)
    if cfg.rope_kind == "mrope":
        pos = pos[..., None].expand(batch, seq, 3)
    return pos


# ------------------------------------------------------------- stack runs


def _run_prefill_stack(
    blocks: tuple,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: LMConfig,
    *,
    causal: bool,
    enc_out: torch.Tensor | None,
    long_mode: bool,
    cache_size: int | None,
    collect: bool,
    remat: bool,
):
    """The stack over its repeats; with ``remat`` (under autograd) each
    repeat is recomputed in the backward pass instead of keeping its
    activations, all of them or, under the ``"dots"`` remat policy, all
    but its products' outputs (``tp.checkpoint_kwargs``)."""

    def body(hx, r):
        repeat_caches = []
        aux = torch.zeros((), dtype=torch.float32, device=hx.device)
        for pos in range(cfg.pattern_period):
            hx, cache, a = block_prefill(
                tree_map(lambda leaf: leaf[r], blocks[pos]),
                hx,
                positions,
                cfg,
                pos,
                causal=causal,
                enc_out=enc_out,
                long_mode=long_mode,
                cache_size=cache_size,
            )
            repeat_caches.append(cache if collect else None)
            aux = aux + a
        return hx, repeat_caches, aux

    remat = remat and torch.is_grad_enabled()
    caches: list[list] = [[] for _ in range(cfg.pattern_period)]
    auxs = []  # per repeat, summed over the pattern positions, as the reference's scan body
    for r in range(cfg.n_repeats):
        if remat:
            x, repeat_caches, aux = checkpoint(body, x, r, use_reentrant=False,
                                               **checkpoint_kwargs())
        else:
            x, repeat_caches, aux = body(x, r)
        for pos, cache in enumerate(repeat_caches):
            caches[pos].append(cache)
        auxs.append(aux)
    return x, (tuple(_stack(c) for c in caches) if collect else None), torch.stack(auxs).sum()


def _embed_in(params, cfg: LMConfig, batch: dict) -> torch.Tensor:
    if "embeds" in batch:
        return torch.as_tensor(batch["embeds"], device=params["embed"].device).to(_dtype(cfg))
    return params["embed"][torch.as_tensor(batch["tokens"], device=params["embed"].device).long()]


def _logits(params, cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head).float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if cfg.vocab_padded != cfg.vocab:
        # Padded vocab rows must never win softmax / argmax.
        keep = torch.arange(cfg.vocab_padded, device=logits.device) < cfg.vocab
        logits = torch.where(keep, logits, -1e30)
    return logits


def _run_encoder(params, cfg: LMConfig, src_embeds) -> torch.Tensor:
    ecfg = encoder_config(cfg)
    src = torch.as_tensor(src_embeds, device=params["embed"].device).to(_dtype(cfg))
    pos = default_positions(ecfg, src.shape[0], src.shape[1], device=src.device)
    enc_x, _, _ = _run_prefill_stack(
        params["encoder"]["blocks"],
        src,
        pos,
        ecfg,
        causal=False,
        enc_out=None,
        long_mode=False,
        cache_size=None,
        collect=False,
        remat=True,
    )
    return rms_norm(params["encoder"]["final_norm"], enc_x)


def _positions(cfg: LMConfig, batch: dict, x: torch.Tensor) -> torch.Tensor:
    positions = batch.get("positions")
    if positions is None:
        return default_positions(cfg, x.shape[0], x.shape[1], device=x.device)
    return torch.as_tensor(positions, device=x.device)


# ------------------------------------------------------------- train loss


def _ce_chunk(params, cfg: LMConfig, x: torch.Tensor, labels: torch.Tensor):
    """Summed log-likelihood of one chunk's valid labels, and their count."""
    logp = torch.log_softmax(_logits(params, cfg, x), dim=-1)
    valid = labels >= 0
    ll = torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
    return torch.sum(ll * valid), torch.sum(valid).float()


def train_loss(params: dict, batch: dict, cfg: LMConfig) -> torch.Tensor:
    """Mean next-token CE (+ MoE aux).  Labels −100 are ignored."""
    enc_out = None
    if cfg.encoder_layers > 0:
        enc_out = _run_encoder(params, cfg, batch["src_embeds"])

    x = _embed_in(params, cfg, batch)
    b, s = x.shape[0], x.shape[1]
    x, _, aux = _run_prefill_stack(
        params["blocks"],
        x,
        _positions(cfg, batch, x),
        cfg,
        causal=True,
        enc_out=enc_out,
        long_mode=False,
        cache_size=None,
        collect=False,
        remat=True,
    )
    x = rms_norm(params["final_norm"], x)

    labels = torch.as_tensor(batch["labels"], device=x.device).long()
    chunk = 512 if s % 512 == 0 else s
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        # Checkpointed: only one chunk's [B, chunk, vocab] logits live at a time.
        ll, n = checkpoint(_ce_chunk, params, cfg, x[:, c0 : c0 + chunk],
                           labels[:, c0 : c0 + chunk], use_reentrant=False)
        tot, cnt = tot + ll, cnt + n
    ce = -tot / cnt.clamp_min(1.0)
    return ce + AUX_WEIGHT * aux


# ---------------------------------------------------------------- serving


@torch.no_grad()
def prefill(
    params: dict,
    batch: dict,
    cfg: LMConfig,
    *,
    cache_size: int | None = None,
    long_mode: bool = False,
) -> tuple[torch.Tensor, tuple]:
    """Process the prompt; returns (last-token logits [B, V], caches)."""
    enc_out = None
    if cfg.encoder_layers > 0:
        enc_out = _run_encoder(params, cfg, batch["src_embeds"])
    x = _embed_in(params, cfg, batch)
    s = x.shape[1]
    x, caches, _ = _run_prefill_stack(
        params["blocks"],
        x,
        _positions(cfg, batch, x),
        cfg,
        causal=True,
        enc_out=enc_out,
        long_mode=long_mode,
        cache_size=cache_size if cache_size is not None else s,
        collect=True,
        remat=False,
    )
    x = rms_norm(params["final_norm"], x[:, -1:, :])
    return _logits(params, cfg, x)[:, 0, :], caches


@torch.no_grad()
def decode_step(
    params: dict,
    tokens: torch.Tensor,  # [B, 1] int
    caches: tuple,
    cache_len,  # host int (every slot at one position) or int [B] (per slot)
    cfg: LMConfig,
    *,
    long_mode: bool = False,
    mla_absorb: bool = False,
) -> tuple[torch.Tensor, tuple]:
    """One-token decode against the KV/state caches."""
    x = params["embed"][torch.as_tensor(tokens, device=params["embed"].device).long()]
    new_caches: list[list] = [[] for _ in range(cfg.pattern_period)]
    for r in range(cfg.n_repeats):
        for pos in range(cfg.pattern_period):
            x, nc = block_decode(
                tree_map(lambda leaf: leaf[r], params["blocks"][pos]),
                x,
                tree_map(lambda leaf: leaf[r], caches[pos]),
                cache_len,
                cfg,
                pos,
                long_mode=long_mode,
                mla_absorb=mla_absorb,
            )
            new_caches[pos].append(nc)
    x = rms_norm(params["final_norm"], x)
    return _logits(params, cfg, x)[:, 0, :], tuple(_stack(c) for c in new_caches)
