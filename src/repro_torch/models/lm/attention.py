"""Attention mixers: GQA/MQA (with sliding window + softcap) and MLA.

Two entry modes per mixer, as in the reference:

* ``prefill`` — full-sequence causal attention; returns the populated KV
  cache.
* ``decode`` — one new token against a KV cache, functional cache update
  at position ``cache_len`` (ring-buffer semantics when the cache is
  shorter than the logical position — the long-context dense carve-in).

GQA attention goes through one routing function, :func:`_attend`, on
``[B, S, H, D]`` tensors.  On a CUDA tensor it launches the hand-written
flash-attention kernel (``kernels/flash_attention``, B5), transposing to
``[B, H, S, D]`` and back; it launches or raises.  On a CPU tensor it is
the port of the reference's ``_chunked_scores_softmax``: q and k upcast
to fp32, fp32 scores and softmax, the output cast to q's dtype; so is it
on the card under autograd (training), as B5 has no backward pass.
Prefill and cross-attention always go through ``_attend``.  Decode
takes it when ``cache_len`` is one host integer (every slot at the same
position, as the serve CLI decodes): the ring slots the mask keeps are
then a contiguous slice of an unwrapped ring, or the whole ring once it
has wrapped, and keys are already rotated, so attention over those slots
without a mask is the masked attention.  A per-slot ``cache_len`` vector
(the batched server) keeps the reference's inline masked einsum: B5 has
no per-row kv length.

MLA (DeepSeek-V2) caches the *compressed* (c_kv, k_rope) pair; its q·k
width differs from its v width, and it stays in plain torch on every
device, as the reference scores it inline.  ``absorb=True`` switches to
the matrix-absorbed decode.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import randn
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.norms import rms_norm
from repro_torch.models.lm.rope import apply_rope, rope_angles
from repro_torch.models.lm.tp import maybe_row_parallel

__all__ = [
    "init_gqa_params",
    "gqa_prefill",
    "gqa_decode",
    "init_mla_params",
    "mla_prefill",
    "mla_decode",
    "init_cross_params",
    "cross_attention",
    "encode_cross_kv",
]

NEG_INF = -1e30


def _init(generator: torch.Generator, shape, dtype, device, scale=None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = randn(shape, generator, device) * scale
    return w.to(device=device, dtype=dtype)


def _fp32_scale(d: int) -> float:
    """``1/sqrt(d)`` rounded to fp32, as the reference computes it."""
    return float(1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32)))


# =============================================================== GQA / MQA


def init_gqa_params(generator: torch.Generator, cfg: LMConfig, dtype, *, device) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": _init(generator, (d, h * dh), dtype, device),
        "wk": _init(generator, (d, hkv * dh), dtype, device),
        "wv": _init(generator, (d, hkv * dh), dtype, device),
        "wo": _init(generator, (h * dh, d), dtype, device),
    }


def _qkv(params, x, cfg: LMConfig):
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (x @ params["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ params["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _softcap(s, cap):
    return s if cap is None else cap * torch.tanh(s / cap)


def _chunked_scores_softmax(q, k, v, *, q_offset, kv_valid_len, window, softcap, causal, n_rep):
    """Causal/windowed attention with q chunked (512 rows when S divides).

    q: [B, S, H, D]; k/v: [B, Sk, Hkv, D] (v's last dim may differ: MLA).
    Returns [B, S, H, Dv] in q's dtype.  ``n_rep`` = H // Hkv (GQA
    repetition through a grouped einsum, kv never repeated)."""
    b, s, h, dh = q.shape
    dv = v.shape[-1]
    sk, hkv = k.shape[1], k.shape[2]
    chunk = 512 if s % 512 == 0 else s
    scale = _fp32_scale(dh)
    k32, v32 = k.float(), v.float()
    ki = torch.arange(sk, device=q.device)
    outs = []
    for c0 in range(0, s, chunk):
        qc = q[:, c0 : c0 + chunk].reshape(b, chunk, hkv, n_rep, dh).float()
        scores = _softcap(torch.einsum("bqkrd,bskd->bkrqs", qc, k32) * scale, softcap)
        qi = q_offset + c0 + torch.arange(chunk, device=q.device)
        mask = (ki < kv_valid_len)[None, :]
        if causal:
            mask = mask & (qi[:, None] >= ki[None, :])
        if window is not None:
            mask = mask & (qi[:, None] - ki[None, :] < window)
        p = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
        outs.append(torch.einsum("bkrqs,bskd->bqkrd", p, v32).to(q.dtype))
    return torch.cat(outs, dim=1).reshape(b, s, h, dv)


def _attend(q, k, v, *, causal: bool, window: int | None, softcap: float | None):
    """GQA attention, q ``[B, S, H, D]`` against k, v ``[B, Sk, Hkv, D]``,
    masks aligned at position 0.  CUDA: B5 (launches or raises); CPU: the
    plain fp32 version.  Under autograd (grad mode on and q, k or v
    requiring grad) the plain version on every device: B5 has no backward
    pass, and the reference differentiates its XLA attention, not its
    Pallas kernel."""
    differentiated = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                                  or v.requires_grad)
    if q.is_cuda and not differentiated:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal, window=window, softcap=softcap)
        return out.transpose(1, 2)
    return _chunked_scores_softmax(q, k, v, q_offset=0, kv_valid_len=k.shape[1], window=window,
                                   softcap=softcap, causal=causal, n_rep=q.shape[2] // k.shape[2])


def gqa_prefill(
    params: dict,
    x: torch.Tensor,  # [B, S, d]
    positions: torch.Tensor,  # [B, S] (or [B, S, 3] for mrope)
    cfg: LMConfig,
    *,
    window: int | None,
    causal: bool = True,
) -> tuple[torch.Tensor, dict]:
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    if cfg.rope_kind != "none":
        cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_kind, cfg.mrope_sections)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    out = _attend(q, k, v, causal=causal, window=window, softcap=cfg.attn_softcap)
    out = maybe_row_parallel(out.reshape(b, s, cfg.n_heads * cfg.head_dim), params["wo"])
    return out, {"k": k, "v": v}


def _is_host_int(cache_len) -> bool:
    return isinstance(cache_len, (int, np.integer)) and not isinstance(cache_len, bool)


def _per_batch(cache_len, b: int, device) -> torch.Tensor:
    """Broadcast a scalar or [B] cache_len to an int64 [B] tensor."""
    cl = torch.as_tensor(cache_len, device=device).long()
    return cl.expand(b) if cl.dim() == 0 else cl


def _ring_write(buf: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Write ``new[:, 0]`` at per-batch ring slots (out of place). buf: [B, Sc, ...]."""
    b = buf.shape[0]
    return buf.index_put((torch.arange(b, device=buf.device), slot), new[:, 0])


def _ring_mask(cache_len_b: torch.Tensor, sc: int, window: int | None) -> torch.Tensor:
    """[B, Sc] validity mask.  Slot ki holds logical position p(ki) = the
    largest p <= cache_len with p % sc == ki (ring semantics)."""
    ki = torch.arange(sc, device=cache_len_b.device)[None, :]
    cl = cache_len_b[:, None]
    logical = cl - torch.remainder(cl - ki, sc)
    mask = (logical >= 0) & (logical <= cl)
    if window is not None:
        mask &= cl - logical < window
    return mask


def _ring_slots(cache_len: int, sc: int, window: int | None) -> list[tuple[int, int]]:
    """The slot ranges ``[a, e)`` that ``_ring_mask`` keeps for one host
    ``cache_len``: the logical positions ``[lo, cache_len]``, at most
    ``sc`` of them and at most ``window``.  One range, or two where the
    kept run wraps past the ring's end."""
    lo = max(0, cache_len - sc + 1)
    if window is not None:
        lo = max(lo, cache_len - window + 1)
    if cache_len - lo + 1 >= sc:
        return [(0, sc)]
    a, e = lo % sc, cache_len % sc
    return [(a, e + 1)] if a <= e else [(a, sc), (0, e + 1)]


def _kept(buf: torch.Tensor, ranges: list[tuple[int, int]]) -> torch.Tensor:
    parts = [buf[:, a:e] for a, e in ranges]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def gqa_decode(
    params: dict,
    x: torch.Tensor,  # [B, 1, d]
    cache: dict,  # {"k": [B, Sc, Hkv, D], "v": ...}
    cache_len,  # host int, or int [B] (per-slot): logical position per slot
    cfg: LMConfig,
    *,
    window: int | None,
) -> tuple[torch.Tensor, dict]:
    b = x.shape[0]
    sc = cache["k"].shape[1]
    cl = _per_batch(cache_len, b, x.device)
    q, k, v = _qkv(params, x, cfg)
    pos = cl[:, None]
    if cfg.rope_kind == "mrope":
        pos = pos[..., None].expand(b, 1, 3)
    if cfg.rope_kind != "none":
        cos, sin = rope_angles(pos, cfg.head_dim, cfg.rope_theta, cfg.rope_kind, cfg.mrope_sections)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    slot = torch.remainder(cl, sc)  # ring buffer when logical pos >= capacity
    new_k = _ring_write(cache["k"], k, slot)
    new_v = _ring_write(cache["v"], v, slot)

    if _is_host_int(cache_len):
        ranges = _ring_slots(int(cache_len), sc, window)
        out = _attend(q, _kept(new_k, ranges), _kept(new_v, ranges), causal=False, window=None,
                      softcap=cfg.attn_softcap)
    else:
        n_rep = cfg.n_heads // cfg.n_kv_heads
        qg = q.reshape(b, 1, cfg.n_kv_heads, n_rep, cfg.head_dim)
        scores = torch.einsum("bqkrd,bskd->bkrqs", qg.float(), new_k.float())
        scores = _softcap(scores * _fp32_scale(cfg.head_dim), cfg.attn_softcap)
        mask = _ring_mask(cl, sc, window)  # [B, Sc]
        p = torch.softmax(torch.where(mask[:, None, None, None, :], scores, NEG_INF), dim=-1)
        out = torch.einsum("bkrqs,bskd->bqkrd", p, new_v.float()).to(x.dtype)
    out = maybe_row_parallel(out.reshape(b, 1, cfg.n_heads * cfg.head_dim), params["wo"])
    return out, {"k": new_k, "v": new_v}


# ===================================================================== MLA


def init_mla_params(generator: torch.Generator, cfg: LMConfig, dtype, *, device) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qd = m.nope_head_dim + m.rope_head_dim
    return {
        "w_dq": _init(generator, (d, m.q_lora_rank), dtype, device),
        "q_norm": {"scale": torch.ones((m.q_lora_rank,), dtype=torch.float32, device=device)},
        "w_uq": _init(generator, (m.q_lora_rank, h * qd), dtype, device),
        "w_dkv": _init(generator, (d, m.kv_lora_rank), dtype, device),
        "kv_norm": {"scale": torch.ones((m.kv_lora_rank,), dtype=torch.float32, device=device)},
        "w_kr": _init(generator, (d, m.rope_head_dim), dtype, device),
        "w_uk": _init(generator, (m.kv_lora_rank, h * m.nope_head_dim), dtype, device),
        "w_uv": _init(generator, (m.kv_lora_rank, h * m.v_head_dim), dtype, device),
        "wo": _init(generator, (h * m.v_head_dim, d), dtype, device),
    }


def _mla_q(params, x, positions, cfg):
    m = cfg.mla
    b, s, _ = x.shape
    cq = rms_norm(params["q_norm"], x @ params["w_dq"])
    q = (cq @ params["w_uq"]).reshape(b, s, cfg.n_heads, m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q[..., : m.nope_head_dim], q[..., m.nope_head_dim :]
    cos, sin = rope_angles(positions, m.rope_head_dim, cfg.rope_theta, "default", cfg.mrope_sections)
    return q_nope, apply_rope(q_rope, cos, sin)


def _mla_compress(params, x, positions, cfg):
    m = cfg.mla
    c_kv = rms_norm(params["kv_norm"], x @ params["w_dkv"])  # [B,S,R]
    k_rope = (x @ params["w_kr"])[:, :, None, :]  # [B,S,1,Dr] (shared head)
    cos, sin = rope_angles(positions, m.rope_head_dim, cfg.rope_theta, "default", cfg.mrope_sections)
    return c_kv, apply_rope(k_rope, cos, sin)[:, :, 0, :]  # [B,S,Dr]


def mla_prefill(
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: LMConfig,
    *,
    window: int | None,
    causal: bool = True,
) -> tuple[torch.Tensor, dict]:
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _mla_q(params, x, positions, cfg)
    c_kv, k_rope = _mla_compress(params, x, positions, cfg)
    k_nope = (c_kv @ params["w_uk"]).reshape(b, s, h, m.nope_head_dim)
    v = (c_kv @ params["w_uv"]).reshape(b, s, h, m.v_head_dim)

    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, m.rope_head_dim)], dim=-1)
    out = _chunked_scores_softmax(
        q, k, v, q_offset=0, kv_valid_len=s, window=window, softcap=cfg.attn_softcap,
        causal=causal, n_rep=1,
    )
    out = maybe_row_parallel(out.reshape(b, s, h * m.v_head_dim), params["wo"])
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def mla_decode(
    params: dict,
    x: torch.Tensor,  # [B, 1, d]
    cache: dict,  # {"c_kv": [B, Sc, R], "k_rope": [B, Sc, Dr]}
    cache_len,
    cfg: LMConfig,
    *,
    window: int | None,
    absorb: bool = False,
) -> tuple[torch.Tensor, dict]:
    m = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads
    sc = cache["c_kv"].shape[1]
    cl = _per_batch(cache_len, b, x.device)
    pos = cl[:, None]
    q_nope, q_rope = _mla_q(params, x, pos, cfg)  # [B,1,H,*]
    c_new, kr_new = _mla_compress(params, x, pos, cfg)
    slot = torch.remainder(cl, sc)
    c_kv = _ring_write(cache["c_kv"], c_new, slot)
    k_rope = _ring_write(cache["k_rope"], kr_new, slot)

    mask = _ring_mask(cl, sc, window)[:, None, None, :]  # [B,1,1,Sc]
    scale = _fp32_scale(m.nope_head_dim + m.rope_head_dim)
    rope_scores = torch.einsum("bqhe,bse->bhqs", q_rope.float(), k_rope.float())

    if absorb:
        # Absorbed decode: fold W_uk into the query and W_uv into the output
        # so attention runs in the compressed space.
        w_uk = params["w_uk"].reshape(m.kv_lora_rank, h, m.nope_head_dim)
        q_c = torch.einsum("bqhn,rhn->bqhr", q_nope.float(), w_uk.float())
        scores = torch.einsum("bqhr,bsr->bhqs", q_c, c_kv.float()) + rope_scores
        scores = _softcap(scores * scale, cfg.attn_softcap)
        p = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
        ctx = torch.einsum("bhqs,bsr->bqhr", p, c_kv.float())  # [B,1,H,R]
        w_uv = params["w_uv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
        out = torch.einsum("bqhr,rhv->bqhv", ctx, w_uv.float()).to(x.dtype)
    else:
        # Baseline decode: expand k/v from the compressed cache every step.
        k_nope = (c_kv @ params["w_uk"]).reshape(b, sc, h, m.nope_head_dim)
        v = (c_kv @ params["w_uv"]).reshape(b, sc, h, m.v_head_dim)
        scores = torch.einsum("bqhn,bshn->bhqs", q_nope.float(), k_nope.float()) + rope_scores
        scores = _softcap(scores * scale, cfg.attn_softcap)
        p = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
        out = torch.einsum("bhqs,bshv->bqhv", p, v.float()).to(x.dtype)

    out = maybe_row_parallel(out.reshape(b, 1, h * m.v_head_dim), params["wo"])
    return out, {"c_kv": c_kv, "k_rope": k_rope}


# ======================================================== cross-attention


def init_cross_params(generator: torch.Generator, cfg: LMConfig, dtype, *, device) -> dict:
    return init_gqa_params(generator, cfg, dtype, device=device)


def cross_attention(
    params: dict,
    x: torch.Tensor,  # [B, Sq, d] decoder states
    enc_kv: dict,  # {"k": [B, Se, Hkv, D], "v": ...} precomputed encoder KV
    cfg: LMConfig,
) -> torch.Tensor:
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    out = _attend(q, enc_kv["k"], enc_kv["v"], causal=False, window=None, softcap=None)
    return maybe_row_parallel(out.reshape(b, s, cfg.n_heads * cfg.head_dim), params["wo"])


def encode_cross_kv(params: dict, enc_out: torch.Tensor, cfg: LMConfig) -> dict:
    b, se, _ = enc_out.shape
    k = (enc_out @ params["wk"]).reshape(b, se, cfg.n_kv_heads, cfg.head_dim)
    v = (enc_out @ params["wv"]).reshape(b, se, cfg.n_kv_heads, cfg.head_dim)
    return {"k": k, "v": v}
