"""RWKV6 "Finch" mixer: attention-free, data-dependent per-channel decay.

Time-mix (the WKV6 recurrence) replaces attention; channel-mix (squared
ReLU with token shift) replaces the FFN.  Prefill runs the recurrence as a
Python loop of torch ops over time, where the reference runs a
``lax.scan`` (state per head is Dk x Dv); decode is the O(1) single-step
update.  The data-dependent decay ``w_t = exp(-exp(w0 + tanh(x·A)·B))`` is
the Finch signature (arXiv:2404.05892) — decay LoRA on the shifted input.
The reference's ``vmap`` over time is a product over ``[B, S, d]`` here.

Dtypes are the reference's: ``mu``, ``w0``, the decay LoRA, ``u_bonus``
and ``ln_x`` are float32 inside a bfloat16 model, and ``k`` (model dtype)
times ``v`` (float32) promotes to float32.  The per-head group norm uses
the population variance, as ``jnp.var`` does.
:func:`rwkv_time_mix_prefill_chunked` is the reference's chunked form
(``tp.set_rwkv_chunked(True)`` routes prefill to it).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import randn
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.moe import silu

__all__ = [
    "init_rwkv_params",
    "rwkv_time_mix_prefill",
    "rwkv_time_mix_prefill_chunked",
    "rwkv_time_mix_decode",
    "init_rwkv_cm_params",
    "rwkv_channel_mix_prefill",
    "rwkv_channel_mix_decode",
    "init_rwkv_cache",
]

DECAY_LORA = 64


def _init(generator: torch.Generator, shape, dtype, device, fan_in=None) -> torch.Tensor:
    """Normal draws scaled by ``1/sqrt(fan_in)`` (default ``shape[0]``)."""
    fan_in = fan_in if fan_in is not None else shape[0]
    w = randn(shape, generator, device) / math.sqrt(fan_in)
    return w.to(device=device, dtype=dtype)


def _heads(cfg: LMConfig):
    dh = cfg.rwkv_head_dim
    assert cfg.d_model % dh == 0
    return cfg.d_model // dh, dh


def init_rwkv_params(generator: torch.Generator, cfg: LMConfig, dtype, *, device) -> dict:
    d = cfg.d_model
    h, dh = _heads(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "mu": torch.full((5, d), 0.5, **f32),  # shift-mix for r,k,v,w,g
        "w_r": _init(generator, (d, d), dtype, device),
        "w_k": _init(generator, (d, d), dtype, device),
        "w_v": _init(generator, (d, d), dtype, device),
        "w_g": _init(generator, (d, d), dtype, device),
        "w_o": _init(generator, (d, d), dtype, device),
        "w0": torch.full((d,), -1.0, **f32),  # base decay
        "w_lora_a": _init(generator, (d, DECAY_LORA), torch.float32, device),
        "w_lora_b": _init(generator, (DECAY_LORA, d), torch.float32, device) * 0.1,
        "u_bonus": torch.zeros((h, dh), **f32),
        "ln_x": {"scale": torch.ones((d,), **f32)},  # per-head group norm
    }


def _mix(x, x_prev, mu_row):
    return x + mu_row * (x_prev - x)


def _rkvwg(params, x, x_prev, cfg):
    """x, x_prev: [..., d] -> per-head r, k, v [..., H, Dh], decay w
    [..., H, Dh] and gate g [..., d]."""
    h, dh = _heads(cfg)
    mu = params["mu"]
    xr, xk, xv, xw, xg = (_mix(x, x_prev, mu[i]) for i in range(5))
    heads = (*x.shape[:-1], h, dh)
    r = (xr.to(params["w_r"].dtype) @ params["w_r"]).reshape(heads)
    k = (xk.to(params["w_k"].dtype) @ params["w_k"]).reshape(heads)
    v = (xv.to(params["w_v"].dtype) @ params["w_v"]).reshape(heads)
    g = silu(xg.to(params["w_g"].dtype) @ params["w_g"])
    logw = params["w0"] + torch.tanh(xw.float() @ params["w_lora_a"]) @ params["w_lora_b"]
    w = torch.exp(-torch.exp(logw)).reshape(heads)  # data-dependent decay in (0,1)
    return r, k, v, w, g


def _wkv_step(state, r, k, v, w, u):
    """state: [B,H,Dk,Dv]; r,k,v,w: [B,H,Dh]; u: [H,Dh]."""
    a = k[..., :, None] * v[..., None, :]  # [B,H,Dk,Dv], fp32
    out = torch.einsum("bhk,bhkv->bhv", r.float(), state + u[..., None] * a)
    state = w[..., :, None] * state + a
    return state, out


def _group_norm(params, x, h, dh):
    """Per-head layer norm of the wkv output. x: [..., H, Dv] -> [..., d]."""
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)  # population variance, as jnp.var
    y = (x - mean) * torch.rsqrt(var + 1e-5)
    return (y.reshape(*x.shape[:-2], h * dh) * params["ln_x"]["scale"]).float()


def _shifted(x32):
    """The previous token's input, zeros before the first. x32: [B, S, d]."""
    return F.pad(x32, (0, 0, 1, 0))[:, :-1]


def _out(params, outs, g, h, dh):
    """Group norm, gate and output projection of the wkv outputs [..., H, Dv]
    (in the model's dtype, ``w_o``'s)."""
    y = _group_norm(params, outs, h, dh)
    return (y * g.float()).to(params["w_o"].dtype) @ params["w_o"]


def rwkv_time_mix_prefill(params: dict, x: torch.Tensor, cfg: LMConfig) -> tuple[torch.Tensor, dict]:
    b, s, _ = x.shape
    h, dh = _heads(cfg)
    x32 = x.float()
    r, k, v, w, g = _rkvwg(params, x32, _shifted(x32), cfg)
    r, k, v = r.float(), k.float(), v.float()  # exact: what each step would upcast
    state = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device)
    outs = []
    for t in range(s):
        state, o = _wkv_step(state, r[:, t], k[:, t], v[:, t], w[:, t], params["u_bonus"])
        outs.append(o)
    y = _out(params, torch.stack(outs, dim=1), g, h, dh)
    return y, {"state": state, "shift": x32[:, -1, :]}


def init_rwkv_cache(cfg: LMConfig, batch: int, *, device="cpu") -> dict:
    h, dh = _heads(cfg)
    return {
        "state": torch.zeros((batch, h, dh, dh), dtype=torch.float32, device=device),
        "shift": torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device),
    }


def rwkv_time_mix_decode(params: dict, x: torch.Tensor, cache: dict, cfg: LMConfig):
    """x: [B, 1, d]."""
    h, dh = _heads(cfg)
    xt = x[:, 0, :].float()
    r, k, v, w, g = _rkvwg(params, xt, cache["shift"], cfg)
    state, out = _wkv_step(cache["state"], r, k, v.float(), w, params["u_bonus"])
    y = _out(params, out, g, h, dh)[:, None, :]
    return y, {"state": state, "shift": xt}


# ------------------------------------------------------------ channel mix


def init_rwkv_cm_params(generator: torch.Generator, cfg: LMConfig, dtype, *, device) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mu": torch.full((2, d), 0.5, dtype=torch.float32, device=device),  # shift-mix for k, r
        "w_in": _init(generator, (d, ff), dtype, device),
        "w_out": _init(generator, (ff, d), dtype, device),
        "w_gate": _init(generator, (d, d), dtype, device),
    }


def _cm(params, x, x_prev):
    xk = _mix(x, x_prev, params["mu"][0])
    xr = _mix(x, x_prev, params["mu"][1])
    k = torch.square(torch.relu(xk.to(params["w_in"].dtype) @ params["w_in"]))
    kv = k @ params["w_out"]
    return torch.sigmoid(xr.to(params["w_gate"].dtype) @ params["w_gate"]) * kv


def rwkv_channel_mix_prefill(params: dict, x: torch.Tensor, cfg: LMConfig):
    x32 = x.float()
    y = _cm(params, x32, _shifted(x32))
    return y.to(params["w_out"].dtype), {"shift": x32[:, -1, :]}


def rwkv_channel_mix_decode(params: dict, x: torch.Tensor, cache: dict, cfg: LMConfig):
    xt = x[:, 0, :].float()
    y = _cm(params, xt, cache["shift"])
    return y.to(params["w_out"].dtype)[:, None, :], {"shift": xt}


# ------------------------------------------------------- chunked prefill


def rwkv_time_mix_prefill_chunked(
    params: dict, x: torch.Tensor, cfg: LMConfig, chunk: int = 64
) -> tuple[torch.Tensor, dict]:
    """Chunked WKV6 (flash-linear-attention style): ``chunk`` tokens per
    step through products.  Within a chunk, decays are applied in log
    space as pairwise differences ``cum_i - cum_{j+1} <= 0`` (exp <= 1,
    numerically safe); across chunks a [Dk, Dv] state carries.
    Mathematically identical to :func:`rwkv_time_mix_prefill`."""
    b, s, d = x.shape
    h, dh = _heads(cfg)
    pad = (-s) % chunk
    x32 = x.float()
    x_prev = _shifted(x32)
    r, k, v, _, g = _rkvwg(params, x32, x_prev, cfg)
    # the log-decay itself (w = exp(-exp(logw)) -> lw = -exp(logw))
    xw = _mix(x32, x_prev, params["mu"][3])
    logw = params["w0"] + torch.tanh(xw @ params["w_lora_a"]) @ params["w_lora_b"]
    lw = -torch.exp(logw).reshape(b, s, h, dh)  # [B,S,H,D], <= 0

    sp = s + pad
    nc = sp // chunk

    def chunks(a):  # [B,S,H,D] -> [nc,B,H,C,D], zero-padded along S
        a = F.pad(a.float(), (0, 0, 0, 0, 0, pad))
        return a.reshape(b, nc, chunk, h, dh).permute(1, 0, 3, 2, 4)

    r_c, k_c, v_c, lw_c = map(chunks, (r, k, v, lw))
    u = params["u_bonus"]  # [H, D]
    idx = torch.arange(chunk, device=x.device)
    tri = (idx[:, None] > idx[None, :])[None, None, :, :, None]
    eye = torch.eye(chunk, dtype=torch.float32, device=x.device)[None, None]

    state = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device)
    outs = []
    for rc, kc, vc, lwc in zip(r_c, k_c, v_c, lw_c):  # [B,H,C,D] each
        cum = torch.cumsum(lwc, dim=2) - lwc  # exclusive prefix: cum_i
        cum_end = cum[:, :, -1:, :] + lwc[:, :, -1:, :]  # full-chunk sum
        # inter-chunk: out_i += (r_i * exp(cum_i)) . S0
        out = torch.einsum("bhcd,bhde->bhce", rc * torch.exp(cum), state)
        # intra-chunk: A[i,j] = sum_d r_i k_j exp(cum_i - cum_j - lw_j), j < i
        expo = cum[:, :, :, None, :] - (cum + lwc)[:, :, None, :, :]  # [B,H,C,C,D]
        decay = torch.where(tri, torch.exp(torch.clamp_max(expo, 0.0)), 0.0)
        a_mat = torch.einsum("bhcd,bhed,bhced->bhce", rc, kc, decay)
        diag = torch.einsum("bhcd,bhcd->bhc", rc, u[None, :, None, :] * kc)
        a_mat = a_mat + eye * diag[:, :, :, None]
        out = out + torch.einsum("bhce,bhed->bhcd", a_mat, vc)
        # state update: S' = S * exp(cum_end) + sum_j exp(cum_end - cum_{j+1}) k_j (x) v_j
        k_dec = kc * torch.exp(cum_end - (cum + lwc))
        state = state * torch.exp(cum_end).transpose(2, 3) + torch.einsum(
            "bhcd,bhce->bhde", k_dec, vc
        )
        outs.append(out)
    outs = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, sp, h, dh)[:, :s]  # [B,S,H,D]
    y = _out(params, outs, g, h, dh)
    return y, {"state": state, "shift": x32[:, -1, :]}
