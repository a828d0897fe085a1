"""Mamba (selective SSM) mixer — Jamba's 7-of-8 layers.

Prefill runs the selective scan as a Python loop of torch ops over time,
where the reference runs a ``lax.scan``: a few small launches per token
and layer.  Decode is the O(1) single-step recurrence with a (conv
window, SSM state) cache.

Dtypes are the reference's: ``a_log``, ``dt_bias`` and ``d_skip`` are
float32 inside a bfloat16 model, ``dt`` goes float32 after ``dt_proj``,
the state and the scan's output are float32, and the causal depthwise
conv sums in the input's dtype, tap 0 first.  ``jax.nn.softplus`` is
``logaddexp(x, 0)``; ``torch.nn.functional.softplus`` switches to ``x``
above its threshold (20), so the port uses ``torch.logaddexp`` too.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import randn
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.moe import silu

__all__ = ["init_mamba_params", "mamba_prefill", "mamba_decode", "init_mamba_cache"]


def _init(generator: torch.Generator, shape, dtype, device, fan_in=None) -> torch.Tensor:
    """Normal draws scaled by ``1/sqrt(fan_in)`` (default ``shape[0]``)."""
    fan_in = fan_in if fan_in is not None else shape[0]
    w = randn(shape, generator, device) / math.sqrt(fan_in)
    return w.to(device=device, dtype=dtype)


def _dims(cfg: LMConfig):
    d_inner = cfg.mamba_expand * cfg.d_model
    dt_rank = -(-cfg.d_model // 16)
    return d_inner, dt_rank, cfg.mamba_d_state, cfg.mamba_d_conv


def init_mamba_params(generator: torch.Generator, cfg: LMConfig, dtype, *, device) -> dict:
    d = cfg.d_model
    d_inner, dt_rank, d_state, d_conv = _dims(cfg)
    a = torch.arange(1, d_state + 1, dtype=torch.float32, device=device).expand(d_inner, d_state)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": _init(generator, (d, 2 * d_inner), dtype, device),
        "conv_w": _init(generator, (d_conv, d_inner), dtype, device, fan_in=d_conv),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "x_proj": _init(generator, (d_inner, dt_rank + 2 * d_state), dtype, device),
        "dt_proj": _init(generator, (dt_rank, d_inner), dtype, device),
        "dt_bias": torch.zeros((d_inner,), **f32),
        "a_log": torch.log(a),  # fp32 continuous-time decay
        "d_skip": torch.ones((d_inner,), **f32),
        "out_proj": _init(generator, (d_inner, d), dtype, device),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold."""
    return torch.logaddexp(x, x.new_zeros(()))


def _ssm_inputs(params, u):
    """u: [..., d_inner] -> (dt, bmat, cmat), all fp32."""
    proj = u @ params["x_proj"]
    dt_rank = params["dt_proj"].shape[0]
    d_state = (proj.shape[-1] - dt_rank) // 2
    dt = _softplus((proj[..., :dt_rank] @ params["dt_proj"]).float() + params["dt_bias"])
    bmat = proj[..., dt_rank : dt_rank + d_state].float()
    cmat = proj[..., dt_rank + d_state :].float()
    return dt, bmat, cmat


def _step(params, a, h, u32, dt_t, b_t, c_t):
    """One SSM step. h: [B, d_inner, d_state]; a = -exp(a_log); u32: the
    step's input in float32."""
    da = torch.exp(dt_t[..., None] * a)  # [B, d_inner, d_state]
    h = da * h + (dt_t * u32)[..., None] * b_t[:, None, :]
    y = torch.einsum("bds,bs->bd", h, c_t) + params["d_skip"] * u32
    return h, y


def _conv_full(params, x):
    """Depthwise causal conv along time. x: [B, S, d_inner]."""
    d_conv = params["conv_w"].shape[0]
    pad = F.pad(x, (0, 0, d_conv - 1, 0))
    out = sum(pad[:, i : i + x.shape[1], :] * params["conv_w"][i] for i in range(d_conv))
    return out + params["conv_b"]


def mamba_prefill(params: dict, x: torch.Tensor, cfg: LMConfig) -> tuple[torch.Tensor, dict]:
    b, s, _ = x.shape
    d_inner, _, d_state, d_conv = _dims(cfg)
    xz = x @ params["in_proj"]
    xin, z = xz[..., :d_inner], xz[..., d_inner:]
    u = silu(_conv_full(params, xin))  # [B, S, d_inner]
    dt, bmat, cmat = _ssm_inputs(params, u)

    a = -torch.exp(params["a_log"])
    u32 = u.float()
    h = torch.zeros((b, d_inner, d_state), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        h, y_t = _step(params, a, h, u32[:, t], dt[:, t], bmat[:, t], cmat[:, t])
        ys.append(y_t)
    y = torch.stack(ys, dim=1).to(x.dtype) * silu(z)
    out = y @ params["out_proj"]
    cache = {
        "conv": xin[:, -(d_conv - 1) :, :],  # raw inputs for the conv window
        "ssm": h,
    }
    return out, cache


def init_mamba_cache(cfg: LMConfig, batch: int, dtype, *, device="cpu") -> dict:
    d_inner, _, d_state, d_conv = _dims(cfg)
    return {
        "conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, d_inner, d_state), dtype=torch.float32, device=device),
    }


def mamba_decode(params: dict, x: torch.Tensor, cache: dict, cfg: LMConfig) -> tuple[torch.Tensor, dict]:
    """x: [B, 1, d]."""
    d_inner = _dims(cfg)[0]
    xz = x[:, 0, :] @ params["in_proj"]
    xin, z = xz[..., :d_inner], xz[..., d_inner:]
    win = torch.cat([cache["conv"], xin[:, None, :]], dim=1)  # [B, d_conv, d_inner]
    u = silu(torch.einsum("bcd,cd->bd", win, params["conv_w"]) + params["conv_b"])
    dt, bmat, cmat = _ssm_inputs(params, u)
    h, y = _step(params, -torch.exp(params["a_log"]), cache["ssm"], u.float(), dt, bmat, cmat)
    y = y.to(x.dtype) * silu(z)
    out = (y @ params["out_proj"])[:, None, :]
    return out, {"conv": win[:, 1:, :], "ssm": h}
