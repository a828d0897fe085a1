"""Dense FFN and the top-k MoE with sort-based dispatch.

``dense_ffn`` is the SwiGLU / GeGLU / GELU block every dense
architecture uses.  ``jax.nn.gelu`` defaults to the tanh approximation,
so GELU here is ``gelu(approximate="tanh")``.

``moe_ffn`` is the reference's dense-compute MoE: assignments are sorted
by expert (a stable sort, as ``jnp.argsort`` is), each expert processes a
static-capacity buffer ``[E, C, d]`` through batched products, rows over
capacity go to an overflow slot that is cut off, and the results are
combined weighted by the router gate.  The reference combines with a
scatter-add in the model's dtype; on CUDA ``index_add_`` in bfloat16 adds
with atomics, whose order (and so rounding) changes from run to run, so
the port undoes the sort into ``[T, k, d]`` and adds each token's ``k``
rows in the reference's order (ascending expert id), the same bits on
every run.  Expert parallelism over a mesh (``set_shard_map_context``
with a mesh) waits for ROADMAP A-item 19.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.tp import maybe_row_parallel

__all__ = [
    "init_moe_params",
    "moe_ffn",
    "init_dense_ffn",
    "dense_ffn",
    "moe_capacity",
    "set_shard_map_context",
    "silu",
]


def set_shard_map_context(mesh=None, data_axes: tuple = (), model_axis: str = "model") -> None:
    """Only ``mesh=None`` (one device, the sort-based dispatch) is ported."""
    if mesh is not None:
        raise NotImplementedError(
            "expert-parallel MoE over a mesh is not ported yet (ROADMAP A-item 19: dry-runs "
            "and sharding)"
        )


def _init(generator: torch.Generator, shape, dtype, device, fan_in=None) -> torch.Tensor:
    """Normal draws scaled by ``1/sqrt(fan_in)`` (default ``shape[-2]``)."""
    fan_in = fan_in if fan_in is not None else shape[-2]
    w = torch.randn(shape, generator=generator, device=generator.device) / math.sqrt(fan_in)
    return w.to(device=device, dtype=dtype)


# ------------------------------------------------------------- dense FFN


def init_dense_ffn(
    generator: torch.Generator, d: int, ff: int, activation: str, dtype, *, device
) -> dict:
    p = {
        "w1": _init(generator, (d, ff), dtype, device),
        "w2": _init(generator, (ff, d), dtype, device),
    }
    if activation in ("silu", "geglu"):
        p["w3"] = _init(generator, (d, ff), dtype, device)  # gate
    return p


def silu(h: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``, two roundings in bfloat16 (one
    after the sigmoid, one after the product), where ``F.silu`` rounds once."""
    return h * torch.sigmoid(h)


def _act(h: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "silu":
        return silu(h)
    if activation in ("geglu", "gelu"):
        return F.gelu(h, approximate="tanh")
    raise ValueError(activation)


def dense_ffn(params: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    h = x @ params["w1"]
    if "w3" in params:
        h = _act(h, activation) * (x @ params["w3"])
    else:
        h = _act(h, activation)
    return maybe_row_parallel(h, params["w2"])


# -------------------------------------------------------------------- MoE


def moe_capacity(num_tokens: int, cfg: LMConfig) -> int:
    m = cfg.moe
    c = int(num_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8, floor 8


def init_moe_params(generator: torch.Generator, cfg: LMConfig, dtype, *, device) -> dict:
    m = cfg.moe
    d, ff, e = cfg.d_model, m.d_ff_expert, m.n_experts
    p = {
        "router": _init(generator, (d, e), torch.float32, device, fan_in=d),
        "we1": _init(generator, (e, d, ff), dtype, device, fan_in=d),
        "we2": _init(generator, (e, ff, d), dtype, device, fan_in=ff),
        "we3": _init(generator, (e, d, ff), dtype, device, fan_in=d),
    }
    if m.n_shared > 0:
        ff_sh = m.d_ff_shared or m.n_shared * ff
        p["shared"] = init_dense_ffn(generator, d, ff_sh, cfg.activation, dtype, device=device)
    return p


def moe_ffn(params: dict, x: torch.Tensor, cfg: LMConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B, S, d], aux load-balance loss scalar)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    k = m.top_k
    e = m.n_experts
    cap = moe_capacity(t, cfg)
    dev = x.device

    xf = x.reshape(t, d)
    probs = torch.softmax(xf.float() @ params["router"], dim=-1)  # [T, E]
    gate_vals, expert_idx = torch.topk(probs, k)  # [T, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # Load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    pe = probs.mean(0)
    fe = torch.bincount(expert_idx.reshape(-1), minlength=e).float() / (t * k)
    aux = e * torch.sum(fe * pe)

    # ---- sort-based dispatch ------------------------------------------
    flat_e = expert_idx.reshape(-1)  # [T*k]
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=dev, dtype=sorted_e.dtype))
    rank = torch.arange(t * k, device=dev) - starts[sorted_e]
    keep = rank < cap
    dest = torch.where(keep, sorted_e * cap + rank, e * cap)  # overflow slot
    token_of = sort_idx // k

    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
    buf[dest] = xf[token_of]  # only the discarded overflow slot repeats
    buf = buf[:-1].reshape(e, cap, d)

    # ---- expert compute (batched products over the experts) -----------
    h = _act(torch.bmm(buf, params["we1"]), cfg.activation) * torch.bmm(buf, params["we3"])
    y = torch.bmm(h, params["we2"])  # [E, C, d]

    # ---- combine: each token's k rows, added in ascending expert id ---
    yf = y.reshape(e * cap, d)
    gathered = torch.where(keep[:, None], yf[dest.clamp_max(e * cap - 1)], 0)
    w = gate_vals.reshape(-1)[sort_idx][:, None].to(x.dtype)
    rows = torch.empty((t * k, d), dtype=x.dtype, device=dev)
    rows[sort_idx] = gathered * w  # row i*k + j: token i's j-th top-k choice
    order = torch.argsort(expert_idx, dim=1)  # ascending expert id per token
    rows = rows.reshape(t, k, d).gather(1, order[:, :, None].expand(t, k, d))
    out = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for j in range(k):
        out = out + rows[:, j]

    if "shared" in params:
        out = out + dense_ffn(params["shared"], xf, cfg.activation)
    return out.reshape(b, s, d), aux
