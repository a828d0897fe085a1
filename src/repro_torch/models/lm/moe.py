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
every run.  ``set_shard_map_context`` with a mesh selects the
reference's expert-parallel form (``_moe_ffn_shard_map``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import randn
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.tp import maybe_row_parallel, model_axis_psum

__all__ = [
    "init_moe_params",
    "moe_ffn",
    "init_dense_ffn",
    "dense_ffn",
    "moe_capacity",
    "set_shard_map_context",
    "silu",
    "top_k",
]


# (mesh, data_axes, model_axis): when set (by the dry-run's moe_shardmap
# variant), moe_ffn runs the expert-parallel dispatch.
_SHARD_MAP_CTX: tuple | None = None


def set_shard_map_context(mesh=None, data_axes: tuple = (), model_axis: str = "model") -> None:
    """Enable (or with ``mesh=None`` disable) the expert-parallel MoE."""
    global _SHARD_MAP_CTX
    _SHARD_MAP_CTX = None if mesh is None else (mesh, tuple(data_axes), model_axis)


def _init(generator: torch.Generator, shape, dtype, device, fan_in=None) -> torch.Tensor:
    """Normal draws scaled by ``1/sqrt(fan_in)`` (default ``shape[-2]``)."""
    fan_in = fan_in if fan_in is not None else shape[-2]
    w = randn(shape, generator, device) / math.sqrt(fan_in)
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


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: the ``k`` largest values, and their
    indices, with equal values taken lowest index first (``torch.topk``
    leaves that order unspecified).  Values carry their gradient."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


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
    if _SHARD_MAP_CTX is not None:
        return _moe_ffn_shard_map(params, x, cfg, *_SHARD_MAP_CTX)
    b, s, d = x.shape
    out, probs, expert_idx = _dispatch(params, x.reshape(b * s, d), cfg, 0, cfg.moe.n_experts)
    # The aux before the shared expert: a checkpointed repeat's recompute
    # stops after the last op that saves a tensor, so the shared expert's
    # output product is not run again in the backward pass.
    aux = _aux(probs, expert_idx, cfg)
    if "shared" in params:
        out = out + dense_ffn(params["shared"], x.reshape(b * s, d), cfg.activation)
    return out.reshape(b, s, d), aux


def _aux(probs: torch.Tensor, expert_idx: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """Load-balance aux loss (Switch-style): E * sum_e f_e * p_e."""
    e = cfg.moe.n_experts
    pe = probs.mean(0)
    flat_e = expert_idx.reshape(-1)  # [T*k]
    # Integer counts in float32 (exact below 2**24 per expert), as a
    # scatter-add: torch.bincount has no meta kernel (the dry-run).
    counts = torch.zeros(e, dtype=torch.float32, device=probs.device)
    fe = counts.scatter_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.float32))
    return e * torch.sum(fe / flat_e.numel() * pe)


def _dispatch(params: dict, xf: torch.Tensor, cfg: LMConfig, e_start: int, e_loc: int):
    """Route tokens ``xf`` [T, d] through experts ``[e_start, e_start +
    e_loc)`` (``params["we*"]`` holds exactly those).  Returns the
    gate-weighted sum of each token's kept rows [T, d], the router
    probabilities [T, E] and the top-k expert ids [T, k]; assignments to
    other experts, and rows over capacity, add nothing."""
    m = cfg.moe
    t, d = xf.shape
    k = m.top_k
    cap = moe_capacity(t, cfg)
    dev = xf.device

    probs = torch.softmax(xf.float() @ params["router"], dim=-1)  # [T, E]
    gate_vals, expert_idx = top_k(probs, k)  # [T, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- sort-based dispatch; e_loc is the out-of-range bin ------------
    flat_e = expert_idx.reshape(-1)  # [T*k]
    local_e = torch.where((flat_e >= e_start) & (flat_e < e_start + e_loc), flat_e - e_start,
                          e_loc)
    sort_idx = torch.argsort(local_e, stable=True)
    sorted_e = local_e[sort_idx]
    starts = torch.searchsorted(sorted_e, torch.arange(e_loc, device=dev, dtype=sorted_e.dtype))
    rank = torch.arange(t * k, device=dev) - starts[sorted_e.clamp_max(e_loc - 1)]
    keep = (sorted_e < e_loc) & (rank < cap)
    dest = torch.where(keep, sorted_e * cap + rank, e_loc * cap)  # overflow slot
    token_of = sort_idx // k

    buf = torch.zeros((e_loc * cap + 1, d), dtype=xf.dtype, device=dev)
    buf[dest] = xf[token_of]  # only the discarded overflow slot repeats
    buf = buf[:-1].reshape(e_loc, cap, d)

    # ---- expert compute (batched products over the experts) -----------
    h = _act(torch.bmm(buf, params["we1"]), cfg.activation) * torch.bmm(buf, params["we3"])
    y = torch.bmm(h, params["we2"])  # [E_loc, C, d]

    # ---- combine: each token's k rows, added in ascending expert id ---
    yf = y.reshape(e_loc * cap, d)
    gathered = torch.where(keep[:, None], yf[dest.clamp_max(e_loc * cap - 1)], 0)
    w = gate_vals.reshape(-1)[sort_idx][:, None].to(xf.dtype)
    rows = torch.empty((t * k, d), dtype=xf.dtype, device=dev)
    rows[sort_idx] = gathered * w  # row i*k + j: token i's j-th top-k choice
    order = torch.argsort(expert_idx, dim=1)  # ascending expert id per token
    rows = rows.reshape(t, k, d).gather(1, order[:, :, None].expand(t, k, d))
    out = torch.zeros((t, d), dtype=xf.dtype, device=dev)
    for j in range(k):
        out = out + rows[:, j]
    return out, probs, expert_idx


# --------------------------------------------- explicit expert parallelism


def _moe_ffn_shard_map(params: dict, x: torch.Tensor, cfg: LMConfig, mesh, data_axes: tuple,
                       model_axis: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Megatron-style MoE: tokens sharded on ``data_axes``, experts on
    ``model_axis``; each device routes its own tokens through its own
    block of experts (capacity from its local token count), adds its part
    of the tensor-parallel shared expert, and ONE psum of the ``[T_local,
    d]`` output over the model axis sums the parts.  ``data_axes=()``
    (batch-1 shapes) leaves tokens replicated over data.

    ``_dispatch`` is the reference's per-device function: given a model
    shard's expert range it routes every token and keeps only that
    range's assignments, so the psum of the M shards' outputs is the
    dispatch over all experts.  Here one call per data shard takes every
    expert at once.  On a 1 x 1 mesh that is the function itself (the
    psum and the aux's mean over data are the identity).  A larger mesh
    runs only on ``"meta"`` tensors, the dry-run's global view: capacity
    per local tokens as on the devices, the router and the gating counted
    once per data shard (each of the M model shards repeats them, 2 *
    T_local * d * E FLOPs), the shared expert once, and the psum recorded
    at its per-device bytes (``tp.model_axis_psum``).  On real tensors a
    larger mesh raises."""
    n_data = math.prod(mesh.shape[a] for a in data_axes)
    b, s, d = x.shape
    if x.device.type != "meta" and mesh.size > 1:
        raise RuntimeError(
            f"expert parallelism over a {dict(mesh.shape)} mesh needs {mesh.size} cards; this "
            "program runs it only on meta tensors (the dry-run)")
    if b % n_data != 0:
        raise ValueError(f"batch {b} does not split over data axes {data_axes} ({n_data})")
    xf = x.reshape(b * s, d)
    parts = [_dispatch(params, xs, cfg, 0, cfg.moe.n_experts)
             for xs in xf.reshape(n_data, -1, d)]  # one data shard's tokens each
    out = torch.cat([part[0] for part in parts])
    aux = torch.stack([_aux(probs, idx, cfg) for _, probs, idx in parts]).mean()
    if "shared" in params:
        sp = params["shared"]
        hs = xf @ sp["w1"]
        hs = _act(hs, cfg.activation) * (xf @ sp["w3"]) if "w3" in sp else _act(hs, cfg.activation)
        out = out + hs @ sp["w2"]  # partial over the model-sharded ff dim
    out = model_axis_psum(out, mesh, model_axis, data_axes)
    return out.reshape(b, s, d), aux
