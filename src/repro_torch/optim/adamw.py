"""AdamW with fp32 moments over (possibly bf16) parameters + cosine schedule.

Functional, as the reference's: ``adamw_update`` returns new parameter and
state trees and leaves its inputs as they were.  Each leaf is updated in
one pass, in the reference's order of operations (``src/repro/optim/
adamw.py``); ``step`` is a 0-d int32 tensor on the parameters' device.
"""

from __future__ import annotations

import math

import torch

from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["init_adamw", "adamw_update", "cosine_schedule"]


def init_adamw(params) -> dict:
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros32, params),
        "v": tree_map(zeros32, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def cosine_schedule(step: torch.Tensor, *, base_lr=3e-4, warmup=100, total=10_000,
                    min_frac=0.1) -> torch.Tensor:
    step = step.float()
    warm = step / max(warmup, 1)
    t = torch.clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return base_lr * torch.where(step < warmup, warm, cos)


@torch.no_grad()
def adamw_update(
    params,
    grads,
    state: dict,
    *,
    lr=None,
    base_lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
):
    step = state["step"] + 1
    lr_t = cosine_schedule(step, base_lr=base_lr) if lr is None else lr
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    new_m, new_v = [], []  # in the order tree_map visits params' leaves

    def upd(p, g, m, v):
        g32 = g.float()
        m_new = b1 * m + (1 - b1) * g32
        v_new = b2 * v + (1 - b2) * g32 * g32
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        p32 = p.float()
        new_m.append(m_new)
        new_v.append(v_new)
        return (p32 - lr_t * (update + weight_decay * p32)).to(p.dtype)

    new_params = tree_map(upd, params, grads, state["m"], state["v"])
    return new_params, {"m": tree_unflatten(params, new_m), "v": tree_unflatten(params, new_v),
                        "step": step}
