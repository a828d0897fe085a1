"""Step functions the launchers call: train_step / prefill_step / serve_step."""

from __future__ import annotations

import torch

from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.model import decode_step, prefill, train_loss
from repro_torch.optim.adamw import adamw_update
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step"]


def make_train_step(cfg: LMConfig, *, base_lr: float = 3e-4):
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``:
    the loss and its gradient over every parameter leaf, then AdamW.  The
    trees passed in are left as they were."""

    def train_step(params, opt_state, batch):
        tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss = train_loss(tracked, batch, cfg)
            grads = torch.autograd.grad(loss, tree_leaves(tracked))
        new_params, new_opt = adamw_update(params, tree_unflatten(params, list(grads)),
                                           opt_state, base_lr=base_lr)
        return new_params, new_opt, loss.detach()

    return train_step


def make_prefill_step(cfg: LMConfig, *, cache_size: int | None = None, long_mode: bool = False):
    def prefill_step(params, batch):
        return prefill(params, batch, cfg, cache_size=cache_size, long_mode=long_mode)

    return prefill_step


def make_serve_step(cfg: LMConfig, *, long_mode: bool = False, mla_absorb: bool = False):
    def serve_step(params, tokens, caches, cache_len):
        return decode_step(
            params, tokens, caches, cache_len, cfg, long_mode=long_mode, mla_absorb=mla_absorb
        )

    return serve_step
