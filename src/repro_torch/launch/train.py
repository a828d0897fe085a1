"""Training CLI: ``python -m repro_torch.launch.train --arch yi-6b --smoke``.

Runs on the card unless ``--device cpu`` is given (and raises without a
card otherwise).  ``--smoke`` takes the reduced config; without it the
full config, whose depth ``--layers`` can cut for a model too large for
one card.  Batches come from the synthetic token stream; the
encoder-decoder's ``src_embeds`` are drawn from a seeded generator on the
device, and M-RoPE configs get ``default_positions``.  Checkpoints via
``repro_torch.checkpoint``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint.io import save_checkpoint
from repro_torch.configs import get_config, get_smoke
from repro_torch.data.tokens import TokenStream, batches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm.model import default_positions, init_params
from repro_torch.optim.adamw import init_adamw


def main(argv: list[str] | None = None) -> list[float]:
    """Run the CLI; returns the loss of every step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--save", default=None, help="checkpoint path (.npz)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to the first N layers (a multiple of the arch's "
                         "pattern period), for a model too large for one card")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = init_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                         device=device)
    opt_state = init_adamw(params)
    step_fn = make_train_step(cfg, base_lr=args.lr)
    src_gen = torch.Generator(device=device).manual_seed(1)

    stream = TokenStream(vocab=cfg.vocab, seed=0)
    t0 = time.perf_counter()
    losses = []
    for i, batch_np in enumerate(batches(stream, batch=args.batch, seq=args.seq, steps=args.steps)):
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch_np.items()}
        if cfg.input_mode == "embeds" and cfg.encoder_layers == 0:
            batch["embeds"] = params["embed"][batch.pop("tokens").long()].float()
        if cfg.encoder_layers > 0:
            batch["src_embeds"] = torch.randn((args.batch, args.seq, cfg.d_model),
                                              generator=src_gen, device=device)
        if cfg.rope_kind == "mrope" and "positions" not in batch:
            batch["positions"] = default_positions(cfg, args.batch, args.seq, device=device)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        losses.append(float(loss))
        if (i + 1) % args.log_every == 0:
            dt = time.perf_counter() - t0
            print(
                f"step {i+1:5d} loss {np.mean(losses[-args.log_every:]):.4f} "
                f"({dt/ (i+1):.2f}s/step)"
            )
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    if args.save:
        save_checkpoint(args.save, {"params": params, "opt": opt_state})
        print(f"saved checkpoint to {args.save}")
    return losses


if __name__ == "__main__":
    main()
