#!/usr/bin/env python3
"""Time B5 ``flash_attention`` of the PyTorch port at Gemma-2 27B's shapes.

    python3 scripts/time_attention.py [--src DIR] [--reps N]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so that two trees (a parent unpacked beside the checkout, and the change)
can be timed on one card in one session, in turns.  Shapes: B 1, Hq 32,
Hkv 16, D 128, Sk 4096, window 4096, softcap 50; prefill (Sq 4096,
causal) and decode (Sq 1), each in bfloat16 and float32 (the float32
inputs are the bfloat16 ones, upcast).  Times are CUDA events around
``--reps`` calls after one warmup call.  Prints one JSON line: the card
as ``nvidia-smi`` names it with its power limit, and per case the mean
milliseconds and, where the tree counts them, the design each call took.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED = 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=pathlib.Path, default=ROOT / "src")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_attention: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels.flash_attention import kernel as fa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k = torch.randn((1, 16, 4096, 128), generator=gen, device="cuda").bfloat16()
    v = torch.randn((1, 16, 4096, 128), generator=gen, device="cuda").bfloat16()
    rows = {}
    for label, sq, causal in (("prefill", 4096, True), ("decode", 1, False)):
        q = torch.randn((1, 32, sq, 128), generator=gen, device="cuda").bfloat16()
        kw = dict(causal=causal, window=4096, softcap=50.0)
        for dtype in (torch.bfloat16, torch.float32):
            args_ = tuple(t.to(dtype) for t in (q, k, v))
            designs = getattr(fa.flash_attention, "design_launches", None)
            before = dict(designs) if designs is not None else None
            fa.flash_attention(*args_, **kw)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                fa.flash_attention(*args_, **kw)
            stop.record()
            torch.cuda.synchronize()
            design = None
            if before is not None:
                design = [d for d, n in fa.flash_attention.design_launches.items()
                          if n != before[d]]
            rows[f"{label}_{str(dtype).split('.')[1]}"] = {
                "ms": start.elapsed_time(stop) / args.reps, "design": design}
    print(json.dumps({"card": card, "src": str(args.src), "reps": args.reps, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
