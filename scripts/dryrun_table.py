#!/usr/bin/env python3
"""Tabulate the PyTorch port's dry-run records with H100 roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
    python3 scripts/dryrun_table.py [DIR]

Reads every ``*.json`` record under ``DIR`` (default
``results/dryrun_torch``) and prints a markdown table with one row per
arch and mesh: the parameter bytes per device, and for each input shape
the FLOPs and dot bytes per device and the bound at the H100 SXM's
published peaks (``repro_torch.launch.mesh.HW``, not measured): the
larger of ``compute_s`` = FLOPs / bf16 peak and ``memory_s`` = dot bytes
/ HBM3 rate, marked ``o`` (operations) or ``b`` (bytes).  Then the host
seconds the records took (inputs and counted runs), in all and for the
slowest record.  Imports nothing of JAX and needs no card.
"""

from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import HW

    folder = pathlib.Path(argv[0]) if argv else ROOT / "results" / "dryrun_torch"
    records = [json.loads(p.read_text()) for p in sorted(folder.glob("*.json"))]
    if not records:
        print(f"no records under {folder}", file=sys.stderr)
        return 1
    by_arch: dict = {}
    for r in records:
        by_arch.setdefault((r["arch"], r["mesh"]), {})[r["shape"]] = r
    print("| Arch (mesh) | Param bytes/dev | " + " | ".join(
        f"{s}: FLOPs/dev, dot bytes/dev, bound s" for s in SHAPES) + " |")
    print("| --- | --- |" + " --- |" * len(SHAPES))
    for (arch, mesh), recs in by_arch.items():
        cells = []
        for s in SHAPES:
            if s not in recs:
                cells.append("not run")
                continue
            h = recs[s]["hlo"]
            compute = h["flops_per_device"] / HW["peak_flops_bf16"]
            memory = h["dot_bytes_per_device"] / HW["hbm_bw"]
            cells.append(f"{h['flops_per_device']:.3e}, {h['dot_bytes_per_device']:.3e}, "
                         f"{max(compute, memory):.3g} {'o' if compute >= memory else 'b'}")
        param = next(iter(recs.values()))["hlo"]["parameter_bytes_per_device"]
        print(f"| {arch} ({mesh}) | {param:.4g} | " + " | ".join(cells) + " |")
    seconds = {(r["arch"], r["shape"]): r["lower_s"] + r["compile_s"] for r in records}
    slowest = max(seconds, key=seconds.get)
    print(f"\n{len(records)} records, {sum(seconds.values()):.1f} host s in all; the slowest "
          f"{' '.join(slowest)} {seconds[slowest]:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
