"""Pod dry-run: count every (arch x input shape x mesh) step on meta tensors.

The reference fakes 512 host devices, lowers and compiles each step with
XLA and reads the compiled memory and HLO analyses.  Here each step runs
once on ``"meta"`` tensors, which carry shapes and dtypes and allocate
nothing, under the op counter of ``analysis/counts.py``; no environment
preamble and no devices are needed.  The record keeps the reference's
keys, so records from both packages read alike:

* ``lower_s``: building the abstract inputs; ``compile_s``: the counted
  meta run;
* ``cost_analysis``: the global ``flops`` and ``bytes accessed``;
* ``memory_analysis``: ``argument_size_in_bytes`` and
  ``output_size_in_bytes`` per device, exact from the specs: each leaf's
  shard (each dim split by the product of the mesh axes its spec names,
  rounded up) in its dtype.  Outputs shard as the matching inputs (new
  parameters and moments as the old, caches by ``cache_specs`` over the
  data axes, logits over the batch axes, the loss replicated);
* ``hlo``: ``parameter_bytes_per_device`` (the model parameters' shards;
  the reference's HLO count takes every entry parameter, which is
  ``argument_size_in_bytes`` here), ``flops_per_device`` and
  ``dot_bytes_per_device``, the collectives, and ``num_whiles`` /
  ``unresolved_trip_counts`` (0: no loop to recover);
* ``source: "torch-meta"`` and ``partition``, the rule below.

Per device: the FLOPs and dot bytes are counted on the global program
and divided by the devices that split it, the batch shards times the
model-axis size, where the batch shards are the data axes when the
global batch divides them (``batch2d``: all devices) and 1 when it does
not (``long_500k``'s batch of 1).  That is an ideal partition, not a
compiler's: no replicated work, no padding, no resharding.

Collectives: GSPMD's have no counterpart here.  ``tp_shardmap`` and
``moe_shardmap`` record the psums the program states (``models/lm/tp.py``,
``moe.py``) at their per-device bytes; every other variant writes
``collective_bytes_per_device: {}`` and ``collectives: "not modelled"``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
  ... --multipod          # 2-pod (2,16,16) mesh instead of (16,16)
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

from repro_torch.analysis.counts import count_step
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, InputShape, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (
    abstract_decode_inputs,
    abstract_prefill_inputs,
    abstract_train_inputs,
)
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models.lm import moe as moe_mod
from repro_torch.models.lm import tp as tp_mod
from repro_torch.models.lm.sharding import (
    batch_specs,
    cache_specs,
    data_axes,
    entry_axes,
    param_specs,
    spec_leaves,
)
from repro_torch.utils.tree import tree_leaves

__all__ = ["build_lowerable", "reset_switches", "dryrun_one", "shard_bytes", "main", "PARTITION"]

PARTITION = ("ideal: global counts / (batch shards x model axis); batch shards = the data "
             "axes when the global batch divides them, else 1")
_MODELLED = ("tp_shardmap", "moe_shardmap")


def _shape(shape: str | InputShape) -> InputShape:
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def _is_long(shape: InputShape) -> bool:
    return shape.name == "long_500k"


def reset_switches() -> None:
    """Every variant switch of ``tp.py`` and ``moe.py`` back to baseline."""
    tp_mod.set_tp_context(None)
    tp_mod.set_bf16_barrier(False)
    tp_mod.set_remat_policy(None)
    tp_mod.set_rwkv_chunked(False)
    moe_mod.set_shard_map_context(None)


def _batch_shards(mesh, batch: int) -> int:
    n = math.prod(mesh.shape[a] for a in data_axes(mesh))
    return n if batch % n == 0 else 1


def build_lowerable(arch: str, shape: str | InputShape, mesh, variant: str = "baseline"):
    """Returns ``(fn, args, in_specs)``: the step, its meta inputs and
    their specs, with the variant's switches set (the caller resets them
    with :func:`reset_switches`).

    ``variant`` is a comma-separated set of switches:
      baseline      the paper-faithful configuration
      moe_shardmap  explicit expert-parallel MoE (``moe._moe_ffn_shard_map``)
      mla_absorb    matrix-absorbed MLA decode
      batch2d       train/prefill batch sharded over (data, model)
      tp_shardmap   the row-parallel products' psum stated explicitly
      bf16_psum     the reference's barrier before that psum (a flag here)
      remat_dots    save the products' outputs under each repeat's remat
      rwkv_chunked  chunked WKV6 prefill
    """
    variants = set(variant.split(","))
    cfg = get_config(arch)
    shape = _shape(shape)
    ba = data_axes(mesh)
    if "batch2d" in variants and shape.kind in ("train", "prefill"):
        ba2 = ba + ("model",)
        if shape.global_batch % math.prod(mesh.shape[a] for a in ba2) == 0:
            ba = ba2  # else: batch too small for the extra axis; keep 1D
    reset_switches()
    if "tp_shardmap" in variants:
        tp_mod.set_tp_context(mesh, "model")
    tp_mod.set_bf16_barrier("bf16_psum" in variants)
    tp_mod.set_remat_policy("dots" if "remat_dots" in variants else None)
    tp_mod.set_rwkv_chunked("rwkv_chunked" in variants)
    if "moe_shardmap" in variants and cfg.moe is not None:
        moe_data_axes = () if shape.global_batch == 1 else tuple(a for a in ba if a != "model")
        moe_mod.set_shard_map_context(mesh, moe_data_axes, "model")

    if shape.kind == "train":
        params, opt_state, batch = abstract_train_inputs(cfg, shape)
        fn = make_train_step(cfg)
        # optimizer moments shard like their parameters; step is replicated
        opt_specs = {"m": param_specs(params), "v": param_specs(params), "step": ()}
        in_specs = (param_specs(params), opt_specs, batch_specs(batch, ba))
        args = (params, opt_state, batch)
    elif shape.kind == "prefill":
        params, batch = abstract_prefill_inputs(cfg, shape)
        fn = make_prefill_step(cfg, cache_size=shape.seq_len)
        in_specs = (param_specs(params), batch_specs(batch, ba))
        args = (params, batch)
    else:  # decode
        long_mode = _is_long(shape)
        params, tokens, caches, cache_len = abstract_decode_inputs(cfg, shape, long_mode=long_mode)
        fn = make_serve_step(cfg, long_mode=long_mode, mla_absorb="mla_absorb" in variants)
        bspec = () if shape.global_batch == 1 else ba
        in_specs = (
            param_specs(params),
            batch_specs({"tokens": tokens}, bspec)["tokens"],
            cache_specs(caches, bspec),
            (),
        )
        args = (params, tokens, caches, cache_len)
    return fn, args, in_specs


def _out_specs(shape: InputShape, in_specs, out) -> tuple:
    if shape.kind == "train":
        return in_specs[0], in_specs[1], ()
    logits, caches = out
    first = next(iter(in_specs[1].values())) if shape.kind == "prefill" else in_specs[1]
    ba = entry_axes(first[0])  # the batch dim's axes
    return batch_specs(logits, ba), cache_specs(caches, tuple(a for a in ba if a != "model"))


def shard_bytes(tree, spec_tree, mesh) -> int:
    """Per-device bytes of ``tree`` sharded by ``spec_tree`` on ``mesh``:
    each leaf's dims split by the product of the axes its spec names for
    them, rounded up, times its element size."""
    leaves, specs = tree_leaves(tree), spec_leaves(spec_tree)
    if len(leaves) != len(specs):
        raise ValueError(f"{len(leaves)} leaves against {len(specs)} specs")
    total = 0
    for t, spec in zip(leaves, specs):
        if len(spec) > t.dim():
            raise ValueError(f"spec {spec} for a {t.dim()}-d leaf")
        n = t.element_size()
        for i, size in enumerate(t.shape):
            axes = entry_axes(spec[i]) if i < len(spec) else ()
            n *= -(-size // math.prod(mesh.shape[a] for a in axes))
        total += n
    return total


def dryrun_one(
    arch: str,
    shape: str | InputShape,
    *,
    multi_pod: bool = False,
    verbose: bool = True,
    variant: str = "baseline",
    mesh=None,
) -> dict:
    """Count one step on meta tensors; returns the record.  ``mesh``
    defaults to the production mesh (``multi_pod`` picks it)."""
    shape = _shape(shape)
    mesh = make_production_mesh(multi_pod=multi_pod) if mesh is None else mesh
    t0 = time.perf_counter()
    try:
        fn, args, in_specs = build_lowerable(arch, shape, mesh, variant)
        t_lower = time.perf_counter() - t0
        out, counts = count_step(fn, *args)
        t_compile = time.perf_counter() - t0 - t_lower
    finally:
        reset_switches()

    split = _batch_shards(mesh, shape.global_batch) * mesh.shape["model"]
    modelled = any(v in _MODELLED for v in variant.split(","))
    rec: dict = {
        "arch": arch,
        "shape": shape.name,
        "variant": variant,
        "mesh": mesh.label(),
        "devices": int(mesh.size),
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "cost_analysis": {"flops": counts.flops, "bytes accessed": counts.bytes_accessed},
        "memory_analysis": {
            "argument_size_in_bytes": shard_bytes(args, in_specs, mesh),
            "output_size_in_bytes": shard_bytes(
                out, _out_specs(shape, in_specs, out), mesh),
        },
        "hlo": {
            "flops_per_device": counts.flops / split,
            "dot_bytes_per_device": counts.dot_bytes / split,
            "collective_bytes_per_device": counts.collective_bytes if modelled else {},
            "collective_counts": counts.collective_counts if modelled else {},
            "parameter_bytes_per_device": shard_bytes(args[0], in_specs[0], mesh),
            "num_whiles": counts.num_whiles,
            "unresolved_trip_counts": counts.unresolved_trip_counts,
        },
        "source": "torch-meta",
        "partition": PARTITION,
        "collectives": "recorded psums" if modelled else "not modelled",
    }
    if verbose:
        h = rec["hlo"]
        coll = sum(h["collective_bytes_per_device"].values())
        print(
            f"[dryrun] {arch:24s} {shape.name:12s} mesh={rec['mesh']:8s} "
            f"compile={rec['compile_s']:7.1f}s flops/dev={h['flops_per_device']:.3e} "
            f"coll/dev={coll:.3e}B"
        )
    return rec


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true", help="all 40 arch x shape combos")
    ap.add_argument("--out", default=None, help="write one JSON per combo under this dir")
    ap.add_argument("--variant", default="baseline", help="comma-separated perf switches")
    args = ap.parse_args(argv)

    combos = (
        [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
        if args.all
        else [(args.arch, args.shape)]
    )
    records = []
    for arch, shape in combos:
        rec = dryrun_one(arch, shape, multi_pod=args.multipod, variant=args.variant)
        records.append(rec)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            tag = f"{arch}_{shape}_{rec['mesh']}_{args.variant}".replace("/", "-").replace(",", "+")
            tag = tag.replace("_baseline", "")
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
    ok = sum("cost_analysis" in r or "memory_analysis" in r for r in records)
    print(f"[dryrun] {len(records)} combos compiled, {ok} with analyses")
    return records


if __name__ == "__main__":
    main()
