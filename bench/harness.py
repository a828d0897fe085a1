"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration in ``bench/configs/<config>.json``, the configuration's
model in ``bench/models/<model>.py`` (see ``bench/models/__init__.py``), its
traffic in ``bench/traffic/<mix>.json`` (read by ``bench/generator.py``; its
``kind`` picks the entry in ``bench/drive.py``), and each metric's reader in
``bench/metrics/<metric>.py``, whose ``read(ctx)`` returns a number or
``None`` when it finds nothing to read.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import pathlib
import subprocess
import sys
import time

import torch

from bench import check, drive, models
from bench.data import make_graph
from bench.flops import full_graph_flops, sampled_flops
from bench.generator import load_mix

__all__ = ["FORBIDDEN", "cell_spec", "run_cell"]

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cell_spec(cell: str) -> tuple[dict, dict, dict, dict]:
    """``(benchmark, workload entry, configuration, mix)`` of a cell.  A
    ``<config>.<mix>`` that is no cell of ``BENCHMARK.json`` (the served
    mix, which the tests and ``bench/sweep.py`` drive) is read from its
    files alone.  Raises ``FileNotFoundError`` naming the model's file where
    the configuration's model has none."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        config_name, traffic = cell.split(".", 1)
        entry = {"name": cell, "config": config_name, "traffic": traffic, "chips": 1}
    config = json.loads((HERE / "configs" / f"{entry['config']}.json").read_text())
    models.find(config["model"])
    return bench, entry, config, load_mix(entry["traffic"])


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", HERE / "metrics" / f"{name}.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [
        m for m in bench["per_layer"]
        if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)
    ]


def _power_limit() -> str | None:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 and proc.stdout else None


def run_cell(
    cell: str,
    seed: int,
    seconds: float,
    trace: bool,
    *,
    device: str = "cuda",
    t_start: float | None = None,
    overrides: dict | None = None,
    control: bool = False,
    log=lambda msg: print(msg, file=sys.stderr, flush=True),
) -> dict:
    """Run ``cell`` once and return the result line as a dict.

    ``overrides`` (tests only) replaces configuration and mix keys
    (``{"config": {...}, "mix": {...}, "scale": s}``), so a CPU test can run
    a cell at a size a test run holds.  ``control`` also puts the reference,
    in float32 with TF32 on, in the program's place, and adds its compared
    numbers under ``"control"`` (``bench/control.py``; never in a cell's run)."""
    t0 = time.perf_counter() if t_start is None else t_start
    overrides = overrides or {}
    bench, _, config, mix = cell_spec(cell)
    config = {**config, **overrides.get("config", {})}
    mix = {**mix, **overrides.get("mix", {})}
    model = models.load(config["model"])
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    if dev.type == "cuda":
        torch.zeros(1, device=dev)  # the context, so its start shows apart
    marks = {"context": time.perf_counter()}
    data = make_graph(config["dataset"], seed, device=dev, scale=overrides.get("scale", 1.0))
    params = drive.make_params(config, seed, dev)
    marks["inputs"] = time.perf_counter()
    holder: dict = {}
    out = drive.RUNS[mix["kind"]](config, mix, data, params, seed, seconds, dev, trace, holder, marks)
    setup_s = marks["warm"] - t0
    log(
        f"setup parts: start and context {marks['context'] - t0:.3f} s, inputs "
        f"{marks['inputs'] - marks['context']:.3f} s, prepare "
        f"{marks['prepared'] - marks['inputs']:.3f} s (prep_seconds {out.prep_s:.3f} s), "
        f"warm {marks['warm'] - marks['prepared']:.3f} s; window {out.window_s:.3f} s"
    )
    alloc, hits = out.allocation, out.hits
    log(
        "program: "
        + (f"eq1 adj share {100 * alloc['adj_bytes'] / max(alloc['total_bytes'], 1):.3f}%, " if alloc else "")
        + f"adj hits {hits['adj_hits']}/{hits['adj_lookups']}, "
        f"feat hits {hits['feat_hits']}/{hits['feat_lookups']}, attempted {out.attempted}"
    )
    if out.pass_seconds:
        log("pass seconds: " + ", ".join(f"{t:.3f}" for t in out.pass_seconds))
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers, counts = check.compare(config, mix, data, params, out, seed, device=dev)
    log(f"check {time.perf_counter() - t_check:.3f} s")
    correct = all(value <= limit for value, limit in numbers.values())

    dims = model.dims(config)
    if mix["kind"] == "layerwise":
        lc = out.layer_counts
        gather_groups = [
            (lc["feat_hits"], lc["feat_lookups"] - lc["feat_hits"], lc["feat_row_bytes"]),
            (lc["embed_hits"], lc["embed_lookups"] - lc["embed_hits"], lc["embed_row_bytes"]),
        ]
        flops = out.passes * full_graph_flops(
            config["model"], data.num_nodes, data.num_edges, dims, config
        )
    else:
        gather_groups = counts.get("gather_groups")
        per = sampled_flops(config["model"], mix["batch_size"], config["fanouts"], dims, config)
        flops = per * (out.nodes // mix["batch_size"])
    ctx = dict(
        cell=cell, config=config, mix=mix, outcome=out, setup_s=setup_s,
        trace=holder.get("trace"), prep_s=out.prep_s, allocation=out.allocation,
        hits=out.hits, gather_groups=gather_groups, flops=flops, model=model,
    )
    metrics = {}
    for m in _cell_metrics(bench, cell, trace):
        value = _reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "count": 1,
        "memory_peak_bytes": int(out.memory_peak_bytes),
    }
    if ctx["trace"] is not None:
        device_info["busy_s"] = ctx["trace"]["busy_s"]
        device_info["window_s"] = ctx["trace"]["window_s"]
    result = {
        "correct": bool(correct),
        "attempted": int(out.attempted),
        "failed": int(numbers["missing"][0]),
        "metrics": metrics,
        "device": device_info,
    }
    if ctx["trace"] is not None:
        result["breakdown"] = ctx["trace"]["breakdown"]
    if control:
        gc.collect()
        ctl, _ = check.compare(config, mix, data, params, out, seed, device=dev, tf32=True)
        result["control"] = {k: {"value": v, "limit": lim} for k, (v, lim) in ctl.items()}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    if dev.type == "cuda":
        log(f"card: {_power_limit()}")
    return result
