"""The device's timeline over the measured window, from ``torch.profiler``.

``window()`` wraps the window in a profiler (CPU and CUDA activities) and
a ``bench.window`` annotation; ``read()`` parses the exported Chrome trace
and returns, inside the annotation's span: the seconds in which a kernel,
copy or set ran (the union of their intervals), the device seconds of
each kernel name, and the breakdown the result line carries (the ten
device operations that took most time, and the ten idle gaps' owners:
the runtime call the host was in while the card idled, or "host (between
calls)" where it was in none).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile

import torch

__all__ = ["read", "window"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
BETWEEN = "host (between calls)"
NAME_CHARS = 96  # a kernel's name is cut here, where templates run on


@contextlib.contextmanager
def window(enabled: bool, holder: dict):
    """Profile the body when ``enabled``; ``holder["trace"]`` receives
    :func:`read`'s result."""
    if not enabled:
        yield
        return
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    )
    with prof:
        with torch.profiler.record_function(WINDOW):
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        holder["trace"] = read(path)


def _union(intervals):
    """Merged, sorted ``[start, end)`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def read(path: str) -> dict:
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    span = None
    device, runtime = [], []
    per_name = collections.Counter()
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, ts, dur = ev.get("cat", ""), float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur))
            per_name[ev["name"][:NAME_CHARS]] += dur
        elif cat in RUNTIME_CATS:
            runtime.append((ts, ts + dur, ev["name"]))
        elif ev.get("name") == WINDOW and cat in ("user_annotation", "cpu_op"):
            span = (ts, ts + dur)
    if span is None:
        raise RuntimeError("the profiler trace holds no bench.window span")
    lo, hi = span
    busy = _union((max(a, lo), min(b, hi)) for a, b in device if b > lo and a < hi)
    busy_us = sum(b - a for a, b in busy)

    gaps, cursor = [], lo
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if cursor < hi:
        gaps.append((cursor, hi))
    # One sweep: the gaps are disjoint and ascending, so each runtime call
    # joins the active list once and leaves it once it ends before a gap.
    runtime.sort()
    owners = collections.Counter()
    active, i = [], 0
    for a, b in gaps:
        while i < len(runtime) and runtime[i][0] < b:
            active.append(runtime[i])
            i += 1
        active = [r for r in active if r[1] > a]
        covered = 0.0
        for s, e, name in active:
            overlap = min(e, b) - max(s, a)
            if overlap > 0:
                owners[name] += overlap
                covered += overlap
        owners[BETWEEN] += max((b - a) - covered, 0.0)
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": (hi - lo) * 1e-6,
        "kernel_s": {k: v * 1e-6 for k, v in per_name.items()},
        "breakdown": {
            "device_ops": [[k, v * 1e-6] for k, v in per_name.most_common(10)],
            "idle_gaps": [[k, v * 1e-6] for k, v in owners.most_common(10)],
        },
    }
