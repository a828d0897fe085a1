"""Run one benchmark cell traced and print where the host's time went, by the
program's own spans.

    python3 scripts/bench_spans.py --workload <cell> --seed <n> [--seconds 20]

Runs the cell as ``python3 -m bench.run --trace 1`` does and prints its
result line, then, from the tracer the port recorded while the window's
profiler recorded (``repro_torch.core.trace.profiler_session``):
- per span name: count, total and self milliseconds, both per item (an
  item is one executor ``batch`` span);
- the wait spans' count and milliseconds per item, and their count by
  kind (``wait``: ``device``, ``event``, ``read``);
- ``covered``: the share of the window's host time inside the top-level
  host spans (``admit``, the stages and ``retire``; layer-wise also the
  pass's set-up spans), and ``outside``, the rest in seconds;
- ``gaps``: the time between two top-level spans, summed by the names of
  the spans before and after it, the largest first.
The last line is one JSON object with all of it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _covered(spans) -> tuple[float, dict]:
    """Microseconds inside the union of ``spans``, and the time between
    them by the names of the span before and after each gap."""
    total, end, last = 0.0, float("-inf"), None
    gaps: dict = {}
    for a, b, name in sorted(spans):
        if last is not None and a > end:
            key = f"{last} -> {name}"
            gaps[key] = gaps.get(key, 0.0) + (a - end)
        if b > end:
            total += b - max(a, end)
            end, last = b, name
    return total, gaps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)

    from bench import run as bench_run

    bench_run._environment()
    from bench import spans
    from bench.harness import run_cell
    from repro_torch.core.trace import profiler_session

    result = run_cell(args.workload, args.seed, args.seconds, True, t_start=T_START)
    print(json.dumps(result), flush=True)
    s = spans.summary()
    if s is None:
        print("no program spans recorded", file=sys.stderr)
        return 1
    items = spans.items(s)
    table = {
        name: {
            "count": st["count"],
            "total_ms": st["total_ms"],
            "self_ms": st["self_ms"],
            "total_ms_per_item": st["total_ms"] / items,
            "self_ms_per_item": st["self_ms"] / items,
        }
        for name, st in s["stages"].items()
    }
    top = set(spans.DISPATCH) | set(spans.PASS_PREP)
    events = profiler_session().events
    covered_us, gaps = _covered(
        (e["ts"], e["ts"] + e["dur"], e["name"])
        for e in events
        if e["ph"] == "X" and e["name"] in top
    )
    window_s = result["device"]["window_s"]
    for name, row in table.items():
        print(f"{name:>18} {row['count']:>8} {row['total_ms']:>12.3f} ms {row['self_ms']:>12.3f} ms"
              f" {row['total_ms_per_item']:>10.4f} {row['self_ms_per_item']:>10.4f} ms/item")
    line = {
        "workload": args.workload,
        "seed": args.seed,
        "items": items,
        "waits": s["waits"],
        "waits_per_item": s["waits"] / items,
        "wait_ms_per_item": s["wait_ms"] / items,
        "wait_kinds": s["wait_kinds"],
        "window_s": window_s,
        "covered": covered_us / 1e6 / window_s,
        "outside_s": window_s - covered_us / 1e6,
        "gaps": sorted(([k, v / 1e6] for k, v in gaps.items()), key=lambda kv: -kv[1])[:8],
        "spans": table,
    }
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
