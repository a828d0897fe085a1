"""End-to-end tracing and metrics for the inference runtime.

DCI's premise is that cache decisions should follow *measured* workload
behaviour — Eq. 1 splits on stage times, refresh triggers on live miss
rates — but aggregates in ``InferenceReport``/``ServeReport`` cannot show
*when* things happened: whether the pipeline actually overlapped, where a
request sat in the queue, what a refresh epoch paused.  This module is the
timeline half of that story (SALIENT validates its pipelining with exactly
this kind of per-stage timeline analysis):

* :class:`Tracer` — a low-overhead in-memory span/event recorder.  Spans
  (``with tracer.span("gather", lane="slot 0")``), instant events, counter
  tracks, and flow links, all timestamped in microseconds off one
  ``perf_counter`` epoch.  :meth:`Tracer.export` writes Chrome trace-event
  JSON loadable in Perfetto / ``chrome://tracing``.
* :class:`NullTracer` — the disabled path.  Every method is a no-op and
  ``span`` returns a shared reusable context, so instrumented code costs
  one attribute check (``tracer.enabled``) or one no-op call per batch —
  effectively free (gated in ``benchmarks/bench_trace.py``).
* :class:`MetricsRegistry` — labelled counters / gauges / histograms
  (``feat_hit_rate{stream=...,epoch=...}``, ``request_latency_ms``),
  snapshotted into reports and dumpable as JSON or Prometheus text.

Lane model
----------
A *lane* is one horizontal track in the timeline (a Chrome ``tid``).  The
executor maps each pipeline window slot to a lane (``slot 0`` … ``slot
d-1``), so depth-``d`` overlap is *visible* as d stacked lanes with
concurrent batch spans; serving layers add one request-lifecycle lane per
stream (``req:s0`` …), the refresh manager a ``refresh`` lane, sharded
serving an exchange lane per shard.  Lanes are created on first use and
named via Chrome ``M`` (metadata) events.

Tracing is observational only: it reads wall clocks and appends to a host
list, never touching RNG streams, device buffers, or dispatch order — so
traced runs are bit-for-bit identical to untraced runs (equivalence-tested
across the dedup × prefetch × refresh knob grid in tests/test_trace.py).

:func:`validate_trace` / :func:`summarize_trace` are the analysis half,
shared by ``scripts/trace_summary.py`` and the test suite.
"""

from __future__ import annotations

import bisect
import itertools
import json
import math
import time
from typing import Any, Callable, Iterable, Mapping

__all__ = [
    "MetricsRegistry",
    "NULL_TRACER",
    "NullTracer",
    "Tracer",
    "resolve_tracer",
    "summarize_trace",
    "validate_trace",
]

_PID = 1  # single-process runtime; one Chrome "process" named via metadata


class _Span:
    """A single reusable span context (one per ``Tracer.span`` call).

    Timestamps are taken inside ``__enter__``/``__exit__`` so the recorded
    duration brackets exactly the ``with`` body (plus the optional
    ``torch.profiler.record_function`` enter/exit, which is what lines
    device kernels up with the host span in a ``torch.profiler`` capture).
    """

    __slots__ = ("_tracer", "name", "tid", "args", "_t0", "_ann")

    def __init__(self, tracer: "Tracer", name: str, tid: int, args):
        self._tracer = tracer
        self.name = name
        self.tid = tid
        self.args = args
        self._t0 = 0.0
        self._ann = None

    def __enter__(self) -> "_Span":
        ann = self._tracer._annotate
        if ann is not None:
            self._ann = ann(self.name)
            self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
        tr = self._tracer
        ev: dict[str, Any] = {
            "name": self.name,
            "ph": "X",
            "ts": (self._t0 - tr._epoch) * 1e6,
            "dur": (t1 - self._t0) * 1e6,
            "pid": _PID,
            "tid": self.tid,
        }
        if self.args:
            ev["args"] = self.args
        tr._events.append(ev)
        return False


class Tracer:
    """Records spans/instants/counters/flows; exports Chrome trace JSON.

    All timestamps are microseconds relative to the tracer's creation
    (``time.perf_counter`` epoch).  ``profiler_annotations=True``
    additionally wraps every span in ``torch.profiler.record_function`` so
    host spans show up alongside device kernels in a ``torch.profiler``
    trace.
    """

    enabled = True

    def __init__(
        self, *, profiler_annotations: bool = False, process_name: str = "repro-infer"
    ):
        self._epoch = time.perf_counter()
        self._events: list[dict[str, Any]] = []
        self._lanes: dict[str, int] = {}
        self._next_flow = itertools.count(1)
        self._annotate: Callable[[str], Any] | None = None
        if profiler_annotations:
            import torch

            self._annotate = torch.profiler.record_function
        self._meta(0, "process_name", {"name": process_name})

    # -- time ----------------------------------------------------------
    def now_us(self) -> float:
        """Current timestamp on this tracer's clock (µs since creation)."""
        return (time.perf_counter() - self._epoch) * 1e6

    def ts_from(self, perf_t: float) -> float:
        """Convert a raw ``time.perf_counter()`` stamp to tracer µs."""
        return (perf_t - self._epoch) * 1e6

    # -- lanes ---------------------------------------------------------
    def lane(self, name: str) -> int:
        """The ``tid`` for lane ``name``, creating + naming it on first use.

        Lanes sort in creation order (``thread_sort_index``), so the call
        sites control the top-to-bottom layout in Perfetto."""
        tid = self._lanes.get(name)
        if tid is None:
            tid = len(self._lanes) + 1
            self._lanes[name] = tid
            self._meta(tid, "thread_name", {"name": name})
            self._meta(tid, "thread_sort_index", {"sort_index": tid})
        return tid

    def _meta(self, tid: int, what: str, args: dict) -> None:
        self._events.append(
            {"name": what, "ph": "M", "ts": 0.0, "pid": _PID, "tid": tid, "args": args}
        )

    # -- events --------------------------------------------------------
    def span(self, name: str, *, lane: str = "main", args: dict | None = None) -> _Span:
        """Context manager recording one complete (``ph:"X"``) event."""
        return _Span(self, name, self.lane(lane), args)

    def complete(
        self,
        name: str,
        *,
        lane: str,
        ts_us: float,
        dur_us: float,
        args: dict | None = None,
    ) -> None:
        """Record a complete event from explicit timestamps — for spans
        whose start and end are observed in different frames (a batch's
        dispatch→retire window, a request's enqueue→admit wait)."""
        ev: dict[str, Any] = {
            "name": name,
            "ph": "X",
            "ts": ts_us,
            "dur": max(dur_us, 0.0),
            "pid": _PID,
            "tid": self.lane(lane),
        }
        if args:
            ev["args"] = args
        self._events.append(ev)

    def instant(
        self, name: str, *, lane: str = "main", args: dict | None = None, ts_us: float | None = None
    ) -> None:
        ev: dict[str, Any] = {
            "name": name,
            "ph": "i",
            "s": "t",
            "ts": self.now_us() if ts_us is None else ts_us,
            "pid": _PID,
            "tid": self.lane(lane),
        }
        if args:
            ev["args"] = args
        self._events.append(ev)

    def counter(self, name: str, values: Mapping[str, float], *, ts_us: float | None = None) -> None:
        """One sample on counter track ``name`` (one series per key)."""
        self._events.append(
            {
                "name": name,
                "ph": "C",
                "ts": self.now_us() if ts_us is None else ts_us,
                "pid": _PID,
                "tid": 0,
                "args": dict(values),
            }
        )

    # -- flows ---------------------------------------------------------
    def next_flow_id(self) -> int:
        return next(self._next_flow)

    def _flow(self, ph: str, fid: int, name: str, lane: str, ts_us: float | None) -> None:
        ev: dict[str, Any] = {
            "name": name,
            "cat": "flow",
            "ph": ph,
            "id": fid,
            "ts": self.now_us() if ts_us is None else ts_us,
            "pid": _PID,
            "tid": self.lane(lane),
        }
        if ph == "f":
            ev["bp"] = "e"  # bind to the enclosing slice, not the next one
        self._events.append(ev)

    def flow_start(self, fid: int, name: str, *, lane: str, ts_us: float | None = None) -> None:
        self._flow("s", fid, name, lane, ts_us)

    def flow_step(self, fid: int, name: str, *, lane: str, ts_us: float | None = None) -> None:
        self._flow("t", fid, name, lane, ts_us)

    def flow_end(self, fid: int, name: str, *, lane: str, ts_us: float | None = None) -> None:
        self._flow("f", fid, name, lane, ts_us)

    # -- export --------------------------------------------------------
    @property
    def events(self) -> list[dict[str, Any]]:
        return self._events

    def to_chrome(self) -> dict:
        """The trace as a Chrome trace-event JSON object."""
        order = {"M": 0}  # metadata first; everything else by timestamp
        events = sorted(self._events, key=lambda e: (order.get(e["ph"], 1), e["ts"]))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_chrome(), fh)


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The tracing-off fast path: every method is a no-op.

    ``span`` hands back one shared, stateless context object, so a fully
    instrumented hot loop executes a handful of attribute lookups and empty
    calls per batch when tracing is disabled — the overhead gate in
    ``benchmarks/bench_trace.py`` holds this under 1% of end-to-end time.
    Call sites guard any non-trivial argument construction (building an
    ``args`` dict, reading queue depths) behind ``tracer.enabled``.
    """

    enabled = False

    def now_us(self) -> float:
        return 0.0

    def ts_from(self, perf_t: float) -> float:
        return 0.0

    def lane(self, name: str) -> int:
        return 0

    def span(self, name: str, *, lane: str = "main", args: dict | None = None) -> _NullSpan:
        return _NULL_SPAN

    def complete(self, name: str, *, lane: str, ts_us: float, dur_us: float, args=None) -> None:
        pass

    def instant(self, name: str, *, lane: str = "main", args=None, ts_us=None) -> None:
        pass

    def counter(self, name: str, values, *, ts_us=None) -> None:
        pass

    def next_flow_id(self) -> int:
        return 0

    def flow_start(self, fid: int, name: str, *, lane: str, ts_us=None) -> None:
        pass

    def flow_step(self, fid: int, name: str, *, lane: str, ts_us=None) -> None:
        pass

    def flow_end(self, fid: int, name: str, *, lane: str, ts_us=None) -> None:
        pass

    @property
    def events(self) -> tuple:
        return ()


NULL_TRACER = NullTracer()


def resolve_tracer(tracer: Tracer | NullTracer | None) -> Tracer | NullTracer:
    """``tracer`` or the shared no-op singleton — the idiom every runtime
    entry point uses so ``tracer=None`` (the default) costs nothing."""
    return tracer if tracer is not None else NULL_TRACER


# ---------------------------------------------------------------------------
# Trace analysis — shared by scripts/trace_summary.py and tests.
# ---------------------------------------------------------------------------


def _lane_names(events: Iterable[Mapping]) -> dict[int, str]:
    names: dict[int, str] = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            names[e["tid"]] = e.get("args", {}).get("name", str(e["tid"]))
    return names


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Union of ``[start, end)`` intervals, as a sorted disjoint list."""
    out: list[tuple[float, float]] = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def validate_trace(events: Iterable[Mapping]) -> list[str]:
    """Schema errors in a Chrome trace-event list (empty list == valid).

    Checks the acceptance contract: every event carries ``ph/ts/pid/tid``
    and a name, complete events have a non-negative ``dur``, and every flow
    start (``s``) pairs with exactly one flow end (``f``) of the same id.
    """
    errors: list[str] = []
    starts: dict[Any, int] = {}
    ends: dict[Any, int] = {}
    for i, e in enumerate(events):
        for key in ("ph", "ts", "pid", "tid"):
            if key not in e:
                errors.append(f"event {i}: missing {key!r}: {e!r}")
        ph = e.get("ph")
        if ph != "M" and not isinstance(e.get("ts"), (int, float)):
            errors.append(f"event {i}: non-numeric ts: {e!r}")
        if "name" not in e:
            errors.append(f"event {i}: missing name: {e!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i}: complete event needs dur >= 0: {e!r}")
        if ph in ("s", "t", "f"):
            if "id" not in e:
                errors.append(f"event {i}: flow event needs id: {e!r}")
            elif ph == "s":
                starts[e["id"]] = starts.get(e["id"], 0) + 1
            elif ph == "f":
                ends[e["id"]] = ends.get(e["id"], 0) + 1
        if ph == "i" and e.get("s") not in (None, "t", "p", "g"):
            errors.append(f"event {i}: bad instant scope: {e!r}")
    for fid, n in starts.items():
        if n != 1:
            errors.append(f"flow {fid}: {n} start events (want 1)")
        if ends.get(fid, 0) != 1:
            errors.append(f"flow {fid}: {ends.get(fid, 0)} end events (want 1)")
    for fid in ends:
        if fid not in starts:
            errors.append(f"flow {fid}: end without start")
    return errors


def summarize_trace(events: Iterable[Mapping], *, top: int = 5, slot_prefix: str = "slot") -> dict:
    """Aggregate a trace for human / CI consumption.

    Returns per-lane busy time and utilization (busy / trace extent),
    per-span-name totals ("stages"), the pipeline *overlap fraction* —
    of the wall time during which at least one ``slot*`` lane was busy,
    the share during which two or more were busy concurrently (exactly 0
    for a serial depth-1 run; > 0 whenever batches overlapped) — and the
    ``top`` longest individual spans.  Slot-lane busy time is measured on
    batch spans (each slot's enclosing dispatch→retire window), which are
    non-nested per lane, so nested stage spans don't double-count.
    """
    events = list(events)
    lane_of = _lane_names(events)
    spans = [e for e in events if e.get("ph") == "X"]
    flows = [e for e in events if e.get("ph") in ("s", "t", "f")]
    counters = sorted({e["name"] for e in events if e.get("ph") == "C"})
    if not spans:
        return {
            "extent_ms": 0.0,
            "lanes": {},
            "stages": {},
            "overlap_fraction": 0.0,
            "top_spans": [],
            "n_events": len(events),
            "n_flows": len({e.get("id") for e in flows}) if flows else 0,
            "counters": counters,
        }
    t_lo = min(e["ts"] for e in spans)
    t_hi = max(e["ts"] + e["dur"] for e in spans)
    extent = max(t_hi - t_lo, 1e-9)

    by_lane: dict[str, list[tuple[float, float]]] = {}
    stages: dict[str, dict[str, float]] = {}
    for e in spans:
        lane = lane_of.get(e["tid"], f"tid {e['tid']}")
        by_lane.setdefault(lane, []).append((e["ts"], e["ts"] + e["dur"]))
        st = stages.setdefault(e["name"], {"total_ms": 0.0, "count": 0, "max_ms": 0.0})
        st["total_ms"] += e["dur"] / 1e3
        st["count"] += 1
        st["max_ms"] = max(st["max_ms"], e["dur"] / 1e3)

    lanes = {}
    for lane, ivals in sorted(by_lane.items()):
        busy = sum(e - s for s, e in _union(ivals))
        lanes[lane] = {
            "busy_ms": busy / 1e3,
            "utilization": busy / extent,
            "spans": len(ivals),
        }

    # Overlap: sweep the per-slot-lane busy unions, counting concurrently
    # busy slot lanes.  Batch spans within one lane never overlap (a slot
    # holds one batch at a time), so per-lane union ≡ that slot's busy set.
    slot_unions = [
        _union(ivals) for lane, ivals in by_lane.items() if lane.startswith(slot_prefix)
    ]
    edges = sorted({t for u in slot_unions for iv in u for t in iv})
    busy_us = overlap_us = 0.0
    starts_per_union = [[iv[0] for iv in u] for u in slot_unions]
    for lo, hi in zip(edges, edges[1:]):
        mid = (lo + hi) / 2
        active = 0
        for u, starts in zip(slot_unions, starts_per_union):
            j = bisect.bisect_right(starts, mid) - 1
            if j >= 0 and u[j][1] > mid:
                active += 1
        if active >= 1:
            busy_us += hi - lo
        if active >= 2:
            overlap_us += hi - lo

    top_spans = sorted(spans, key=lambda e: -e["dur"])[:top]
    return {
        "extent_ms": extent / 1e3,
        "lanes": lanes,
        "stages": dict(sorted(stages.items(), key=lambda kv: -kv[1]["total_ms"])),
        "overlap_fraction": (overlap_us / busy_us) if busy_us > 0 else 0.0,
        "top_spans": [
            {
                "name": e["name"],
                "lane": lane_of.get(e["tid"], f"tid {e['tid']}"),
                "ts_ms": (e["ts"] - t_lo) / 1e3,
                "dur_ms": e["dur"] / 1e3,
                "args": e.get("args", {}),
            }
            for e in top_spans
        ],
        "n_events": len(events),
        "n_flows": len({e.get("id") for e in flows}) if flows else 0,
        "counters": counters,
    }


# ---------------------------------------------------------------------------
# Metrics registry — counters / gauges / histograms with labels.
# ---------------------------------------------------------------------------

# Default histogram buckets, in milliseconds — spans request latencies from
# sub-ms cache hits to multi-second cold batches.
DEFAULT_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0)


def _label_key(labels: Mapping[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _escape(value: Any) -> str:
    return str(value).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


class _Counter:
    __slots__ = ("value",)

    kind = "counter"

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        self.value += amount

    def sample(self) -> float:
        return self.value


class _Gauge:
    __slots__ = ("value",)

    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def sample(self) -> float:
        return self.value


class _Histogram:
    __slots__ = ("buckets", "counts", "sum", "observations")

    kind = "histogram"

    def __init__(self, buckets: tuple[float, ...]):
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # +1 for +Inf
        self.sum = 0.0
        self.observations: list[float] = []

    def observe(self, value: float) -> None:
        value = float(value)
        self.sum += value
        self.observations.append(value)
        self.counts[bisect.bisect_left(self.buckets, value)] += 1

    @property
    def count(self) -> int:
        return len(self.observations)

    def quantile(self, q: float) -> float:
        if not self.observations:
            return math.nan
        xs = sorted(self.observations)
        return xs[min(int(q * len(xs)), len(xs) - 1)]

    def sample(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": min(self.observations) if self.observations else math.nan,
            "max": max(self.observations) if self.observations else math.nan,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Labelled counters, gauges, and histograms.

    ``registry.counter("batches_total", stream=0).inc()`` — each distinct
    (name, labels) pair is its own series; a name is bound to one metric
    kind for the registry's lifetime.  :meth:`snapshot` returns a JSON-safe
    dict (embedded in reports), :meth:`to_prometheus` the text exposition
    format (``--metrics out.prom``).
    """

    def __init__(self):
        self._series: dict[tuple[str, str], Any] = {}
        self._kinds: dict[str, str] = {}

    def _get(self, name: str, labels: Mapping[str, Any], factory, kind: str):
        bound = self._kinds.setdefault(name, kind)
        if bound != kind:
            raise ValueError(f"metric {name!r} already registered as {bound}, not {kind}")
        key = (name, _label_key(labels))
        series = self._series.get(key)
        if series is None:
            series = self._series[key] = factory()
        return series

    def counter(self, name: str, **labels) -> _Counter:
        return self._get(name, labels, _Counter, "counter")

    def gauge(self, name: str, **labels) -> _Gauge:
        return self._get(name, labels, _Gauge, "gauge")

    def histogram(self, name: str, *, buckets: tuple[float, ...] | None = None, **labels) -> _Histogram:
        make = lambda: _Histogram(buckets if buckets is not None else DEFAULT_BUCKETS_MS)
        return self._get(name, labels, make, "histogram")

    def snapshot(self) -> dict:
        out: dict[str, dict] = {"counters": {}, "gauges": {}, "histograms": {}}
        for (name, lkey), series in sorted(self._series.items()):
            out[series.kind + "s"][name + lkey] = series.sample()
        return out

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=2, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format, one family per metric name."""
        lines: list[str] = []
        by_name: dict[str, list[tuple[str, Any]]] = {}
        for (name, lkey), series in sorted(self._series.items()):
            by_name.setdefault(name, []).append((lkey, series))
        for name, entries in by_name.items():
            lines.append(f"# TYPE {name} {self._kinds[name]}")
            for lkey, series in entries:
                if series.kind == "histogram":
                    cum = 0
                    for edge, n in zip(series.buckets, series.counts):
                        cum += n
                        lines.append(f"{name}_bucket{_with_le(lkey, edge)} {cum}")
                    cum += series.counts[-1]
                    lines.append(f'{name}_bucket{_with_le(lkey, "+Inf")} {cum}')
                    lines.append(f"{name}_sum{lkey} {series.sum:.6g}")
                    lines.append(f"{name}_count{lkey} {series.count}")
                else:
                    lines.append(f"{name}{lkey} {series.sample():.6g}")
        return "\n".join(lines) + "\n"


def _with_le(lkey: str, edge) -> str:
    le = f'le="{edge}"'
    if not lkey:
        return "{" + le + "}"
    return lkey[:-1] + "," + le + "}"
