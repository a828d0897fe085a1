"""The port's tracing while a torch profiler records, on the CPU.

Under ``torch.profiler`` every run records into one tracer per profiler
session (``core/trace.profiler_session``), and every span also enters the
profiler's timeline as a ``record_function`` annotation.  These tests hold
the spans of a sampled (dedup, depth 2) run and of a layer-wise run to
their names and nesting, the annotations to the spans, the outputs to the
untraced run's bits, and ``summarize_trace``'s self time and wait count to
a hand-built trace.
"""

import collections
import json

import numpy as np
import pytest
import torch

from repro_torch.core.config import EngineConfig
from repro_torch.core.trace import (
    NULL_TRACER,
    Tracer,
    is_wait_span,
    profiler_session,
    resolve_tracer,
    summarize_trace,
    validate_trace,
)
from repro_torch.graph.datasets import load_dataset
from repro_torch.launch import infer_gnn
from repro_torch.runtime.gnn_engine import GNNInferenceEngine
from repro_torch.runtime.layerwise import run_layerwise

# The sampled route: dedup (one num_unique read in sample), depth 2 (three
# drains at retire), logits collected (one read at retire).
SAMPLED = EngineConfig(pipeline_depth=2, use_kernel=True, dedup=True)
LAYERWISE = EngineConfig(mode="layerwise", chunk_size=256, pipeline_depth=2, use_kernel=True)
BATCHES = 3

# Every wait span, the span it nests in on its lane, and its ``wait`` arg
# on the CPU route: the drains take the whole-device path (a card's
# overlapped sampled route waits on events instead: the ``gpu`` tests).
SAMPLED_WAITS = {
    "sync:num_unique": ("sample", "read"),
    "drain:sample": ("retire", "device"),
    "drain:feature": ("retire", "device"),
    "drain:compute": ("retire", "device"),
    "sync:record": ("retire", "read"),
    "sync:outputs": ("retire", "read"),
}
LAYERWISE_WAITS = {
    "sync:probe": ("probe", "device"),
    "sync:warm": ("warm", "device"),
    "drain:gather": ("retire", "device"),
    "drain:compute": ("retire", "device"),
    "sync:spill": ("retire", "read"),
    "sync:hits": ("retire", "read"),
}
SAMPLED_SPANS = {"admit", "sample", "feature", "compute", "retire", "batch", *SAMPLED_WAITS}
LAYERWISE_SPANS = {
    "plan", "probe", "refill", "spill-alloc", "warm", "embed-fill",
    "admit", "gather", "compute", "retire", "batch", *LAYERWISE_WAITS,
}


@pytest.fixture(scope="module")
def engine():
    torch.set_num_threads(1)
    ds = load_dataset("ogbn-products", scale=0.002, seed=0)
    eng = GNNInferenceEngine(ds, fanouts=(3, 2), batch_size=64, seed=3, device="cpu")
    eng.prepare("dci", total_cache_bytes=100_000, n_presample=2)
    return eng


def _sampled(eng):
    rep = eng.run(config=SAMPLED, max_batches=BATCHES, collect_outputs=True)
    return rep, eng.last_outputs


def _layerwise(eng, allocation=None):
    pipe = eng.pipeline
    return run_layerwise(
        eng.dataset, pipe, list(eng.model.layers), model=eng.model_name,
        config=LAYERWISE.resolved(pipe, pipeline_depth=2), allocation=allocation,
    )


def _profiled(fn, *args, outer=None):
    """``fn(*args)`` under a CPU profiler (inside ``record_function(outer)``
    when given); returns its result, the session's tracer and the profiler.
    Two profiler sessions with no run between them share one tracer, so
    the earlier session is closed first, as a run outside a profiler does."""
    resolve_tracer(None)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        if outer is None:
            out = fn(*args)
        else:
            with torch.profiler.record_function(outer):
                out = fn(*args)
    return out, profiler_session(), prof


def _spans(tracer):
    return [e for e in tracer.events if e["ph"] == "X"]


def _inside(child, parent, eps=1e-3):
    return (
        parent["tid"] == child["tid"]
        and parent["ts"] <= child["ts"] + eps
        and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"] + eps
    )


def _assert_waits_nest(spans, waits):
    for w in (e for e in spans if is_wait_span(e["name"])):
        parent, kind = waits[w["name"]]
        assert any(
            p["name"] == parent and _inside(w, p) for p in spans
        ), f"{w['name']} at {w['ts']} nests in no {parent}"
        assert w["args"] == {"wait": kind}, w


def test_outside_a_profiler_nothing_records(engine):
    assert resolve_tracer(None) is NULL_TRACER
    _sampled(engine)
    assert profiler_session() is None
    mine = Tracer()
    assert resolve_tracer(mine) is mine
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert resolve_tracer(mine) is mine  # an explicit tracer wins
        assert resolve_tracer(None) is profiler_session() is not None


def test_sampled_run_records_its_spans(engine):
    _, tracer, _ = _profiled(_sampled, engine)
    spans = _spans(tracer)
    names = collections.Counter(e["name"] for e in spans)
    assert set(names) == SAMPLED_SPANS
    assert names["batch"] == BATCHES and names["admit"] == BATCHES + 1  # the last finds none
    assert names["sync:record"] == 3 * BATCHES
    _assert_waits_nest(spans, SAMPLED_WAITS)
    s = summarize_trace(tracer.events)
    # 1 num_unique read, 3 drains, 3 record reads and 1 read of the logits.
    assert s["waits"] == 8 * BATCHES
    assert s["wait_kinds"] == {"device": 3 * BATCHES, "read": 5 * BATCHES}
    assert s["device_syncs"] == 3 * BATCHES
    assert validate_trace(tracer.events) == []


def test_layerwise_run_records_its_spans(engine):
    report, tracer, _ = _profiled(_layerwise, engine)
    spans = _spans(tracer)
    names = collections.Counter(e["name"] for e in spans)
    layers = {f"layer {k}" for k in range(report.num_layers)}
    assert set(names) == LAYERWISE_SPANS | layers and report.num_layers > 1
    items = report.num_layers * report.num_chunks
    assert names["batch"] == items and names["spill-alloc"] == names["warm"] == report.num_layers
    assert names["sync:probe"] == 6  # two probes, each one untimed lap and two timed
    _assert_waits_nest(spans, LAYERWISE_WAITS)
    probe = next(e for e in spans if e["name"] == "probe")
    assert probe["args"]["feat_bytes"] == report.allocation.feat_bytes
    assert probe["args"]["embed_bytes"] == report.allocation.embed_bytes
    assert probe["args"]["t_feat_s"] > 0 and probe["args"]["t_embed_s"] > 0
    s = summarize_trace(tracer.events)
    assert s["waits"] == 4 * items + 6 + report.num_layers
    assert s["wait_kinds"] == {"device": 2 * items + 6 + report.num_layers, "read": 2 * items}
    assert s["device_syncs"] == s["wait_kinds"]["device"]


@pytest.mark.parametrize("route", ["sampled", "layerwise"])
def test_spans_are_profiler_annotations(engine, route, tmp_path):
    """Each span enters the profiler's timeline once, as a user annotation
    inside the record_function that encloses the run: one clock."""
    fn = _sampled if route == "sampled" else _layerwise
    _, tracer, prof = _profiled(fn, engine, outer="outer")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ann = [e for e in json.loads(path.read_text())["traceEvents"]
           if e.get("cat") == "user_annotation"]
    outer = next(e for e in ann if e["name"] == "outer")
    got = collections.Counter(e["name"] for e in ann if e is not outer)
    # ``batch`` is stamped at retire from its dispatch start: no annotation.
    want = collections.Counter(e["name"] for e in _spans(tracer) if e["name"] != "batch")
    assert got == want
    for e in ann:
        assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


def test_a_profiler_moves_no_bit_of_a_sampled_run(engine):
    plain, plain_out = _sampled(engine)
    (traced, traced_out), tracer, _ = _profiled(_sampled, engine)
    assert tracer is not None
    for a, b in zip(plain_out, traced_out, strict=True):
        np.testing.assert_array_equal(a, b)
    hits = lambda r: (r.adj_hits, r.adj_lookups, r.feat_hits, r.feat_lookups)  # noqa: E731
    assert hits(plain) == hits(traced)


def test_a_profiler_moves_no_bit_of_a_layerwise_run(engine):
    first = _layerwise(engine)  # its split, for both runs: Eq. 1 reads wall clocks
    plain = _layerwise(engine, first.allocation)
    traced, tracer, _ = _profiled(_layerwise, engine, first.allocation)
    assert tracer is not None and "probe" not in {e["name"] for e in _spans(tracer)}
    np.testing.assert_array_equal(plain.outputs, traced.outputs)
    hits = lambda r: (r.feat_hits, r.feat_lookups, r.embed_hits, r.embed_lookups)  # noqa: E731
    assert hits(plain) == hits(traced)


def test_a_second_session_starts_empty(engine):
    _, first, _ = _profiled(_sampled, engine)
    assert profiler_session() is first  # readable after the profiler stopped
    _sampled(engine)  # a run outside a profiler closes the session
    assert profiler_session() is None
    engine_run_one = lambda: engine.run(config=SAMPLED, max_batches=1)  # noqa: E731
    _, second, _ = _profiled(engine_run_one)
    assert second is not first
    assert summarize_trace(second.events)["stages"]["batch"]["count"] == 1
    assert summarize_trace(first.events)["stages"]["batch"]["count"] == BATCHES


def test_self_time_and_waits_by_hand():
    """Self time takes out the children on the span's own lane only; a
    span that partly overlaps another is no child of it."""
    def x(name, tid, ts, dur):
        return {"name": name, "ph": "X", "ts": float(ts), "dur": float(dur), "pid": 1, "tid": tid}

    events = [
        {"name": "thread_name", "ph": "M", "ts": 0.0, "pid": 1, "tid": 1,
         "args": {"name": "slot 0"}},
        {"name": "thread_name", "ph": "M", "ts": 0.0, "pid": 1, "tid": 2,
         "args": {"name": "executor"}},
        x("batch", 1, 0, 100),
        x("sample", 1, 0, 30),
        x("sync:num_unique", 1, 10, 5),
        x("retire", 1, 60, 40),
        x("drain:sample", 1, 60, 10),
        x("sync:record", 1, 80, 2),
        x("late", 1, 90, 30),  # partly past the batch: a child of neither
        x("admit", 2, 20, 50),  # another lane: no child, no parent
        x("sync:other", 2, 100, 4),
    ]
    assert validate_trace(events) == []
    s = summarize_trace(events)
    self_ms = {k: v["self_ms"] * 1e3 for k, v in s["stages"].items()}
    assert self_ms == pytest.approx({
        "batch": 100 - 30 - 40, "sample": 25, "sync:num_unique": 5, "retire": 28,
        "drain:sample": 10, "sync:record": 2, "late": 30, "admit": 50, "sync:other": 4,
    })
    assert s["waits"] == 4 and s["wait_ms"] == pytest.approx((5 + 10 + 2 + 4) / 1e3)
    assert s["stages"]["batch"]["total_ms"] == pytest.approx(0.1)


def test_wait_kinds_by_hand():
    """Each wait span counts under its ``wait`` arg; ``device_syncs`` is
    the ``device`` count; a span that is no wait span counts in none."""
    tr = Tracer()
    for name, kind in [("drain:sample", "event"), ("drain:compute", "event"),
                       ("sync:num_unique", "event"), ("drain:gather", "device"),
                       ("sync:record", "read"), ("sync:outputs", "read"),
                       ("sample", "device")]:
        with tr.span(name, lane="slot 0", args={"wait": kind}):
            pass
    with tr.span("sync:bare", lane="slot 0"):
        pass
    s = summarize_trace(tr.events)
    assert s["waits"] == 7
    assert s["wait_kinds"] == {"device": 1, "event": 3, "read": 2}
    assert s["device_syncs"] == 1
    empty = summarize_trace([])
    assert empty["wait_kinds"] == {} and empty["device_syncs"] == 0


def test_a_span_without_a_lane_joins_the_enclosing_one():
    tr = Tracer()
    with tr.span("outer", lane="slot 1"):
        with tr.span("sync:inner"):
            pass
    with tr.span("alone"):
        pass
    tid = {e["name"]: e["tid"] for e in _spans(tr)}
    assert tid["sync:inner"] == tid["outer"] == tr.lane("slot 1")
    assert tid["alone"] == tr.lane("main")


def test_cli_profile_writes_the_spans_beside_the_ops(tmp_path, capsys):
    path = tmp_path / "profile.json"
    infer_gnn.main(["--device", "cpu", "--dataset", "reddit", "--scale", "0.002",
                    "--fanouts", "3,2", "--batch-size", "16", "--presample", "1",
                    "--max-batches", "2", "--cache-mb", "0.05", "--use-kernel", "--dedup",
                    "--pipeline-depth", "2", "--profile", str(path)])
    assert json.loads(capsys.readouterr().out)["batches"] == 2
    events = json.loads(path.read_text())["traceEvents"]
    ann = collections.Counter(e["name"] for e in events if e.get("cat") == "user_annotation")
    assert ann["sample"] == ann["retire"] == ann["sync:num_unique"] == 2
    assert any(e.get("cat") == "cpu_op" for e in events)
    with pytest.raises(SystemExit):
        infer_gnn.main(["--trace-profiler"])
