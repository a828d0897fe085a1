"""What the executor's retire waits on, on the CPU.

A stand-in event counts its ``synchronize()`` calls, and the whole-device
synchronize is replaced by a counter that every tensor reaches (as a CUDA
tensor would).  Overlapped, a stage that hands an event is drained by that
event alone; tensors, and every serial stage, still take the whole-device
path; the drain spans say which (``wait``) and ``summarize_trace`` counts
each kind.
"""

import collections

import pytest
import torch

from repro_torch.core.trace import Tracer, summarize_trace
from repro_torch.runtime import gnn_engine
from repro_torch.runtime.pipeline import PipelinedExecutor, Stage
from repro_torch.utils import timing
from repro_torch.utils.timing import StageClock, block_until_ready, wait_kind

STAGES = ("sample", "feature", "compute")
BATCHES = 4


class CountingEvent:
    """Stands in for a ``torch.cuda.Event``: counts its waits."""

    def __init__(self):
        self.syncs = 0

    def synchronize(self):
        self.syncs += 1

    def wait(self, stream=None):
        pass


@pytest.fixture
def device_syncs(monkeypatch):
    """The list of whole-device synchronizes made; every tensor counts as
    living on one card."""
    calls = []

    def devices(value, out):
        if isinstance(value, torch.Tensor):
            out.add("card")
        elif isinstance(value, (tuple, list)):
            for v in value:
                devices(v, out)

    monkeypatch.setattr(timing, "_cuda_devices", devices)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    return calls


def _evented_stages(events):
    """Stages that record a stand-in event each, and hand it as their sync."""
    def run(name):
        def fn(ctx):
            ev = CountingEvent()
            events.append((ctx.index, name, ev))
            ctx.outputs["_ev:" + name] = ev
            return ctx.payload
        return fn

    return [Stage(n, run(n), lambda c, n=n: c.outputs["_ev:" + n]) for n in STAGES]


def _tensor_stages(modes):
    """Stages that hand tensors, as presampling's and the layer-wise path's do."""
    def fn(ctx):
        modes.append(ctx.overlap)
        return ctx.payload * 2

    return [Stage(n, fn, lambda c, n=n: (c.outputs[n],)) for n in STAGES]


def _drains(tracer):
    return [e for e in tracer.events if e["ph"] == "X" and e["name"].startswith("drain:")]


def test_an_overlapped_retire_waits_each_stage_event_and_never_the_device(device_syncs):
    events, tracer = [], Tracer()
    ex = PipelinedExecutor(_evented_stages(events), depth=2, tracer=tracer)
    assert len(ex.run(torch.arange(BATCHES))) == BATCHES
    assert [(i, n) for i, n, _ in events] == [(i, n) for i in range(BATCHES) for n in STAGES]
    assert all(ev.syncs == 1 for _, _, ev in events)
    assert device_syncs == []
    drains = _drains(tracer)
    assert len(drains) == BATCHES * len(STAGES)
    assert all(e["args"] == {"wait": "event"} for e in drains)
    s = summarize_trace(tracer.events)
    assert s["wait_kinds"] == {"event": BATCHES * len(STAGES)} and s["device_syncs"] == 0
    assert set(ex.clock.totals) == set(STAGES)


def test_a_serial_run_synchronizes_the_device_at_every_stage(device_syncs):
    modes, tracer = [], Tracer()
    ex = PipelinedExecutor(_tensor_stages(modes), depth=1, tracer=tracer)
    ex.run(torch.arange(BATCHES))
    assert modes == [False] * (BATCHES * len(STAGES))
    assert len(device_syncs) == BATCHES * len(STAGES)
    assert _drains(tracer) == []  # each synchronize sits inside its stage's lap


def test_tensor_syncs_still_drain_the_whole_device_when_overlapped(device_syncs):
    modes, tracer = [], Tracer()
    ex = PipelinedExecutor(_tensor_stages(modes), depth=2, tracer=tracer)
    ex.run(torch.arange(BATCHES))
    assert modes == [True] * (BATCHES * len(STAGES))
    assert len(device_syncs) == BATCHES * len(STAGES)
    assert all(e["args"] == {"wait": "device"} for e in _drains(tracer))
    s = summarize_trace(tracer.events)
    assert s["device_syncs"] == s["waits"] == BATCHES * len(STAGES)


def test_the_clock_waits_on_an_event_or_the_device(device_syncs):
    ev = CountingEvent()
    assert wait_kind(ev) == "event"
    assert block_until_ready(ev) is ev and ev.syncs == 1 and device_syncs == []
    value = (torch.ones(2), [torch.zeros(1)])
    assert wait_kind(value) == wait_kind(torch.ones(1)) == wait_kind(None) == "device"
    assert block_until_ready(value) is value and device_syncs == ["card"]
    clock = StageClock(overlap=True)
    clock.drain("a", ev)
    clock.drain("b", value)
    assert ev.syncs == 2 and len(device_syncs) == 2
    assert set(clock.totals) == {"a", "b"} and clock.drain_seconds >= 0
    serial = StageClock()
    with serial.stage("c", sync=lambda: ev):
        pass
    assert ev.syncs == 3 and len(device_syncs) == 2


@pytest.mark.parametrize("prefetch", [False, True])
def test_stream_stages_hand_the_recorded_event_else_the_tensors(device_syncs, prefetch):
    """The engine's stages hand retire the event a stage recorded (on a
    card, overlapped), else what it left in flight."""
    recorded = collections.Counter()

    class Runtime:
        """Records an event for the sampled batches with an odd index."""

        def _stage(self, ctx, name, out):
            if ctx.index % 2:
                ev = CountingEvent()
                ctx.outputs[gnn_engine._DONE + name] = ev
                recorded[name] += 1
            return out

        def sample(self, ctx):
            return self._stage(ctx, "sample", (_Block(ctx.payload), ctx.payload.sum(), 1))

        def prefetch_stage(self, ctx):
            return self._stage(ctx, "prefetch", None)

        def feature(self, ctx):
            return self._stage(ctx, "feature", (ctx.payload.float(), None, ctx.payload.sum()))

        def compute(self, ctx):
            return self._stage(ctx, "compute", ctx.payload * 3)

    rt = Runtime()
    ex = PipelinedExecutor(gnn_engine.stream_stages(lambda c: rt, prefetch=prefetch),
                           depth=2, tracer=(tracer := Tracer()))
    ex.run(torch.arange(BATCHES))
    n_stages = len(ex.stages)
    kinds = collections.Counter(e["args"]["wait"] for e in _drains(tracer))
    assert kinds == {"event": sum(recorded.values()), "device": BATCHES * n_stages // 2}
    assert sum(recorded.values()) == BATCHES * n_stages // 2
    # Only the even batches reach the device: their stages hand tensors,
    # except prefetch's None, which holds none.
    assert len(device_syncs) == (BATCHES // 2) * 3


class _Block:
    def __init__(self, seeds):
        self.frontiers = (seeds,)
