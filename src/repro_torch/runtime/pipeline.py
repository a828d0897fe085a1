"""Staged, double-buffered batch executor for sampled GNN inference.

DCI attacks sampling and feature-loading *cost*; SALIENT and BGL show the
remaining end-to-end gap is inter-stage *idle* time when sample → gather →
compute run strictly serially with a device sync after every stage.  This
executor removes those barriers: each mini-batch's stages are dispatched
back-to-back and up to ``depth`` batches are kept in flight, so batch
``i+1``'s sampling and feature gather are enqueued (and, on the CUDA
stream, executing) while batch ``i``'s GNN forward is still running.

Semantics
---------
``depth=1`` reproduces the serial engine bit-for-bit: every stage is
synchronized inside its timer (via :class:`~repro_torch.utils.timing.StageClock`
in serial mode) and a batch fully retires before the next one starts —
including RAIN's cross-batch reuse ordering and the per-batch hit-rate
accounting.  ``depth>1`` changes *only* the synchronization pattern: the
same ops are dispatched in the same order with the same RNG stream, so
logits, hit counts, and batch order are identical (equivalence-tested in
tests/test_pipeline_executor.py); stage timers measure dispatch time and
the in-flight wait is booked by ``StageClock.drain`` at retire boundaries.

Stages communicate through a per-batch :class:`BatchContext`; cross-batch
state (RNG keys, RAIN's reuse map, visit counters) lives in closures of the
stage functions, which are always invoked in batch order.  The same
executor drives both the inference engine (runtime/gnn_engine.py) and the
pre-sampling profiler (core/presample.py), so Eq. 1 stage times and the
cache-filling visit counts come from one code path.

Prefetch boundary
-----------------
Because a batch's stages dispatch back-to-back while *earlier* batches are
still in flight, any stage inserted between two others is a prefetch hook:
a stage placed between ``sample`` and ``feature`` runs for batch ``i+1``
while batch ``i``'s compute occupies the device — the boundary the
feature-miss prefetch stage of the reference engine uses to stage missed
host rows ahead of the gather that consumes them (not ported yet).  Optional stages are passed as ``None`` entries in ``stages`` and
dropped, so call sites can write ``[sample, prefetch if on else None,
feature, compute]`` without changing the executor schedule when the knob
is off.

Multi-stream
------------
Batches from several independent request streams can interleave through
one executor schedule: :meth:`PipelinedExecutor.run_tagged` accepts
``(stream, payload)`` pairs and stamps the stream onto
``BatchContext.stream``, and the ``clock_for`` hook routes each batch's
stage laps *and* its retire-boundary drains to that stream's own
:class:`~repro_torch.utils.timing.StageClock`.  Stage functions resolve
per-stream state (RNG, reuse maps, hit counters) through ``ctx.stream``,
so the serial-equivalence guarantee above holds *per stream* — the
foundation of the reference's multi-stream serving layer (not ported yet).
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
from typing import Any, Callable, Iterable, Sequence

from repro_torch.core.trace import resolve_tracer
from repro_torch.utils.timing import StageClock

__all__ = ["BatchContext", "DRAIN", "PipelinedExecutor", "Stage"]


class _Drain:
    """Sentinel a :meth:`PipelinedExecutor.run_tagged` item stream may
    yield to flush the window: every in-flight batch retires, no new batch
    is admitted, and the item index does not advance.  The request-queue
    serving layer uses it while waiting for future arrivals — retiring
    work it has already admitted instead of idling with a full window —
    which keeps enqueue→retire latency accounting honest."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "DRAIN"


DRAIN = _Drain()


def _stream_label(stream: Any) -> Any:
    """Compact trace label for a batch's stream tag — the numeric
    ``stream_id`` when the tag is a stream-state object, else ``str``."""
    sid = getattr(stream, "stream_id", None)
    return sid if sid is not None else str(stream)


class BatchContext:
    """One mini-batch flowing through the pipeline.

    ``payload`` is the batch input (seed node ids); ``outputs[name]`` holds
    each completed stage's result.  ``stream`` tags the request stream the
    batch belongs to (``None`` for single-stream runs); multi-stream stage
    functions use it to resolve per-stream state.  ``epoch`` is the cache
    epoch the batch ran against (stamped by the first stage that reads the
    caches — see ``StreamRuntime.sample``): under online refresh
    (runtime/cache_refresh.py) an epoch boundary can fall between two
    in-flight batches, and retire-time accounting attributes each batch to
    the epoch it actually dispatched against.

    ``slot`` is the pipeline window slot the batch occupies while in
    flight — the executor reuses the lowest free slot, so with depth ``d``
    at most slots ``0..d-1`` exist.  It keys the batch's trace lane
    (``slot 0`` …), making depth-``d`` overlap visible as ``d`` stacked
    timeline lanes; ``trace_t0`` is the tracer timestamp of the batch's
    dispatch start (µs), recorded only when tracing is enabled.
    """

    __slots__ = ("index", "payload", "stream", "epoch", "outputs", "slot", "trace_t0")

    def __init__(self, index: int, payload: Any, stream: Any = None):
        self.index = index
        self.payload = payload
        self.stream = stream
        self.epoch = 0
        self.outputs: dict[str, Any] = {}
        self.slot = 0
        self.trace_t0 = 0.0


@dataclasses.dataclass(frozen=True)
class Stage:
    """A named pipeline stage.

    ``fn(ctx)`` computes the stage's output from ``ctx.payload`` and
    earlier stages' ``ctx.outputs``.  ``sync(ctx)`` returns the device
    value that marks the stage complete: in serial mode the clock blocks on
    it at the stage boundary; for the final stage it is also what retire
    drains in overlap mode.
    """

    name: str
    fn: Callable[[BatchContext], Any]
    sync: Callable[[BatchContext], Any] | None = None


class PipelinedExecutor:
    """Run batches through ``stages`` keeping up to ``depth`` in flight.

    ``depth=1`` → serial: dispatch + sync every stage, retire, then start
    the next batch (the pre-pipeline engine loop).  ``depth=2`` → double
    buffering: batch ``i`` retires only after batch ``i+1`` has fully
    dispatched.  ``on_retire(ctx)`` runs once per batch, in order, after
    the batch's final stage output is ready — the place for host-side
    accounting (hit counters, logits collection) that would otherwise force
    a sync mid-pipeline.

    Failure semantics: an exception escaping a stage mid-window drains
    every in-flight batch (their ``on_retire`` accounting runs, their
    slots release) before the first error re-raises — no deadlock, no
    silently dropped batches.  ``on_batch_error(ctx, err)``, when set,
    is consulted first: returning ``True`` drops just the failing batch
    (its slot and index are reused) and the run continues — the serving
    layer's request-shedding hook.
    """

    def __init__(
        self,
        stages: Sequence[Stage | None],
        *,
        depth: int = 1,
        clock: StageClock | None = None,
        clock_for: Callable[[BatchContext], StageClock] | None = None,
        on_retire: Callable[[BatchContext], None] | None = None,
        on_batch_error: Callable[[BatchContext, BaseException], bool] | None = None,
        tracer=None,
    ):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        stages = [st for st in stages if st is not None]  # optional stages, off
        if not stages:
            raise ValueError("need at least one stage")
        self.stages = list(stages)
        self.depth = depth
        self.clock = clock if clock is not None else StageClock(overlap=depth > 1)
        self.clock_for = clock_for
        self.on_retire = on_retire
        self.on_batch_error = on_batch_error
        self.tracer = resolve_tracer(tracer)
        self._free_slots: list[int] = []  # min-heap of released window slots
        self._next_slot = 0

    def _acquire_slot(self) -> int:
        """Lowest-numbered slot not held by an in-flight batch.  Lowest-
        first reuse keeps the trace's slot lanes dense: a depth-``d`` run
        uses exactly lanes ``slot 0 … slot d-1``, and a serial run stays
        entirely on ``slot 0`` (overlap fraction exactly 0)."""
        if self._free_slots:
            return heapq.heappop(self._free_slots)
        slot = self._next_slot
        self._next_slot += 1
        return slot

    @staticmethod
    def slot_lane(ctx: BatchContext) -> str:
        """The trace lane of the window slot ``ctx`` occupies — serving
        layers use it to anchor request flow steps onto the batch span."""
        return f"slot {ctx.slot}"

    def _clock(self, ctx: BatchContext) -> StageClock:
        """The clock a batch's laps and drains are booked on: the stream's
        own clock when ``clock_for`` is set (per-stream accounting), else
        the executor-wide default."""
        if self.clock_for is not None:
            return self.clock_for(ctx)
        return self.clock

    def run(self, payloads: Iterable[Any]) -> list[BatchContext]:
        """Dispatch every payload through all stages; return retired contexts
        in batch order.

        Retired contexts come back with ``outputs`` cleared — extraction
        belongs in ``on_retire``.  Holding every batch's device arrays
        (blocks, features, logits) until the run ends would grow memory
        O(num_batches) instead of O(depth) on exactly the long runs
        pipelining targets."""
        return self.run_tagged((None, p) for p in payloads)

    def run_tagged(self, items: Iterable[tuple[Any, Any]]) -> list[BatchContext]:
        """Like :meth:`run` over ``(stream, payload)`` pairs.

        The stream tag is stamped onto each :class:`BatchContext` before
        its stages run; the pairs may come from a *lazy* admission
        generator — it is pulled exactly when a window slot is about to be
        filled, so it can consult live in-flight occupancy (the serving
        layer's backpressure hook).  An item that is the module-level
        :data:`DRAIN` sentinel retires everything in flight without
        admitting a batch — the generator's way to flush the window while
        it waits on an external clock (request arrivals)."""
        window: collections.deque[BatchContext] = collections.deque()
        retired: list[BatchContext] = []
        tracer = self.tracer
        index = 0
        try:
            for item in items:
                if item is DRAIN:
                    while window:
                        retired.append(self._retire(window.popleft()))
                    continue
                stream, payload = item
                ctx = BatchContext(index, payload, stream)
                index += 1
                clock = self._clock(ctx)
                lane, args = "slot 0", None
                ctx.slot = self._acquire_slot()
                if tracer.enabled:
                    lane = f"slot {ctx.slot}"
                    args = {"batch": ctx.index}
                    if ctx.stream is not None:
                        args["stream"] = _stream_label(ctx.stream)
                    ctx.trace_t0 = tracer.now_us()
                try:
                    for st in self.stages:
                        sync = None
                        if st.sync is not None:
                            sync = (lambda s=st, c=ctx: s.sync(c))
                        # The trace span wraps the clock lap, so in serial
                        # mode it covers the stage's sync too — span
                        # durations and Eq. 1 stage laps agree (asserted in
                        # tests/test_trace.py).
                        with tracer.span(st.name, lane=lane, args=args):
                            with clock.stage(st.name, sync=sync):
                                ctx.outputs[st.name] = st.fn(ctx)
                except BaseException as err:
                    if self.on_batch_error is not None and self.on_batch_error(ctx, err):
                        # Handled: the batch is dropped (never enters the
                        # window, never retires) and its slot/index are
                        # reusable, so the next admission sees the same
                        # window occupancy a successful retire would leave.
                        heapq.heappush(self._free_slots, ctx.slot)
                        ctx.outputs.clear()
                        index -= 1
                        continue
                    raise
                window.append(ctx)
                while len(window) > self.depth - 1:
                    retired.append(self._retire(window.popleft()))
            while window:  # drain whatever is still in flight
                retired.append(self._retire(window.popleft()))
        except BaseException:
            # A stage (or retire sync) failed mid-window: drain every
            # in-flight batch best-effort so completed work still retires
            # (accounting runs, slots release, nothing is silently
            # dropped), then re-raise the FIRST error.
            while window:
                ctx = window.popleft()
                try:
                    self._retire(ctx)
                except BaseException:  # noqa: S110 - first error wins
                    pass
            raise
        return retired

    def _retire(self, ctx: BatchContext) -> BatchContext:
        clock = self._clock(ctx)
        tracer = self.tracer
        lane = f"slot {ctx.slot}" if tracer.enabled else "slot 0"
        if clock.overlap:
            # Drain every stage's sync value, in stage order, attributing
            # each wait to its own stage — otherwise in-flight work from
            # earlier stages would be waited on untimed inside on_retire
            # and the stage totals would under-count the loop's wall clock.
            for st in self.stages:
                if st.sync is not None:
                    with tracer.span(f"drain:{st.name}" if tracer.enabled else "drain", lane=lane):
                        clock.drain(st.name, st.sync(ctx))
        if self.on_retire is not None:
            self.on_retire(ctx)
        if tracer.enabled:
            # The batch's enclosing span: dispatch start → retired.  Slot
            # lanes carry one such span per in-flight batch, so stacked
            # batch spans across lanes *are* the pipeline overlap.
            tracer.complete(
                "batch",
                lane=lane,
                ts_us=ctx.trace_t0,
                dur_us=tracer.now_us() - ctx.trace_t0,
                args={"batch": ctx.index, "epoch": ctx.epoch},
            )
        heapq.heappush(self._free_slots, ctx.slot)
        ctx.outputs.clear()
        return ctx
