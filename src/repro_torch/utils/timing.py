"""Wall-clock helpers (pre-sampling stage timing is part of DCI's Eq. 1).

``StageClock`` is the overlap-aware stage timer behind the pipelined batch
executor (runtime/pipeline.py): in serial mode it synchronizes (waits for
the device work behind the stage's values) at every stage boundary,
reproducing the per-stage Eq. 1 decomposition exactly; in overlap mode
stages only measure host dispatch time and the wait for in-flight device
work is booked by ``drain()`` at pipeline-retire boundaries.

Sync values are tensors or (nested) tuples/lists of tensors.  Waiting on
them synchronizes every CUDA device they live on; CPU tensors are already
complete when an op returns, so for them the wait is a no-op.
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["StageClock", "Stopwatch", "block_until_ready"]


def _cuda_devices(value, out: set) -> None:
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)


def block_until_ready(value):
    """Wait until the device work producing ``value`` has finished.

    Walks tuples and lists of tensors and calls
    ``torch.cuda.synchronize`` once per CUDA device found; returns
    ``value`` unchanged."""
    devices: set = set()
    _cuda_devices(value, devices)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return value


class StageClock:
    """Per-stage wall-clock accounting that understands stage overlap.

    Serial mode (``overlap=False``): :meth:`stage` blocks on the stage's
    ``sync`` value before stopping the timer, so every lap is a fully
    synchronized stage time — the semantics DCI's Eq. 1 stage decomposition
    assumes, and what the pre-pipeline engine measured.

    Overlap mode (``overlap=True``): :meth:`stage` never blocks; laps
    measure host dispatch time only, while the CUDA stream keeps the device
    busy with earlier batches.  The wait for in-flight work is recorded by
    :meth:`drain` when the pipeline retires a batch and is attributed (in
    ``totals`` only, not ``laps``) to the stage whose output is drained, so
    ``sum(totals.values())`` stays consistent with the loop's wall clock.
    """

    def __init__(self, *, overlap: bool = False):
        self.overlap = overlap
        self.totals: dict[str, float] = {}
        self.laps: dict[str, list[float]] = {}
        self.drain_seconds = 0.0

    @contextlib.contextmanager
    def stage(self, name: str, *, sync: object = None):
        """Time one stage lap.  ``sync`` is the device value (or a callable
        producing it) to block on at the stage boundary in serial mode."""
        t0 = time.perf_counter()
        ok = False
        try:
            yield
            ok = True
        finally:
            # Only evaluate sync when the body succeeded — a failed stage
            # has no output, and a KeyError from the sync callable would
            # mask the stage's real exception.
            if ok and sync is not None and not self.overlap:
                value = sync() if callable(sync) else sync
                if value is not None:
                    block_until_ready(value)
            self._lap(name, time.perf_counter() - t0)

    def drain(self, name: str, value) -> None:
        """Block on an in-flight device value; attribute the wait to ``name``."""
        t0 = time.perf_counter()
        block_until_ready(value)
        dt = time.perf_counter() - t0
        self.drain_seconds += dt
        self.totals[name] = self.totals.get(name, 0.0) + dt

    def _lap(self, name: str, dt: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.laps.setdefault(name, []).append(dt)

    def total(self, name: str) -> float:
        return self.totals.get(name, 0.0)


class Stopwatch:
    """Accumulates named wall-clock durations (seconds)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def track(self, name: str, *, sync: object = None):
        """Time one block.  ``sync`` is a device value — or, as in
        :meth:`StageClock.stage`, a callable producing one — blocked on
        before the timer stops, so asynchronously launched work is charged
        to the block that launched it."""
        t0 = time.perf_counter()
        ok = False
        try:
            yield
            ok = True
        finally:
            if ok and sync is not None:
                value = sync() if callable(sync) else sync
                if value is not None:
                    block_until_ready(value)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def total(self, name: str) -> float:
        return self.totals.get(name, 0.0)
