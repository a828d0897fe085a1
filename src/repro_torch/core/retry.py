"""Bounded, deterministic retry with per-attempt timeouts.

The fault-tolerance layer's policy half: core/faults.py decides *when*
something breaks; this module decides what a guarded call site *does*
about it.  :func:`call_with_retry` re-invokes an idempotent thunk up to
``max_attempts`` times, sleeping a bounded exponential backoff between
attempts, and converts an attempt that overruns ``timeout_s`` into a
retryable :class:`StageTimeout` — the slow-host case a ``kind="delay"``
fault models.

Determinism: the jitter on every backoff is drawn from a Philox stream
seeded ``[policy.seed, crc32(key)]``, so the full delay schedule is a
pure function of ``(policy, key)`` — replaying a fault plan replays the
exact same waits (property-tested in tests/test_faults.py).  Bounds are
closed-form: each delay is at most ``max_backoff_s * (1 + jitter)`` and
the total sleep over a call is at most :meth:`RetryPolicy.total_backoff_bound`.

Call sites must only wrap *pure/idempotent* operations (the cache
gathers, prefetch staging, and injector checks all are): an attempt that
fails must leave no state behind, or the retry would double-apply it.
"""

from __future__ import annotations

import dataclasses
import time
import zlib

import numpy as np

__all__ = [
    "RetryPolicy",
    "RetryExhausted",
    "StageTimeout",
    "call_with_retry",
]


class StageTimeout(RuntimeError):
    """An attempt overran its per-attempt wall budget."""

    def __init__(self, elapsed_s: float, timeout_s: float):
        self.elapsed_s = elapsed_s
        self.timeout_s = timeout_s
        super().__init__(f"attempt took {elapsed_s * 1e3:.2f} ms > timeout {timeout_s * 1e3:.2f} ms")


class RetryExhausted(RuntimeError):
    """Every attempt in the budget failed; ``last`` is the final error."""

    def __init__(self, attempts: int, last: BaseException):
        self.attempts = attempts
        self.last = last
        super().__init__(f"exhausted {attempts} attempts; last error: {last!r}")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Budget + backoff shape for one class of guarded calls.

    ``backoff_s`` is the base delay before attempt 2, growing by
    ``backoff_multiplier`` per retry and clamped to ``max_backoff_s``;
    ``jitter`` spreads each delay uniformly over ``±jitter`` of itself
    (seeded — see module docstring).  ``timeout_s`` is a *per-attempt*
    wall bound (``None`` = no timeout)."""

    max_attempts: int = 3
    backoff_s: float = 1e-3
    backoff_multiplier: float = 2.0
    max_backoff_s: float = 0.05
    jitter: float = 0.5
    timeout_s: float | None = None
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff_s and max_backoff_s must be >= 0")
        if self.backoff_multiplier < 1.0:
            raise ValueError(f"backoff_multiplier must be >= 1, got {self.backoff_multiplier}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")
        if self.timeout_s is not None and self.timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {self.timeout_s}")

    def backoff_delays(self, key=0) -> list[float]:
        """The full (deterministic) delay schedule for one guarded call:
        ``max_attempts - 1`` sleeps, attempt ``i``'s retry waiting
        ``min(max_backoff, backoff * multiplier**i) * (1 ± jitter)``."""
        rng = np.random.default_rng([self.seed, zlib.crc32(repr(key).encode())])
        delays = []
        for i in range(self.max_attempts - 1):
            base = min(self.max_backoff_s, self.backoff_s * self.backoff_multiplier**i)
            u = float(rng.uniform(-1.0, 1.0)) if self.jitter > 0 else 0.0
            delays.append(max(0.0, base * (1.0 + self.jitter * u)))
        return delays

    def total_backoff_bound(self) -> float:
        """Closed-form upper bound on the summed sleeps of one call."""
        return (self.max_attempts - 1) * self.max_backoff_s * (1.0 + self.jitter)


def call_with_retry(
    fn,
    *,
    policy: RetryPolicy,
    key=0,
    retryable: tuple = (Exception,),
    on_retry=None,
    sleep=time.sleep,
    clock=time.perf_counter,
):
    """Invoke ``fn()`` with the policy's retry/timeout budget.

    ``key`` seeds the jitter schedule (use something stable per call
    site, e.g. ``(site, call_index)``).  ``on_retry(attempt, delay_s,
    err)`` fires before each backoff sleep — the hook serving layers use
    for retry counters and trace marks.  Raises :class:`RetryExhausted`
    (wrapping the last error) once the budget is spent; non-retryable
    exceptions propagate immediately.
    """
    delays = policy.backoff_delays(key)
    last: BaseException | None = None
    try:
        for attempt in range(policy.max_attempts):
            t0 = clock()
            try:
                result = fn()
            except retryable as err:  # noqa: PERF203 - per-attempt handling is the point
                last = err
            else:
                elapsed = clock() - t0
                if policy.timeout_s is not None and elapsed > policy.timeout_s:
                    # The attempt "succeeded" too late to count: the result is
                    # discarded and the overrun becomes a retryable failure.
                    last = StageTimeout(elapsed, policy.timeout_s)
                else:
                    return result
            if attempt < policy.max_attempts - 1:
                delay = delays[attempt]
                if on_retry is not None:
                    on_retry(attempt + 1, delay, last)
                if delay > 0:
                    sleep(delay)
        raise RetryExhausted(policy.max_attempts, last)
    finally:
        # A caught error's traceback holds this frame: drop the frame's
        # reference to the error, or each faulted call's ``fn`` (and all
        # it reaches, a batch's tensors included) lives on in a reference
        # cycle until the next garbage collection.
        del last
