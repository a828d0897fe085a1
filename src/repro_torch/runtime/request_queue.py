"""Request-level SLO serving front-end over the multi-stream server.

:class:`~repro_torch.runtime.gnn_serve.MultiStreamServer` serves *queues*: every
batch is eligible the moment serving starts, so its latency numbers
measure pipeline residency, not service.  Real GNN inference serving is
request-driven — work arrives on a clock (steady Poisson traffic, bursts,
flash crowds), often with a deadline attached, and the serving system is
judged on enqueue→retire tail latency against that clock.  This module
adds exactly that layer, changing NOTHING below it:

  * a :class:`Request` carries its seed batch plus arrival time, optional
    deadline, and lifecycle stamps (admitted/retired/shed);
  * trace builders (:func:`poisson_trace`, :func:`burst_trace`,
    :func:`flash_crowd_trace`) generate per-stream request timelines from
    the reference's seed-content generators, so a trace of a given seed
    holds the same seeds and arrival times in both packages;
  * :class:`RequestQueueServer` subclasses the multi-stream server and
    replaces only *admission*: a pluggable policy
    (:data:`~repro_torch.core.policies.ADMISSION_POLICIES` — round-robin, EDF,
    SLO-aware shedding) ranks the streams whose HEAD request has arrived,
    while the executor schedule, per-stream runtimes, caps, and cursor
    mechanics are inherited unchanged.  With ``admission="round-robin"``
    and all arrivals at 0 the admission log — and therefore every output,
    slot draw, and hit counter — is bit-for-bit the base server's
    (tests/test_torch_request_queue.py).

Arrival-clock semantics: time 0 is the start of the serve loop
(``_serve_t0``); a request whose ``arrival_s`` is in the future is
invisible to admission.  While waiting for arrivals the generator yields
the executor's :data:`~repro_torch.runtime.pipeline.DRAIN` sentinel (retire
admitted work rather than idle with a full window) and only ``sleep``\\ s
once nothing is in flight — keeping enqueue→retire accounting honest.
Per-request latency is ``retired_s - arrival_s`` (queueing included),
which is what the p50/p95/p99 columns in ``StreamReport``/``ServeReport``
report under this front-end.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Sequence

import numpy as np

from repro_torch.core.policies import ADMISSION_POLICIES, AdmissionPolicy
from repro_torch.core.retry import StageTimeout
from repro_torch.runtime.gnn_serve import (
    MultiStreamServer,
    ServeReport,
    StreamReport,
    StreamState,
)
from repro_torch.runtime.pipeline import DRAIN

__all__ = [
    "Request",
    "RequestQueueServer",
    "burst_trace",
    "flash_crowd_seed_batches",
    "flash_crowd_trace",
    "poisson_trace",
    "uniform_seed_batches",
]


@dataclasses.dataclass
class Request:
    """One inference request: a seed batch on an arrival clock.

    ``arrival_s``/``deadline_s`` are seconds on the serve clock (0 = serve
    start).  ``admitted_s``/``retired_s`` are stamped by the server;
    ``shed`` marks a request the SLO policy dropped (it never ran) OR one
    the fault-shedding policy dropped after its retries exhausted (it ran
    and failed — ``timed_out`` says whether a stage timeout killed it),
    ``deferred`` one whose blown deadline was demoted to best-effort (it
    still runs, after everything that can still meet a deadline).
    ``degraded`` marks a request answered from cache only (miss path
    down — hit rows real, miss rows zero); ``retries`` counts the backoff
    retries its batch needed."""

    request_id: int
    stream_id: int
    seeds: np.ndarray
    arrival_s: float = 0.0
    deadline_s: float | None = None
    admitted_s: float | None = None
    retired_s: float | None = None
    shed: bool = False
    deferred: bool = False
    timed_out: bool = False
    degraded: bool = False
    retries: int = 0

    @property
    def latency_s(self) -> float | None:
        """Enqueue→retire latency; None until retired (or if shed)."""
        if self.retired_s is None:
            return None
        return max(self.retired_s - self.arrival_s, 0.0)

    @property
    def deadline_met(self) -> bool | None:
        """None when no deadline; shed / never-retired counts as a miss."""
        if self.deadline_s is None:
            return None
        if self.shed or self.retired_s is None:
            return False
        return self.retired_s <= self.deadline_s

    @property
    def admission_deadline_s(self) -> float | None:
        """The deadline as admission policies should see it: a deferred
        (blown, demoted) request sorts as deadline-free."""
        return None if self.deferred else self.deadline_s


# ------------------------------------------------------------ seed content
def uniform_seed_batches(dataset, *, n_batches: int, batch_size: int, seed: int = 0):
    """Batches drawn uniformly over the test set — one stream's worth of
    :func:`~repro_torch.runtime.gnn_serve.make_stream_batches` content (same rng
    discipline, so request traces and queue serves are content-comparable)."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(dataset.test_idx)
    need = n_batches * batch_size
    if len(ids) < need:  # tiny datasets: cycle to fill
        ids = np.tile(ids, -(-need // max(len(ids), 1)))
    return list(ids[:need].reshape(n_batches, batch_size))


def flash_crowd_seed_batches(dataset, *, n_batches: int, batch_size: int, seed: int = 0):
    """Every batch a fresh permutation of ONE small fixed seed pool — a
    concentrated hot set."""
    rng = np.random.default_rng(seed)
    pool_size = min(batch_size, len(dataset.test_idx))
    pool = rng.choice(dataset.test_idx, size=pool_size, replace=False)
    if pool_size < batch_size:  # tiny test sets: cycle the pool to fill
        pool = np.tile(pool, -(-batch_size // pool_size))[:batch_size]
    return [rng.permutation(pool) for _ in range(n_batches)]


# ------------------------------------------------------------ trace builders
def _with_deadline(arrival: float, slo_s: float | None) -> float | None:
    return None if slo_s is None else float(arrival) + float(slo_s)


def poisson_trace(
    dataset,
    *,
    num_streams: int,
    requests_per_stream: int,
    batch_size: int,
    mean_interarrival_s: float,
    slo_s: float | None = None,
    seed: int = 0,
) -> list[list[Request]]:
    """Steady traffic: each stream's inter-arrival gaps are exponential
    with the given mean (a Poisson process per stream), content uniform
    over the test set.  ``slo_s`` attaches a relative deadline to every
    request."""
    out: list[list[Request]] = []
    for sid in range(num_streams):
        batches = uniform_seed_batches(
            dataset, n_batches=requests_per_stream, batch_size=batch_size, seed=seed + sid
        )
        rng = np.random.default_rng([seed, sid, 1])  # distinct from the content rng
        arrivals = np.cumsum(rng.exponential(mean_interarrival_s, size=requests_per_stream))
        out.append(
            [
                Request(
                    request_id=i,
                    stream_id=sid,
                    seeds=b,
                    arrival_s=float(t),
                    deadline_s=_with_deadline(t, slo_s),
                )
                for i, (b, t) in enumerate(zip(batches, arrivals))
            ]
        )
    return out


def burst_trace(
    dataset,
    *,
    burst_requests: int,
    steady_requests: int,
    batch_size: int,
    service_estimate_s: float,
    slo_s: float | None = None,
    seed: int = 0,
) -> list[list[Request]]:
    """A flash-crowd burst colliding with a steady stream — the workload
    where admission order moves the p99.

    Stream 0 (the burst) dumps ``burst_requests`` flash-crowd batches at
    t=0; stream 1 (steady) spaces uniform-content requests one service
    time apart, so it alone would run at ~100% utilization with ~zero
    queueing.  Round-robin interleaves the two, roughly doubling the
    burst's drain time (tail ≈ 2·B·service); EDF with a uniform SLO
    drains the burst's backlog first — its deadlines are earliest — for a
    tail ≈ B·service."""
    burst_batches = flash_crowd_seed_batches(
        dataset, n_batches=burst_requests, batch_size=batch_size, seed=seed
    )
    burst = [
        Request(
            request_id=i,
            stream_id=0,
            seeds=b,
            arrival_s=0.0,
            deadline_s=_with_deadline(0.0, slo_s),
        )
        for i, b in enumerate(burst_batches)
    ]
    steady_batches = uniform_seed_batches(
        dataset, n_batches=steady_requests, batch_size=batch_size, seed=seed + 1
    )
    steady = [
        Request(
            request_id=i,
            stream_id=1,
            seeds=b,
            arrival_s=i * service_estimate_s,
            deadline_s=_with_deadline(i * service_estimate_s, slo_s),
        )
        for i, b in enumerate(steady_batches)
    ]
    return [burst, steady]


def flash_crowd_trace(
    dataset,
    *,
    num_streams: int,
    requests_per_stream: int,
    batch_size: int,
    slo_s: float | None = None,
    seed: int = 0,
) -> list[list[Request]]:
    """Every stream dumps its whole (flash-crowd content) queue at t=0 —
    the all-at-once saturation case; with an SLO attached, most of the
    backlog is shed-able, which is what exercises the shed/defer paths."""
    out: list[list[Request]] = []
    for sid in range(num_streams):
        batches = flash_crowd_seed_batches(
            dataset, n_batches=requests_per_stream, batch_size=batch_size, seed=seed + sid
        )
        out.append(
            [
                Request(
                    request_id=i,
                    stream_id=sid,
                    seeds=b,
                    arrival_s=0.0,
                    deadline_s=_with_deadline(0.0, slo_s),
                )
                for i, b in enumerate(batches)
            ]
        )
    return out


# ---------------------------------------------------------------- the server
class RequestQueueServer(MultiStreamServer):
    """Serve request traces (arrival times + deadlines) instead of queues.

    Streams are registered with :meth:`add_request_stream`; each keeps its
    requests in a per-stream arrival-ordered deque (``state.requests``)
    while the base class's ``state.queue`` stays empty — every inherited
    mechanism that counts *admitted* work (in-flight caps, clocks,
    runtimes) is reused as is.  ``admission`` picks
    the policy: ``"round-robin"`` (the bit-for-bit baseline), ``"edf"``,
    ``"slo"`` (EDF + shed), a policy class, or an instance.
    """

    def __init__(self, engine, *, admission=None, **kw):
        super().__init__(engine, **kw)
        if admission is None:
            # ``admission`` stays a live keyword (it accepts policy classes
            # and instances, which ServeConfig's string field cannot carry);
            # when omitted it resolves from the ServeConfig.
            admission = self.config.admission
        if isinstance(admission, str):
            try:
                admission = ADMISSION_POLICIES[admission]
            except KeyError:
                raise ValueError(
                    f"unknown admission policy {admission!r}; "
                    f"known: {sorted(ADMISSION_POLICIES)}"
                ) from None
        if isinstance(admission, type):
            admission = admission()
        if not isinstance(admission, AdmissionPolicy):
            raise TypeError(f"admission must be an AdmissionPolicy, got {type(admission)!r}")
        self.policy = admission
        self.total_shed = 0

    # ------------------------------------------------------------- intake
    def add_request_stream(
        self,
        requests: Sequence[Request],
        *,
        seed: int | None = None,
        collect_outputs: bool = False,
        draws=None,
    ) -> StreamState:
        """Register one stream's request trace (sorted by arrival).
        ``draws`` are the per-request slot draws in admission order, as
        :meth:`MultiStreamServer.add_stream` takes them."""
        state = super().add_stream([], seed=seed, collect_outputs=collect_outputs, draws=draws)
        state.requests = collections.deque(sorted(requests, key=lambda r: r.arrival_s))
        state.completed = []
        state.shed_requests = []
        state._inflight_reqs = {}
        return state

    # -------------------------------------------------------------- clock
    def _now(self) -> float:
        """Seconds on the serve clock (0 until the loop starts)."""
        if self._serve_t0 is None:
            return 0.0
        return time.perf_counter() - self._serve_t0

    def _inflight_total(self) -> int:
        return sum(s.inflight for s in self.streams)

    def _warmup_seeds(self):
        heads = [s.requests[0] for s in self.streams if getattr(s, "requests", None)]
        if not heads:
            return None
        return min(heads, key=lambda r: (r.arrival_s, r.stream_id)).seeds

    # ---------------------------------------------------------- admission
    def _shed_blown(self, pending, now):
        """Drop (or demote) every ARRIVED request whose deadline already
        passed; future requests are untouched — their deadlines are judged
        when they arrive.  Returns the streams that still have requests."""
        still = []
        for s in pending:
            keep = collections.deque()
            for req in s.requests:
                blown = (
                    req.deadline_s is not None
                    and not req.deferred
                    and req.arrival_s <= now
                    and req.deadline_s < now
                )
                if blown and self.policy.blown == "shed":
                    req.shed = True
                    s.shed_requests.append(req)
                    self.total_shed += 1
                    if self.tracer.enabled:
                        self.tracer.instant(
                            "shed",
                            lane=f"req:s{s.stream_id}",
                            args={"request": req.request_id, "deadline_s": req.deadline_s},
                        )
                        self.tracer.counter("shed", {"total": float(self.total_shed)})
                    continue
                if blown:
                    req.deferred = True  # keeps its slot, sorts deadline-free
                keep.append(req)
            s.requests = keep
            if s.requests:
                still.append(s)
        return still

    def _select(self, arrived, now) -> StreamState:
        """Policy-ranked choice over streams whose head request arrived.

        ``order() -> None`` (round-robin) delegates to the inherited
        cursor; otherwise the first ranked stream under its in-flight cap
        wins, falling back to the most urgent one when all are saturated
        (admission must make progress — the cap bounds relative occupancy,
        mirroring the base class)."""
        ranked = self.policy.order([(s.stream_id, s.requests[0]) for s in arrived], now)
        if ranked is None:
            return self._next_stream(arrived)
        by_id = {s.stream_id: s for s in arrived}
        for key, _req in ranked:
            s = by_id[key]
            if s.inflight < self.max_inflight:
                return s
        return by_id[ranked[0][0]]

    def _admission(self):
        """Arrival-aware lazy admission for the executor.

        Each pull: shed blown work (SLO policies), then admit the policy's
        pick among streams whose head has arrived.  No arrivals yet →
        DRAIN the window if anything is in flight (so retires — and their
        latency stamps — happen at the time work finishes, not at the next
        admission), else sleep the gap to the next arrival."""
        while True:
            pending = [s for s in self.streams if getattr(s, "requests", None)]
            if not pending:
                return
            now = self._now()
            if self.policy.sheds:
                pending = self._shed_blown(pending, now)
                if not pending:
                    continue
            arrived = [s for s in pending if s.requests[0].arrival_s <= now]
            if not arrived:
                if self._inflight_total():
                    yield DRAIN
                    continue
                gap = min(s.requests[0].arrival_s for s in pending) - self._now()
                if gap > 0:
                    time.sleep(gap)
                continue
            s = self._select(arrived, now)
            req = s.requests.popleft()
            req.admitted_s = self._now()
            s._inflight_reqs[s.submitted] = req
            yield self._admit(s, req.seeds)

    def _enqueue_ts_us(self, s: StreamState, batch: int) -> float:
        """Requests enqueue when they *arrive*, so the ``queued`` trace
        span starts on the request's arrival clock — its full duration is
        the queueing wait the enqueue→retire latency columns report."""
        req = s._inflight_reqs.get(batch)
        if req is None or self._serve_t0 is None:
            return super()._enqueue_ts_us(s, batch)
        return self.tracer.ts_from(self._serve_t0 + req.arrival_s)

    # ------------------------------------------------------------- retire
    def _on_retire(self, ctx) -> None:
        s: StreamState = ctx.stream
        req: Request = s._inflight_reqs.pop(s.retired)  # retiring batch's index
        super()._on_retire(ctx)
        req.retired_s = self._now()
        req.retries = int(ctx.outputs.get("_retried", 0))
        req.degraded = bool(ctx.outputs.get("_degraded", False))
        # The base class booked admit→retire; requests are judged on
        # enqueue→retire (queueing wait included).
        s.latencies[-1] = max(req.retired_s - req.arrival_s, 0.0)
        s.completed.append(req)

    def _shed_inflight(self, s: StreamState, idx: int, root: BaseException) -> None:
        """Fault-shedding under the request front-end: the dying batch is
        carrying exactly one request — pop it off the in-flight map (so
        retire-side bookkeeping can never also complete it: shed XOR
        completed, counted exactly once) and mark why it died."""
        req = s._inflight_reqs.pop(idx, None)
        if req is not None:
            req.shed = True
            req.timed_out = isinstance(root, StageTimeout)
            s.shed_requests.append(req)
            self.total_shed += 1
        super()._shed_inflight(s, idx, root)

    # ----------------------------------------------------------- reporting
    def _stream_weight(self, key) -> float:
        """Queue-depth pressure plus SLO pressure: requests that have
        arrived and will (at the stream's median latency) finish at or
        past their deadline each add 1."""
        s = self.streams[key]
        reqs = getattr(s, "requests", ())
        base = 1.0 + len(reqs) + s.inflight
        now = self._now()
        est = float(np.median(s.latencies)) if s.latencies else 0.0
        pressure = sum(
            1
            for r in reqs
            if r.deadline_s is not None and r.arrival_s <= now and r.deadline_s <= now + est
        )
        return base + pressure

    def _stream_report(self, s: StreamState) -> StreamReport:
        rep = super()._stream_report(s)
        completed = getattr(s, "completed", [])
        shed = getattr(s, "shed_requests", [])
        # Timed-out requests are excluded from the SLO denominator: a
        # stage timeout is an infrastructure failure, reported on its own
        # axis (``requests_timed_out``), not a scheduling miss — folding
        # it into deadline_hit_rate would double-charge one event to two
        # rates.  Counted exactly once either way: shed XOR completed.
        with_deadline = [
            r for r in (*completed, *shed) if r.deadline_s is not None and not r.timed_out
        ]
        rep.requests_shed = len(shed)
        rep.requests_timed_out = sum(1 for r in (*completed, *shed) if r.timed_out)
        rep.requests_retried = sum(1 for r in completed if r.retries)
        rep.requests_degraded = sum(1 for r in completed if r.degraded)
        rep.deadline_total = len(with_deadline)
        rep.deadline_hits = sum(1 for r in with_deadline if r.deadline_met)
        return rep

    def _unserved(self) -> int:
        return sum(len(getattr(s, "requests", ())) for s in self.streams)

    def _resolved_config(self):
        # Echo the policy actually installed (a class/instance passed via
        # the ``admission`` keyword may differ from the config string).
        return super()._resolved_config().replace(admission=self.policy.name)

    def _serve_report(self, wall: float) -> ServeReport:
        rep = super()._serve_report(wall)
        rep.admission = self.policy.name
        rep.requests_shed = sum(s.requests_shed for s in rep.streams)
        rep.deadline_hits = sum(s.deadline_hits for s in rep.streams)
        rep.deadline_total = sum(s.deadline_total for s in rep.streams)
        return rep
