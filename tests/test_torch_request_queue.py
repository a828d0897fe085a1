"""The port's request-level serving front-end
(``repro_torch.runtime.request_queue``) and admission policies on the CPU.

  * against the JAX package — the admission policies order random
    candidates the same way, the three trace builders give the same seeds
    and arrival floats, EDF and SLO admission give the same admission log
    on a flash-crowd trace, and degraded serving marks the same requests
    with logits within 1e-4 (hit rows real, miss rows zero);
  * round-robin with zero arrival offsets is exactly the queue-backed
    server (admission log, outputs, hit counters);
  * SLO admission sheds exactly the arrived-and-blown requests, and every
    request is accounted for: completed + shed == the trace;
  * a request whose attempts all time out is shed once and left out of
    the deadline-hit denominator — timed against a 100 ms budget with
    0.5 s injected delays, a wide margin over any gather at this size.
"""

import numpy as np
import pytest
import torch
from _torch_serving import (
    BATCH,
    STREAM_SEEDS,
    assert_close_outputs,
    assert_same_outputs,
    port_dataset,
    port_engine,
    ref_pair,
    replay_draws,
)

from repro.core import faults as jfaults
from repro.core import policies as jpolicies
from repro.core.config import EngineConfig as JaxEngineConfig
from repro.core.config import ServeConfig as JaxServeConfig
from repro.runtime import request_queue as jrq
from repro_torch.core.config import EngineConfig, ServeConfig
from repro_torch.core.faults import FaultInjector, FaultPlan, FaultRule
from repro_torch.core.policies import (
    ADMISSION_POLICIES,
    AdmissionPolicy,
    EDFAdmission,
    RoundRobinAdmission,
    SLOAdmission,
)
from repro_torch.runtime.gnn_serve import MultiStreamServer, make_stream_batches
from repro_torch.runtime.request_queue import (
    Request,
    RequestQueueServer,
    burst_trace,
    flash_crowd_trace,
    poisson_trace,
    uniform_seed_batches,
)

# One intra-op thread: these tests share the machine with other test workers.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset():
    return port_dataset()


@pytest.fixture(scope="module")
def engine(dataset):
    return port_engine(dataset)


def _cfg(depth, **kw):
    return ServeConfig(engine=EngineConfig(pipeline_depth=depth), **kw)


def _queues(dataset, n=3, batches=3):
    return make_stream_batches(
        dataset, num_streams=n, batches_per_stream=batches, batch_size=BATCH, seed=7
    )


def _as_requests(queue, sid, *, arrivals=None, deadlines=None):
    n = len(queue)
    arrivals = arrivals if arrivals is not None else [0.0] * n
    deadlines = deadlines if deadlines is not None else [None] * n
    return [
        Request(request_id=i, stream_id=sid, seeds=b, arrival_s=a, deadline_s=d)
        for i, (b, a, d) in enumerate(zip(queue, arrivals, deadlines))
    ]


# --------------------------------------------------- policy ordering (pure)


class _Req:
    def __init__(self, arrival, deadline, deferred=False):
        self.arrival_s = arrival
        self.deadline_s = deadline
        self.deferred = deferred

    @property
    def admission_deadline_s(self):
        return None if self.deferred else self.deadline_s


def test_edf_orders_by_deadline_then_arrival_then_key():
    p = EDFAdmission()
    cands = [(0, _Req(0.0, 9.0)), (1, _Req(0.0, 1.0)), (2, _Req(0.5, 1.0)), (3, _Req(0.0, None))]
    assert [k for k, _ in p.order(cands, now=0.0)] == [1, 2, 0, 3]
    assert [k for k, _ in p.order(list(reversed(cands)), now=0.0)] == [1, 2, 0, 3]
    deferred = [(0, _Req(0.0, 1.0, deferred=True)), (1, _Req(0.0, 50.0))]
    assert [k for k, _ in p.order(deferred, now=0.0)] == [1, 0]


def test_fifo_orders_by_arrival_and_round_robin_defers():
    cands = [(0, _Req(2.0, None)), (1, _Req(1.0, None))]
    assert [k for k, _ in AdmissionPolicy().order(cands, now=0.0)] == [1, 0]
    assert RoundRobinAdmission().order(cands, now=0.0) is None


def test_admission_policy_registry_and_validation():
    assert set(ADMISSION_POLICIES) == set(jpolicies.ADMISSION_POLICIES) == {
        "round-robin", "edf", "slo"}
    assert SLOAdmission().blown == "shed" and SLOAdmission().sheds
    assert SLOAdmission("defer").blown == "defer"
    with pytest.raises(ValueError):
        SLOAdmission("drop-everything")


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("name", ["fifo", "round-robin", "edf", "slo"])
def test_policy_order_matches_reference_on_random_candidates(seed, name):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9))
    arrivals = rng.choice([0.0, 0.5, 1.0, 2.0], n)  # ties on purpose
    deadlines = [None if rng.random() < 0.3 else float(rng.choice([1.0, 3.0, 5.0]))
                 for _ in range(n)]
    deferred = rng.random(n) < 0.2
    cands = [(int(k), _Req(float(a), d, bool(f)))
             for k, a, d, f in zip(rng.permutation(n), arrivals, deadlines, deferred)]

    def policy(module):
        return module.AdmissionPolicy() if name == "fifo" else module.ADMISSION_POLICIES[name]()

    import repro_torch.core.policies as tpolicies

    ours = policy(tpolicies).order(cands, now=1.0)
    theirs = policy(jpolicies).order(cands, now=1.0)
    assert (None if ours is None else [k for k, _ in ours]) == (
        None if theirs is None else [k for k, _ in theirs])


# ------------------------------------------------------------ trace builders


def _trace_key(trace):
    return [[(r.request_id, r.stream_id, r.arrival_s, r.deadline_s, r.seeds.tolist())
             for r in stream] for stream in trace]


@pytest.mark.parametrize("builder", ["poisson", "burst", "flash-crowd"])
def test_traces_match_reference(small_dataset, dataset, builder):
    """Each trace builder gives the reference's seeds and arrival floats
    (both draw them with numpy from the same seeds)."""
    if builder == "poisson":
        kw = dict(num_streams=3, requests_per_stream=5, batch_size=16,
                  mean_interarrival_s=0.01, slo_s=0.5, seed=3)
        ours, theirs = poisson_trace(dataset, **kw), jrq.poisson_trace(small_dataset, **kw)
    elif builder == "burst":
        kw = dict(burst_requests=5, steady_requests=8, batch_size=16,
                  service_estimate_s=0.02, slo_s=0.1, seed=4)
        ours, theirs = burst_trace(dataset, **kw), jrq.burst_trace(small_dataset, **kw)
    else:
        kw = dict(num_streams=3, requests_per_stream=2, batch_size=16, slo_s=0.05, seed=2)
        ours, theirs = flash_crowd_trace(dataset, **kw), jrq.flash_crowd_trace(small_dataset, **kw)
    assert _trace_key(ours) == _trace_key(theirs)
    for stream in ours:
        assert [r.arrival_s for r in stream] == sorted(r.arrival_s for r in stream)
    kw = dict(n_batches=3, batch_size=16, seed=5)
    assert_same_outputs(uniform_seed_batches(dataset, **kw),
                        jrq.uniform_seed_batches(small_dataset, **kw))


def test_burst_trace_structure(dataset):
    burst, steady = burst_trace(dataset, burst_requests=5, steady_requests=8, batch_size=16,
                                service_estimate_s=0.02, slo_s=0.1, seed=0)
    assert all(r.arrival_s == 0.0 and r.stream_id == 0 for r in burst)
    assert [r.arrival_s for r in steady] == pytest.approx([i * 0.02 for i in range(8)])
    pool = set(burst[0].seeds.tolist())
    assert all(set(r.seeds.tolist()) == pool for r in burst)


# ------------------------------------------------------- against the reference


@pytest.fixture(scope="module")
def pair(small_dataset):
    return ref_pair(small_dataset, "dci")


@pytest.mark.parametrize("admission", ["edf", "slo"])
def test_flash_crowd_admission_log_matches_reference(pair, small_dataset, admission):
    ref, eng = pair
    kw = dict(num_streams=3, requests_per_stream=3, batch_size=BATCH, slo_s=3600.0, seed=7)
    jtrace = jrq.flash_crowd_trace(small_dataset, **kw)
    jsrv = jrq.RequestQueueServer(
        ref, config=JaxServeConfig(engine=JaxEngineConfig(pipeline_depth=2)), admission=admission)
    for sid, reqs in enumerate(jtrace):
        jsrv.add_request_stream(reqs, seed=STREAM_SEEDS[sid], collect_outputs=True)
    jrep = jsrv.run()
    srv = RequestQueueServer(eng, config=_cfg(2), admission=admission)
    for sid, reqs in enumerate(flash_crowd_trace(eng.dataset, **kw)):
        srv.add_request_stream(reqs, seed=STREAM_SEEDS[sid], collect_outputs=True,
                               draws=replay_draws(ref, STREAM_SEEDS[sid],
                                                  [r.seeds for r in reqs]))
    rep = srv.run()
    assert srv.admission_log == jsrv.admission_log
    assert rep.admission == jrep.admission == admission
    assert (rep.deadline_hits, rep.deadline_total) == (jrep.deadline_hits, jrep.deadline_total)
    assert (rep.feat_hits, rep.adj_hits) == (jrep.feat_hits, jrep.adj_hits)
    for st, jst in zip(srv.streams, jsrv.streams):
        assert_close_outputs(st.runtime.outputs, jst.runtime.outputs)


def test_degraded_serving_matches_reference(pair, small_dataset):
    """host_fetch down on a seeded schedule, degraded mode on: the same
    requests are answered degraded (the same fault calls land), with the
    same hit counts and logits within 1e-4 — miss rows zero on both sides."""
    ref, eng = pair
    queues = make_stream_batches(eng.dataset, num_streams=2, batches_per_stream=4,
                                 batch_size=BATCH, seed=7)
    plan = dict(seed=4, rules=[dict(site="host_fetch", probability=0.6)])
    kw = dict(fault_policy="retry", retry_attempts=2, retry_backoff_ms=0.01, degraded_mode=True)
    jsrv = jrq.RequestQueueServer(
        ref, config=JaxServeConfig(engine=JaxEngineConfig(pipeline_depth=2), **kw),
        injector=jfaults.FaultInjector(jfaults.FaultPlan.from_dict(plan)))
    srv = RequestQueueServer(eng, config=_cfg(2, **kw),
                             injector=FaultInjector(FaultPlan.from_dict(plan)))
    for sid, q in enumerate(queues):
        jsrv.add_request_stream(_as_requests(q, sid), seed=STREAM_SEEDS[sid],
                                collect_outputs=True)
        srv.add_request_stream(_as_requests(q, sid), seed=STREAM_SEEDS[sid],
                               collect_outputs=True,
                               draws=replay_draws(ref, STREAM_SEEDS[sid], q))
    jrep, rep = jsrv.run(), srv.run()
    marks = [[r.degraded for r in s.completed] for s in srv.streams]
    assert marks == [[r.degraded for r in s.completed] for s in jsrv.streams]
    assert 0 < rep.requests_degraded == jrep.requests_degraded < rep.total_batches
    assert rep.faults == jrep.faults
    assert (rep.feat_hits, rep.adj_hits) == (jrep.feat_hits, jrep.adj_hits)
    for st, jst in zip(srv.streams, jsrv.streams):
        assert_close_outputs(st.runtime.outputs, jst.runtime.outputs)


# ------------------------------------------------------- bit-for-bit baseline


def test_round_robin_requests_match_queue_server_exactly(engine, dataset):
    queues = _queues(dataset)
    base = MultiStreamServer(engine, config=_cfg(2))
    base_states = [base.add_stream(q, seed=STREAM_SEEDS[i], collect_outputs=True)
                   for i, q in enumerate(queues)]
    base_rep = base.run()
    rq = RequestQueueServer(engine, config=_cfg(2), admission="round-robin")
    rq_states = [rq.add_request_stream(_as_requests(q, i), seed=STREAM_SEEDS[i],
                                       collect_outputs=True)
                 for i, q in enumerate(queues)]
    rq_rep = rq.run()
    assert rq.admission_log == base.admission_log and rq_rep.admission == "round-robin"
    assert (rq_rep.feat_hits, rq_rep.adj_hits) == (base_rep.feat_hits, base_rep.adj_hits)
    for bs, rs in zip(base_states, rq_states):
        assert_same_outputs(bs.runtime.outputs, rs.runtime.outputs)
    for s in rq.streams:
        assert not s.requests and len(s.completed) == 3
        assert all(r.retired_s is not None and r.latency_s >= 0 for r in s.completed)
    assert rq_rep.requests_shed == 0 and rq_rep.deadline_total == 0
    assert rq_rep.deadline_hit_rate == 1.0
    assert rq_rep.p99_latency_s >= rq_rep.p50_latency_s > 0


def test_edf_admission_drains_earliest_deadlines_first(engine, dataset):
    queues = _queues(dataset, n=2, batches=2)
    traces = [_as_requests(queues[0], 0, deadlines=[10.0, 30.0]),
              _as_requests(queues[1], 1, deadlines=[5.0, 20.0])]
    rq = RequestQueueServer(engine, config=_cfg(1), admission="edf")
    for i, t in enumerate(traces):
        rq.add_request_stream(t, seed=STREAM_SEEDS[i])
    rep = rq.run()
    assert rq.admission_log == [(1, 0), (0, 0), (1, 1), (0, 1)]
    assert rep.admission == "edf" and rep.total_batches == 4


def test_slo_admission_sheds_blown_requests(engine, dataset):
    (queue,) = _queues(dataset, n=1, batches=4)
    rq = RequestQueueServer(engine, config=_cfg(1), admission="slo")
    rq.add_request_stream(_as_requests(queue, 0, deadlines=[-1.0, 3600.0, -1.0, 3600.0]),
                          seed=STREAM_SEEDS[0])
    rep = rq.run()
    s = rq.streams[0]
    assert len(s.shed_requests) == 2 and all(r.shed for r in s.shed_requests)
    assert all(r.deadline_met is False for r in s.shed_requests)
    assert len(s.completed) == 2 and all(r.deadline_met for r in s.completed)
    assert rep.requests_shed == 2 and rq.total_shed == 2 and rep.total_batches == 2
    assert (rep.deadline_hits, rep.deadline_total) == (2, 4) and rep.deadline_hit_rate == 0.5
    assert rep.streams[0].summary()["requests_shed"] == 2


def test_slo_defer_runs_blown_requests_last(engine, dataset):
    queues = _queues(dataset, n=2, batches=2)
    traces = [_as_requests(queues[0], 0, deadlines=[-1.0, -1.0]),
              _as_requests(queues[1], 1, deadlines=[3600.0, 3600.0])]
    rq = RequestQueueServer(engine, config=_cfg(1), admission=SLOAdmission("defer"))
    for i, t in enumerate(traces):
        rq.add_request_stream(t, seed=STREAM_SEEDS[i])
    rep = rq.run()
    assert rq.total_shed == 0 and rep.total_batches == 4
    assert rq.admission_log == [(1, 0), (1, 1), (0, 0), (0, 1)]
    assert all(r.deferred for r in rq.streams[0].completed)
    assert (rep.deadline_hits, rep.deadline_total) == (2, 4)


def test_future_arrivals_wait_and_latency_counts_queueing(engine, dataset):
    (queue,) = _queues(dataset, n=1, batches=2)
    rq = RequestQueueServer(engine, config=_cfg(1), admission="round-robin")
    rq.add_request_stream(_as_requests(queue, 0, arrivals=[0.0, 0.25]), seed=STREAM_SEEDS[0])
    rq.run()
    (s,) = rq.streams
    assert [r.request_id for r in s.completed] == [0, 1]
    late = s.completed[1]
    assert late.admitted_s >= late.arrival_s
    assert late.latency_s == pytest.approx(late.retired_s - late.arrival_s)
    assert s.latencies[-1] == pytest.approx(late.latency_s)


def test_request_server_rejects_unknown_policy(engine):
    with pytest.raises(ValueError):
        RequestQueueServer(engine, admission="lifo")
    with pytest.raises(TypeError):
        RequestQueueServer(engine, admission=42)


# --------------------------------------------------- fault-tolerant accounting


def test_timed_out_requests_shed_once_and_excluded_from_slo(engine, dataset):
    """A request whose attempts all overrun the per-attempt budget is shed
    exactly once (never also completed), marked timed-out, and left out of
    the deadline-hit denominator.  Two injected 0.5 s delays against a
    100 ms budget and a 2-attempt retry: one request exhausts on timeouts,
    the delay cap is then spent, and every other request completes."""
    (queue,) = _queues(dataset, n=1, batches=4)
    plan = FaultPlan(rules=(FaultRule("host_fetch", kind="delay", latency_s=0.5,
                                      start_after=1, max_faults=2),))
    cfg = _cfg(2, fault_policy="shed", retry_attempts=2, retry_backoff_ms=0.01,
               retry_timeout_ms=100.0)
    rq = RequestQueueServer(engine, config=cfg, injector=FaultInjector(plan))
    rq.add_request_stream(_as_requests(queue, 0, deadlines=[3600.0] * 4), seed=STREAM_SEEDS[0])
    rep = rq.run()
    (s,) = rq.streams
    done = {r.request_id for r in s.completed}
    shed = {r.request_id for r in s.shed_requests}
    assert len(shed) == 1 and len(done) == 3
    assert done | shed == {0, 1, 2, 3} and not (done & shed)
    assert s.shed_requests[0].shed and s.shed_requests[0].timed_out
    assert rep.requests_shed == 1 == rq.total_shed and rep.requests_timed_out == 1
    assert rep.unserved == 0
    assert (rep.deadline_total, rep.deadline_hits, rep.deadline_hit_rate) == (3, 3, 1.0)
    assert rep.availability == pytest.approx(3 / 4) and rep.fault_policy == "shed"


def test_request_retry_and_degraded_marking(engine, dataset):
    (queue,) = _queues(dataset, n=1, batches=3)
    plan = FaultPlan(rules=(FaultRule("host_fetch", start_after=1, max_faults=1),))
    cfg = _cfg(2, fault_policy="retry", retry_attempts=3, retry_backoff_ms=0.01)
    rq = RequestQueueServer(engine, config=cfg, injector=FaultInjector(plan))
    rq.add_request_stream(_as_requests(queue, 0), seed=STREAM_SEEDS[0])
    rep = rq.run()
    (s,) = rq.streams
    assert len(s.completed) == 3 and rep.requests_shed == 0
    assert [r.retries > 0 for r in s.completed] == [False, True, False]
    assert rep.requests_retried == 1 and rep.availability == 1.0
    assert not any(r.degraded for r in s.completed)
