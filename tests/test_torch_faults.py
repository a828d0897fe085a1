"""The port's fault injection, retry and degraded mode on the CPU
(``repro_torch.core.faults``, ``repro_torch.core.retry``, the fault
envelope of ``StreamRuntime`` and the servers' fault policies).

  * against the JAX package — fault schedules of seeded plans, retry
    delays and plan JSON are bit-identical (both sides are numpy);
  * zero-diff when disabled — fault knobs on with an empty plan leave
    outputs and hit accounting identical to the plain serve;
  * recovery — retry recovers transient faults with identical outputs,
    degraded mode answers from cache only and marks each batch, shed
    drops exactly the failing batch, fail-fast drains and records the
    error, an injected ``kernel_gather`` fault reroutes that gather to the
    table route with identical outputs;
  * a real error — a kernel's ``RuntimeError`` — is never retried,
    rerouted or shed;
  * transactional refresh — a refresh that dies mid-apply leaves the same
    tensors with the same bytes and serving goes on at the old epoch;
  * shard failover — a lost shard's range is served from its host table
    with the same outputs until it rejoins.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from _torch_serving import (
    BATCH,
    STREAM_SEEDS,
    assert_same_outputs,
    port_dataset,
    port_engine,
)

from repro.core import faults as jfaults
from repro.core import retry as jretry
from repro.core.config import ServeConfig as JaxServeConfig
from repro_torch.core import faults as tfaults
from repro_torch.core.config import EngineConfig, ServeConfig
from repro_torch.core.faults import SITES, FaultInjector, FaultPlan, FaultRule, InjectedFault
from repro_torch.core.retry import RetryExhausted, RetryPolicy, StageTimeout, call_with_retry
from repro_torch.kernels.cached_gather import kernel as tk
from repro_torch.launch import infer_gnn
from repro_torch.runtime.gnn_serve import MultiStreamServer, make_stream_batches

# One intra-op thread: these tests share the machine with other test workers.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset():
    return port_dataset()


@pytest.fixture(scope="module")
def engine(dataset):
    return port_engine(dataset)


def _queues(dataset, n=2, batches=3):
    return make_stream_batches(
        dataset, num_streams=n, batches_per_stream=batches, batch_size=BATCH, seed=7
    )


def _fast_retry(**kw):
    """A retry config whose sleeps are microscopic (tests never wait)."""
    return {**dict(fault_policy="retry", retry_attempts=3, retry_backoff_ms=0.01), **kw}


def _serve(engine, queues, *, cfg=None, injector=None, **run_kw):
    srv = MultiStreamServer(engine, config=cfg, injector=injector)
    for sid, q in enumerate(queues):
        srv.add_stream(q, seed=STREAM_SEEDS[sid], collect_outputs=True)
    rep = srv.run(**run_kw)
    return srv, rep, [s.runtime.outputs for s in srv.streams]


def _assert_same_serve(rep_a, outs_a, rep_b, outs_b):
    assert (rep_a.feat_hits, rep_a.feat_lookups) == (rep_b.feat_hits, rep_b.feat_lookups)
    assert (rep_a.adj_hits, rep_a.adj_lookups) == (rep_b.adj_hits, rep_b.adj_lookups)
    for a_list, b_list in zip(outs_a, outs_b):
        assert_same_outputs(a_list, b_list)


# ------------------------------------------------- against the JAX package


PLANS = [
    dict(seed=5, rules=[dict(site="host_fetch", probability=0.4, start_after=3, max_faults=4)]),
    dict(seed=11, rules=[dict(site="adj_fetch", probability=0.3),
                         dict(site="kernel_gather", burst_period=5, burst_length=2)]),
    dict(seed=2, rules=[dict(site="host_fetch", probability=0.05),
                        dict(site="prefetch", kind="delay", probability=0.5)]),
    dict(seed=0, rules=[dict(site="refresh_fill", max_faults=1),
                        dict(site="shard_exchange", shard=1, down_for=3)]),
]


def _schedule(faults, plan_dict, calls=120):
    inj = faults.FaultInjector(faults.FaultPlan.from_dict(plan_dict), sleep=lambda _s: None)
    out = []
    for _ in range(calls):
        for site in faults.SITES:
            try:
                inj.check(site)
            except faults.InjectedFault as err:
                out.append((site, err.call, err.shard))
    return out, inj.counts(), dict(inj.delays)


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: "+".join(r["site"] for r in p["rules"]))
def test_injector_schedule_matches_reference(plan):
    """Every site's fault decisions, counts and delays are the JAX
    package's for the same plan and call sequence."""
    assert SITES == jfaults.SITES
    assert _schedule(tfaults, plan) == _schedule(jfaults, plan)


@pytest.mark.parametrize("key", [0, 7, ("host_fetch", 3), ("adj_fetch", 12)])
@pytest.mark.parametrize("policy", [dict(), dict(max_attempts=5, backoff_s=1e-3, jitter=0.5,
                                                 max_backoff_s=4e-3, seed=9)])
def test_backoff_delays_match_reference(key, policy):
    ours, theirs = RetryPolicy(**policy), jretry.RetryPolicy(**policy)
    assert ours.backoff_delays(key) == theirs.backoff_delays(key)
    assert ours.total_backoff_bound() == theirs.total_backoff_bound()


def test_plan_json_round_trip_matches_reference(tmp_path):
    plan = FaultPlan(
        seed=13,
        rules=(
            FaultRule("host_fetch", probability=0.25, start_after=4, max_faults=7),
            FaultRule("prefetch", kind="delay", latency_s=0.002, burst_period=8, burst_length=2),
            FaultRule("shard_exchange", shard=1, down_for=3),
        ),
    )
    assert FaultPlan.from_dict(plan.to_dict()) == plan
    path = tmp_path / "plan.json"
    plan.save(str(path))
    assert FaultPlan.load(str(path)) == plan
    # the same JSON both ways between the packages
    assert jfaults.FaultPlan.load(str(path)).to_dict() == plan.to_dict()
    jpath = tmp_path / "jplan.json"
    jfaults.FaultPlan.from_dict(plan.to_dict()).save(str(jpath))
    assert jpath.read_text() == path.read_text()
    assert plan.sites == ("host_fetch", "prefetch", "shard_exchange")
    assert plan.rule_for("host_fetch").max_faults == 7
    assert plan.rule_for("refresh_fill") is None


def test_serve_config_retry_policy_matches_reference():
    kw = dict(fault_policy="shed", retry_attempts=4, retry_backoff_ms=2.5, retry_timeout_ms=100.0)
    ours, theirs = ServeConfig(**kw).retry_policy(), JaxServeConfig(**kw).retry_policy()
    assert ours.__dict__ == theirs.__dict__
    assert ServeConfig().retry_policy() is None and JaxServeConfig().retry_policy() is None


# --------------------------------------------------------------- plan (unit)


def test_plan_and_rule_validation():
    with pytest.raises(ValueError):
        FaultRule("not-a-site")
    with pytest.raises(ValueError):
        FaultRule("host_fetch", kind="explode")
    with pytest.raises(ValueError):
        FaultRule("host_fetch", probability=1.5)
    with pytest.raises(ValueError):
        FaultRule("host_fetch", burst_period=4)  # length missing
    with pytest.raises(ValueError):
        FaultRule("host_fetch", burst_period=2, burst_length=5)
    with pytest.raises(ValueError):  # duplicate site
        FaultPlan(rules=(FaultRule("host_fetch"), FaultRule("host_fetch")))
    with pytest.raises(ValueError):  # unknown JSON field
        FaultRule.from_dict({"site": "host_fetch", "blast_radius": 3})


def test_injector_schedule_is_deterministic_and_capped():
    plan = FaultPlan(
        seed=5, rules=(FaultRule("host_fetch", probability=0.4, start_after=3, max_faults=4),)
    )

    def fault_calls():
        inj = FaultInjector(plan)
        hits = []
        for call in range(60):
            try:
                inj.check("host_fetch")
            except InjectedFault as err:
                assert err.site == "host_fetch" and err.call == call
                hits.append(call)
        return hits, inj

    hits_a, inj = fault_calls()
    hits_b, _ = fault_calls()
    assert hits_a == hits_b
    assert len(hits_a) == 4 and min(hits_a) >= 3
    assert inj.counts() == {"host_fetch": {"calls": 60, "faults": 4}}
    assert inj.active("host_fetch") and not inj.active("adj_fetch")
    inj.check("adj_fetch")  # unlisted sites count calls but never fault
    assert inj.counts()["adj_fetch"] == {"calls": 1, "faults": 0}
    with pytest.raises(ValueError):
        inj.check("not-a-site")


def test_injector_draws_do_not_depend_on_window_phase():
    def hits(start_after):
        plan = FaultPlan(
            seed=11, rules=(FaultRule("host_fetch", probability=0.3, start_after=start_after),)
        )
        inj = FaultInjector(plan)
        out = []
        for call in range(80):
            try:
                inj.check("host_fetch")
            except InjectedFault:
                out.append(call)
        return out

    early, late = hits(0), hits(25)
    assert late == [c for c in early if c >= 25]


def test_injector_burst_and_delay_kinds():
    sleeps = []
    plan = FaultPlan(
        rules=(FaultRule("prefetch", kind="delay", latency_s=0.5, burst_period=4,
                         burst_length=2),)
    )
    inj = FaultInjector(plan, sleep=sleeps.append)
    for _ in range(8):
        inj.check("prefetch")  # delay kind never raises
    assert sleeps == [0.5] * 4  # calls 0, 1, 4, 5
    assert inj.delays["prefetch"] == 4
    assert inj.counts()["prefetch"] == {"calls": 8, "faults": 4}


# ------------------------------------------------------------ retry (unit)


def test_call_with_retry_recovers_then_exhausts():
    pol = RetryPolicy(max_attempts=3, backoff_s=0.0, jitter=0.0)
    attempts, retries = [], []

    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise InjectedFault("host_fetch", len(attempts))
        return 42

    got = call_with_retry(
        flaky, policy=pol, retryable=(InjectedFault,),
        on_retry=lambda a, d, e: retries.append((a, type(e).__name__)), sleep=lambda _s: None,
    )
    assert got == 42 and len(attempts) == 3
    assert retries == [(1, "InjectedFault"), (2, "InjectedFault")]

    def always():
        raise InjectedFault("host_fetch", 0)

    with pytest.raises(RetryExhausted) as ei:
        call_with_retry(always, policy=pol, retryable=(InjectedFault,), sleep=lambda _s: None)
    assert ei.value.attempts == 3 and isinstance(ei.value.last, InjectedFault)


def test_call_with_retry_propagates_non_retryable_immediately():
    calls = []

    def bug():
        calls.append(1)
        raise ValueError("real bug, not a fault")

    with pytest.raises(ValueError):
        call_with_retry(bug, policy=RetryPolicy(max_attempts=4, backoff_s=0.0, jitter=0.0),
                        retryable=(InjectedFault,), sleep=lambda _s: None)
    assert len(calls) == 1


def test_per_attempt_timeout_discards_late_success():
    ticks = iter(range(100))
    pol = RetryPolicy(max_attempts=2, backoff_s=0.0, jitter=0.0, timeout_s=0.5)
    with pytest.raises(RetryExhausted) as ei:
        call_with_retry(lambda: "late", policy=pol, retryable=(InjectedFault,),
                        sleep=lambda _s: None, clock=lambda: float(next(ticks)))
    assert isinstance(ei.value.last, StageTimeout) and ei.value.last.timeout_s == 0.5
    assert call_with_retry(lambda: "ok", policy=RetryPolicy(), sleep=lambda _s: None) == "ok"


@settings(max_examples=50, deadline=None)
@given(
    max_attempts=st.integers(1, 6),
    backoff_ms=st.floats(0.0, 10.0, allow_nan=False),
    multiplier=st.floats(1.0, 3.0, allow_nan=False),
    max_backoff_ms=st.floats(0.0, 20.0, allow_nan=False),
    jitter=st.floats(0.0, 1.0, allow_nan=False),
    seed=st.integers(0, 2**31),
    key=st.integers(0, 10_000),
)
def test_property_backoff_schedule_matches_reference_and_bounds(
    max_attempts, backoff_ms, multiplier, max_backoff_ms, jitter, seed, key
):
    kw = dict(max_attempts=max_attempts, backoff_s=backoff_ms * 1e-3,
              backoff_multiplier=multiplier, max_backoff_s=max_backoff_ms * 1e-3,
              jitter=jitter, seed=seed)
    pol = RetryPolicy(**kw)
    delays = pol.backoff_delays(key)
    assert delays == jretry.RetryPolicy(**kw).backoff_delays(key)
    assert len(delays) == max_attempts - 1
    assert all(0.0 <= d <= pol.max_backoff_s * (1.0 + jitter) + 1e-12 for d in delays)
    assert sum(delays) <= pol.total_backoff_bound() + 1e-12


@settings(max_examples=40, deadline=None)
@given(
    seed=st.integers(0, 2**31),
    probability=st.floats(0.0, 1.0, allow_nan=False),
    start_after=st.integers(0, 20),
    max_faults=st.one_of(st.none(), st.integers(0, 10)),
    site=st.sampled_from(SITES),
)
def test_property_injector_replay_matches_reference(
    seed, probability, start_after, max_faults, site
):
    plan = dict(seed=seed, rules=[dict(site=site, probability=probability,
                                       start_after=start_after, max_faults=max_faults)])
    ours, _, _ = _schedule(tfaults, plan, 40)
    assert ours == _schedule(jfaults, plan, 40)[0]
    assert all(call >= start_after for _, call, _ in ours)
    if max_faults is not None:
        assert len(ours) <= max_faults


# --------------------------------------------------------- serving, no faults


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("prefetch", [False, True])
def test_fault_knobs_without_faults_are_bit_identical(engine, dataset, dedup, prefetch):
    queues = _queues(dataset)
    engine_cfg = EngineConfig(pipeline_depth=2, dedup=dedup, prefetch=prefetch, use_kernel=True)
    _, rb, ob = _serve(engine, queues, cfg=ServeConfig(engine=engine_cfg))
    cfg = ServeConfig(engine=engine_cfg,
                      **_fast_retry(degraded_mode=True, retry_timeout_ms=10_000.0))
    srv, rf, of = _serve(engine, queues, cfg=cfg, injector=FaultInjector(FaultPlan()))
    _assert_same_serve(rb, ob, rf, of)
    assert rf.availability == 1.0 and rf.requests_retried == 0 and rf.requests_degraded == 0
    assert rf.kernel_fallbacks == 0 and rf.stage_retries == 0
    assert all(v["faults"] == 0 for v in rf.faults.values())
    assert rf.faults["kernel_gather"]["calls"] == rf.total_batches  # charged, never faulted
    assert srv.injector is not None and not srv.injector.enabled


# ---------------------------------------------------- serving: fault policies


def test_retry_recovers_transient_faults_bit_identically(engine, dataset):
    queues = _queues(dataset)
    cfg0 = ServeConfig(engine=EngineConfig(pipeline_depth=2))
    _, rb, ob = _serve(engine, queues, cfg=cfg0)
    plan = FaultPlan(seed=3, rules=(FaultRule("host_fetch", start_after=1, max_faults=2),
                                    FaultRule("adj_fetch", start_after=2, max_faults=1)))
    srv, rf, of = _serve(engine, queues, cfg=cfg0.replace(**_fast_retry()),
                         injector=FaultInjector(plan))
    _assert_same_serve(rb, ob, rf, of)
    assert rf.availability == 1.0 and rf.requests_shed == 0 and rf.requests_retried > 0
    assert rf.faults["host_fetch"]["faults"] == 2 and rf.faults["adj_fetch"]["faults"] == 1
    assert rf.stage_retries == sum(s.runtime.stage_retries for s in srv.streams) >= 3
    assert rf.summary()["fault_policy"] == "retry"


def test_degraded_mode_serves_cache_only_when_miss_path_is_down(engine, dataset):
    queues = _queues(dataset)
    plan = FaultPlan(rules=(FaultRule("host_fetch"),))  # always down
    cfg = ServeConfig(engine=EngineConfig(pipeline_depth=2),
                      **_fast_retry(retry_attempts=2, degraded_mode=True))
    srv, rep, outs = _serve(engine, queues, cfg=cfg, injector=FaultInjector(plan))
    offered = sum(len(q) for q in queues)
    assert rep.total_batches == offered and rep.availability == 1.0
    assert rep.requests_degraded == offered and rep.requests_shed == 0
    assert sum(s.runtime.degraded_batches for s in srv.streams) == offered
    assert rep.feat_lookups > 0 and rep.feat_hits > 0


@pytest.mark.parametrize(
    "plan",
    [
        FaultPlan(rules=(FaultRule("host_fetch"),)),  # every gather faults: degraded
        FaultPlan(seed=2, rules=(FaultRule("host_fetch", probability=0.5),)),  # mostly retried
    ],
    ids=["degraded", "retried"],
)
def test_faulted_batches_are_freed_without_garbage_collection(engine, dataset, plan):
    """A caught fault keeps no batch alive.  An error's traceback holds the
    frames it passed through, and their ``f_back`` chain the handlers'
    frames, so a handler that kept the error in a local would hold each
    faulted batch (on the card, a 432 MB feature tensor) in a reference
    cycle until the next garbage collection."""
    import gc

    from repro_torch.runtime.pipeline import BatchContext

    cfg = ServeConfig(engine=EngineConfig(pipeline_depth=2), **_fast_retry(degraded_mode=True))
    gc.collect()
    gc.disable()
    try:
        _, rep, _ = _serve(engine, _queues(dataset), cfg=cfg, injector=FaultInjector(plan))
        alive = sum(isinstance(o, BatchContext) for o in gc.get_objects())
    finally:
        gc.enable()
    assert rep.stage_retries > 0 and rep.availability == 1.0
    assert alive == 0


def test_degraded_gather_keeps_hit_rows_and_zeroes_miss_rows(engine, dataset):
    """The feature stage's degraded output, batch by batch: hit rows equal
    the fault-free gather's, miss rows are zero."""
    store = engine.pipeline.caches.store
    ids = torch.from_numpy(_queues(dataset, n=1, batches=1)[0][0].astype(np.int32))
    ids = torch.cat([ids, torch.arange(0, dataset.num_nodes, 7, dtype=torch.int32)])
    want, hit = store.gather(ids)
    for use_kernel in (False, True):
        inj = FaultInjector(FaultPlan(rules=(FaultRule("host_fetch"),)))
        srv = MultiStreamServer(engine, config=ServeConfig(
            engine=EngineConfig(use_kernel=use_kernel), degraded_mode=True), injector=inj)
        state = srv.add_stream([])
        ctx = type("Ctx", (), {"outputs": {}})()
        got, got_hit = state.runtime._gather_ft(ctx, ids, use_kernel=use_kernel)
        assert ctx.outputs["_degraded"] and state.runtime.degraded_batches == 1
        assert torch.equal(got_hit, hit) and 0 < int(hit.sum()) < hit.numel()
        assert torch.equal(got[hit], want[hit])
        assert not got[~hit].any()


def test_prefetch_faults_skip_staging_without_degrading(engine, dataset):
    queues = _queues(dataset)
    cfg0 = ServeConfig(engine=EngineConfig(pipeline_depth=2, prefetch=True))
    _, rb, ob = _serve(engine, queues, cfg=cfg0)
    plan = FaultPlan(rules=(FaultRule("prefetch"),))
    cfg = cfg0.replace(**_fast_retry(retry_attempts=2, degraded_mode=True))
    _, rf, of = _serve(engine, queues, cfg=cfg, injector=FaultInjector(plan))
    _assert_same_serve(rb, ob, rf, of)
    assert rf.requests_degraded == 0 and rf.availability == 1.0
    assert sum(s.prefetched_rows for s in rf.streams) == 0


def test_fail_fast_drains_and_records_the_error(engine, dataset):
    queues = _queues(dataset)
    plan = FaultPlan(rules=(FaultRule("host_fetch", start_after=2),))
    cfg = ServeConfig(engine=EngineConfig(pipeline_depth=2))
    with pytest.raises(InjectedFault):
        _serve(engine, queues, cfg=cfg, injector=FaultInjector(plan))
    _, rep, _ = _serve(engine, queues, cfg=cfg, injector=FaultInjector(plan),
                       raise_on_error=False)
    offered = sum(len(q) for q in queues)
    assert rep.error is not None and "host_fetch" in rep.error and rep.fault_policy == "fail"
    assert rep.total_batches + rep.unserved + rep.requests_shed == offered
    assert rep.availability < 1.0 and rep.summary()["error"] == rep.error


def test_shed_policy_sheds_exactly_the_failing_request(engine, dataset):
    queues = _queues(dataset, n=2, batches=3)
    plan = FaultPlan(rules=(FaultRule("host_fetch", start_after=1, max_faults=2),))
    cfg = ServeConfig(engine=EngineConfig(pipeline_depth=2),
                      **_fast_retry(fault_policy="shed", retry_attempts=2))
    srv, rep, outs = _serve(engine, queues, cfg=cfg, injector=FaultInjector(plan))
    offered = sum(len(q) for q in queues)
    assert rep.requests_shed == 1 and rep.total_batches == offered - 1 and rep.unserved == 0
    assert rep.availability == pytest.approx((offered - 1) / offered)
    assert sum(s.batches_shed for s in srv.streams) == 1
    assert sum(len(o) for o in outs) == offered - 1
    assert rep.summary()["requests_shed"] == 1


@pytest.mark.parametrize("dedup", [False, True])
def test_kernel_gather_faults_reroute_to_the_table_route(engine, dataset, dedup):
    """Injected kernel_gather faults under fail-fast: each faulted gather
    runs on the table route instead — same outputs, not degraded, counted
    in kernel_fallbacks."""
    queues = _queues(dataset)
    engine_cfg = EngineConfig(pipeline_depth=2, use_kernel=True, dedup=dedup)
    _, rb, ob = _serve(engine, queues, cfg=ServeConfig(engine=engine_cfg))
    plan = FaultPlan(rules=(FaultRule("kernel_gather", start_after=1, max_faults=2),))
    srv, rf, of = _serve(engine, queues, cfg=ServeConfig(engine=engine_cfg),
                         injector=FaultInjector(plan))
    _assert_same_serve(rb, ob, rf, of)
    assert rf.kernel_fallbacks == 2 == rf.faults["kernel_gather"]["faults"]
    assert rf.requests_degraded == 0 and rf.availability == 1.0
    assert rf.summary()["kernel_fallbacks"] == 2


@pytest.mark.parametrize("policy", ["fail", "retry", "shed"])
def test_a_real_kernel_error_is_not_a_fault(engine, dataset, monkeypatch, policy):
    """A RuntimeError from the kernel route (a failed CUDA build or launch)
    propagates through the fault envelope unchanged: not retried, not
    rerouted to the table route, not shed."""
    calls = []

    def broken(*args, **kwargs):
        calls.append(1)
        raise RuntimeError("dci_cached_gather launch failed: CUDA error 700")

    monkeypatch.setattr(tk, "cached_gather", broken)
    kw = {} if policy == "fail" else _fast_retry(fault_policy=policy)
    cfg = ServeConfig(engine=EngineConfig(pipeline_depth=1, use_kernel=True),
                      degraded_mode=True, **kw)
    srv = MultiStreamServer(engine, config=cfg, injector=FaultInjector(FaultPlan()))
    srv.add_stream(_queues(dataset, n=1, batches=2)[0])
    with pytest.raises(RuntimeError, match="CUDA error 700") as ei:
        srv.run(warmup=False, raise_on_error=False)
    assert type(ei.value) is RuntimeError
    rt = srv.streams[0].runtime
    assert calls == [1] and rt.kernel_fallbacks == 0 and rt.stage_retries == 0
    assert srv.streams[0].batches_shed == 0


def test_engine_run_accepts_live_fault_handles(engine, dataset):
    batches = _queues(dataset, n=1, batches=4)[0]
    rb = engine.run(batches=list(batches), collect_outputs=True)
    ob = list(engine.last_outputs)
    plan = FaultPlan(rules=(FaultRule("host_fetch", start_after=1, max_faults=2),))
    rf = engine.run(
        batches=list(batches), collect_outputs=True, injector=FaultInjector(plan),
        retry_policy=RetryPolicy(max_attempts=3, backoff_s=1e-5, jitter=0.0),
    )
    assert (rb.feat_hits, rb.feat_lookups) == (rf.feat_hits, rf.feat_lookups)
    assert (rb.adj_hits, rb.adj_lookups) == (rf.adj_hits, rf.adj_lookups)
    assert_same_outputs(ob, engine.last_outputs)


def test_cli_replays_a_fault_plan(capsys, tmp_path):
    plan = tmp_path / "plan.json"
    FaultPlan(seed=2, rules=(FaultRule("host_fetch", start_after=1, max_faults=2),)).save(
        str(plan))
    infer_gnn.main(["--device", "cpu", "--dataset", "reddit", "--scale", "0.002",
                    "--fanouts", "4,3", "--batch-size", "128", "--presample", "2",
                    "--cache-mb", "0.5", "--streams", "2", "--batches-per-stream", "2",
                    "--faults", str(plan), "--fault-policy", "retry",
                    "--retry-backoff-ms", "0.01"])
    rep = json.loads(capsys.readouterr().out)
    assert rep["fault_policy"] == "retry" and rep["faults"]["host_fetch"]["faults"] == 2
    assert rep["batches"] == 4 and rep["availability"] == 1.0 and rep["stage_retries"] == 2


# ------------------------------------------------------------ refresh rollback


@settings(max_examples=5, deadline=None)
@given(failed_attempts=st.integers(1, 3))
def test_property_refresh_rollback_is_byte_identical(dataset, failed_attempts):
    """However many refresh attempts die mid-apply, the cache keeps the old
    epoch's objects with unchanged bytes, and a later clean refresh lands."""
    eng = port_engine(dataset)
    caches, stats = eng.pipeline.caches, eng.pipeline.presample
    objs = (caches.dgraph, caches.store, caches.allocation, caches._adj_cache, caches.epoch)
    tensors = [caches.store.hot_table, caches.store.position_map, caches.dgraph.cache_ptr,
               caches.dgraph.cache_row_index, caches.dgraph.cached_len]
    clones = [t.clone() for t in tensors]
    grow = dataclasses.replace(caches.allocation, total_bytes=4 * caches.allocation.total_bytes,
                               feat_bytes=4 * caches.allocation.feat_bytes)
    inj = FaultInjector(FaultPlan(rules=(FaultRule("refresh_fill", max_faults=failed_attempts),)))
    for _ in range(failed_attempts):
        with pytest.raises(InjectedFault):
            caches.refresh(allocation=grow, node_counts=stats.node_counts,
                           edge_counts=stats.edge_counts, injector=inj)
        assert all(a is b for a, b in zip(
            (caches.dgraph, caches.store, caches.allocation, caches._adj_cache), objs))
        assert caches.epoch == objs[4]
        assert all(torch.equal(t, c) for t, c in zip(tensors, clones))
    delta = caches.refresh(allocation=grow, node_counts=stats.node_counts,
                           edge_counts=stats.edge_counts, injector=inj)
    assert caches.epoch == objs[4] + 1 == delta.epoch
    assert all(torch.equal(t, c) for t, c in zip(tensors, clones))  # the old epoch, untouched


def test_refresh_manager_records_rollback_and_serving_continues(dataset):
    """A refresh_fill fault mid-serve rolls the epoch back and serving
    finishes on the stale epoch: availability 1.0, the failure recorded,
    logits those of the refresh-free serve."""
    eng = port_engine(dataset)
    queues = _queues(dataset)
    cfg0 = ServeConfig(engine=EngineConfig(pipeline_depth=2))
    _, _, ob = _serve(eng, queues, cfg=cfg0)
    plan = FaultPlan(rules=(FaultRule("refresh_fill", max_faults=1),))
    cfg = cfg0.replace(engine=cfg0.engine.replace(refresh_mode="interval", refresh_interval=2),
                       **_fast_retry())
    srv, rep, of = _serve(eng, queues, cfg=cfg, injector=FaultInjector(plan))
    (failure,) = srv.refresh_manager.failures
    assert failure.epoch == 0 and "InjectedFault" in failure.error
    assert failure.summary()["reason"] == "interval"
    assert rep.availability == 1.0 and rep.faults["refresh_fill"]["faults"] == 1
    assert eng.pipeline.caches.epoch >= 1  # later refreshes committed
    for a, b in zip(ob, of):
        assert_same_outputs(a, b)


# ------------------------------------------------------------- shard failover


def _serve_sharded(engine, queues, injector, **cfg_kw):
    from repro_torch.runtime.sharded_serve import ShardedServer

    cfg = ServeConfig(engine=EngineConfig(pipeline_depth=2, **cfg_kw))
    srv = ShardedServer(engine, config=cfg, num_shards=2, injector=injector)
    for sid, q in enumerate(queues):
        srv.add_stream(q, seed=STREAM_SEEDS[sid], collect_outputs=True)
    rep = srv.run()
    return srv, rep, [s.runtime.outputs for s in srv.streams]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_shard_failover_serves_lost_range_from_host_and_rejoins(engine, dataset, use_kernel):
    """Losing a shard mid-serve routes its id range to its host table —
    outputs and hit accounting stay those of the healthy sharded serve,
    per-shard hits still tile the global counters, and the shard rejoins
    after its down_for window."""
    queues = _queues(dataset)
    _, rb, ob = _serve_sharded(engine, queues, None, use_kernel=use_kernel)
    plan = FaultPlan(rules=(
        FaultRule("shard_exchange", start_after=2, max_faults=1, shard=1, down_for=2),))
    srv, rf, of = _serve_sharded(engine, queues, FaultInjector(plan), use_kernel=use_kernel)
    _assert_same_serve(rb, ob, rf, of)
    assert rf.failovers == [{"shard": 1, "down_for": 2, "call": 2}]
    assert srv.sharded.down == {}  # rejoined before the serve ended
    assert [p.get("failed_over", False) for p in rf.shards] == [False, True]
    assert sum(p["feat_hits"] for p in rf.shards) == rf.feat_hits
    assert sum(p["feat_lookups"] for p in rf.shards) == rf.feat_lookups
    assert rf.availability == 1.0 and rf.summary()["failovers"] == rf.failovers


def test_shard_exchange_is_charged_per_shard_and_names_its_victim(engine, dataset):
    """Without a named shard every participating shard charges a call;
    with one, only that shard does.  The fault carries the victim."""
    queues = _queues(dataset, n=1, batches=2)
    inj = FaultInjector(FaultPlan(rules=(FaultRule("shard_exchange", probability=0.0),)))
    _serve_sharded(engine, queues, inj)
    assert inj.counts()["shard_exchange"] == {"calls": 4, "faults": 0}  # 2 batches x 2 shards
    inj = FaultInjector(FaultPlan(rules=(FaultRule("shard_exchange", shard=0,
                                                   probability=0.0),)))
    _serve_sharded(engine, queues, inj)
    assert inj.counts()["shard_exchange"] == {"calls": 2, "faults": 0}
    srv, rep, _ = _serve_sharded(engine, queues, FaultInjector(FaultPlan(rules=(
        FaultRule("shard_exchange", start_after=1, max_faults=1),))))
    assert rep.failovers == [{"shard": 1, "down_for": -1, "call": 1}]
    assert srv.sharded.down == {1: -1}  # no down_for: down until the process ends


def test_sharded_fault_knobs_without_faults_are_bit_identical(engine, dataset):
    queues = _queues(dataset)
    _, rb, ob = _serve_sharded(engine, queues, None, dedup=True, prefetch=True)
    srv, rf, of = _serve_sharded(engine, queues, FaultInjector(FaultPlan()), dedup=True,
                                 prefetch=True)
    _assert_same_serve(rb, ob, rf, of)
    assert rf.failovers == [] and srv.injector is not None and not srv.injector.enabled
