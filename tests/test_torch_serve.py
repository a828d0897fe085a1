"""The port's multi-stream server (``repro_torch.runtime.gnn_serve``) on the
CPU: against the JAX reference's server, and on its own invariants.

  * against the reference — the same streams (the reference's per-stream
    slot draws replayed into the port) give the same admission log and
    hit counters, and logits within 1e-4, for dci, rain and dgl at depth
    1 and 3;
  * per-stream serial equivalence — N interleaved streams give, per
    stream, logits and hit counters identical to that stream's batches
    alone through the engine with the same seed;
  * shared accounting, round-robin admission with backpressure, no
    starvation, and the CLI's serving flags.
"""

import json

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
    solo_engine,
    spy_runtimes,
)

from repro.core.config import EngineConfig as JaxEngineConfig
from repro.core.config import ServeConfig as JaxServeConfig
from repro.runtime.gnn_serve import MultiStreamServer as JaxServer
from repro.runtime.gnn_serve import make_stream_batches as jax_make_stream_batches
from repro_torch.core.config import EngineConfig, ServeConfig
from repro_torch.kernels.cached_gather import kernel as tk
from repro_torch.launch import infer_gnn
from repro_torch.core.policies import POLICIES
from repro_torch.runtime.gnn_serve import MultiStreamServer, make_stream_batches
from repro_torch.runtime.sharded_serve import ShardedServer

# One intra-op thread: these tests share the machine with other test workers.
torch.set_num_threads(1)


def _cfg(depth, **engine_kw):
    return ServeConfig(engine=EngineConfig(pipeline_depth=depth, **engine_kw))


def _queues(dataset, n=3, batches=3):
    return make_stream_batches(
        dataset, num_streams=n, batches_per_stream=batches, batch_size=BATCH, seed=7
    )


@pytest.fixture(scope="module")
def dataset():
    return port_dataset()


@pytest.fixture(scope="module")
def engine(dataset):
    return port_engine(dataset)


def _serve(engine, queues, cfg, **add_kw):
    server = MultiStreamServer(engine, config=cfg)
    states = [
        server.add_stream(q, seed=STREAM_SEEDS[i], collect_outputs=True, **add_kw)
        for i, q in enumerate(queues)
    ]
    return server, server.run(), states


def _solo(engine, queue, seed, **run_kw):
    solo = solo_engine(engine, seed)
    rep = solo.run(batches=list(queue), collect_outputs=True, **run_kw)
    return rep, solo.last_outputs


# ------------------------------------------------------- against the reference


@pytest.fixture(scope="module", params=["dci", "rain", "dgl"])
def pair(request, small_dataset):
    return request.param, *ref_pair(small_dataset, request.param)


@pytest.mark.parametrize("depth", [1, 3])
def test_server_matches_reference_server(pair, small_dataset, depth):
    policy, ref, eng = pair
    queues = jax_make_stream_batches(
        small_dataset, num_streams=3, batches_per_stream=3, batch_size=BATCH, seed=7
    )
    jsrv = JaxServer(ref, config=JaxServeConfig(engine=JaxEngineConfig(pipeline_depth=depth)))
    for i, q in enumerate(queues):
        jsrv.add_stream(q, seed=STREAM_SEEDS[i], collect_outputs=True)
    jrep = jsrv.run()
    server = MultiStreamServer(eng, config=_cfg(depth))
    for i, q in enumerate(queues):
        server.add_stream(q, seed=STREAM_SEEDS[i], collect_outputs=True,
                          draws=replay_draws(ref, STREAM_SEEDS[i], q))
    rep = server.run()
    assert server.admission_log == jsrv.admission_log
    assert rep.policy == jrep.policy == policy and rep.total_batches == jrep.total_batches == 9
    for s, js, st, jst in zip(rep.streams, jrep.streams, server.streams, jsrv.streams):
        assert (s.adj_hits, s.adj_lookups) == (js.adj_hits, js.adj_lookups)
        assert (s.feat_hits, s.feat_lookups) == (js.feat_hits, js.feat_lookups)
        assert st.max_inflight_seen == jst.max_inflight_seen
        assert_close_outputs(st.runtime.outputs, jst.runtime.outputs)
    if policy == "dci":
        assert 0 < rep.feat_hits < rep.feat_lookups


# ------------------------------------------------------------------ the route


@pytest.fixture(scope="module", params=sorted(POLICIES))
def routed_engine(request, dataset):
    """An engine whose pipeline's route defaults differ from
    ``EngineConfig``'s: the kernel route with dedup."""
    return port_engine(dataset, request.param, config=EngineConfig(use_kernel=True, dedup=True))


@pytest.mark.parametrize("explicit", [False, True])
def test_one_route_everywhere(routed_engine, dataset, explicit, monkeypatch):
    """The gather route is ``EngineConfig.resolved(pipe)`` wherever it is
    read: the engine report's config, the run's runtime and its warm-up's,
    every stream runtime (and warm-up runtime) of the plain and the sharded
    server, and the served config.  Unset fields take the pipeline's
    defaults, and RAIN's reuse turns dedup off."""
    eng = routed_engine
    pipe = eng.pipeline
    cfg = EngineConfig(prefetch=True, use_kernel=False, dedup=True) if explicit else EngineConfig()
    want = cfg.resolved(pipe)
    assert (want.prefetch, want.use_kernel) == (explicit, not explicit)
    assert want.dedup == (pipe.name != "rain")
    made = spy_runtimes(monkeypatch)
    rep = eng.run(config=cfg.replace(pipeline_depth=1), max_batches=1)
    assert rep.config == cfg.resolved(pipe, pipeline_depth=1)
    assert (rep.prefetch, rep.dedup) == (want.prefetch, want.dedup)
    assert len(made) == 2 and all(rt.route == rep.config for rt in made)  # warm-up, run
    for server in (
        MultiStreamServer(eng, config=ServeConfig(engine=cfg)),
        ShardedServer(eng, config=ServeConfig(engine=cfg), num_shards=2),
    ):
        del made[:]
        for q in _queues(dataset, n=2, batches=1):
            server.add_stream(q)
        served = server.run()
        assert server.route == want and made and all(rt.route == want for rt in made)
        assert served.config.engine == server._resolved_config().engine
        assert served.config.engine == cfg.resolved(pipe, pipeline_depth=server.depth)
        assert (served.prefetch, served.dedup) == (want.prefetch, want.dedup)


# --------------------------------------------------------------- equivalence


@pytest.mark.parametrize("policy", ["dci", "rain", "dgl"])
@pytest.mark.parametrize("depth", [1, 3])
def test_per_stream_serial_equivalence(dataset, policy, depth):
    """Interleaving N streams changes nothing a stream can observe — RAIN's
    cross-batch reuse included, because reuse state is per-stream."""
    eng = port_engine(dataset, policy)
    queues = _queues(dataset)
    _, report, states = _serve(eng, queues, _cfg(depth))
    assert report.num_streams == len(queues)
    for i, q in enumerate(queues):
        ref_rep, ref_out = _solo(eng, q, STREAM_SEEDS[i])
        rt = states[i].runtime
        assert (ref_rep.adj_hits, ref_rep.adj_lookups) == (rt.adj_hits, rt.adj_lookups)
        assert (ref_rep.feat_hits, ref_rep.feat_lookups) == (rt.feat_hits, rt.feat_lookups)
        assert_same_outputs(ref_out, rt.outputs)


def test_serve_prefetch_bit_identical_and_capped(engine, dataset):
    """Prefetch on the shared schedule: outputs and hit accounting are those
    of the prefetch-off serve, prefetched rows equal the misses, and
    per-stream staging respects the backpressure cap."""
    queues = _queues(dataset)
    cfg = ServeConfig(engine=EngineConfig(pipeline_depth=2), max_inflight=2)
    _, rep_off, off = _serve(engine, queues, cfg)
    _, rep_on, on = _serve(engine, queues, cfg.replace(engine=cfg.engine.replace(prefetch=True)))
    assert rep_on.prefetch and not rep_off.prefetch
    assert (rep_off.feat_hits, rep_off.adj_hits) == (rep_on.feat_hits, rep_on.adj_hits)
    assert sum(s.prefetched_rows for s in rep_on.streams) == rep_on.feat_lookups - rep_on.feat_hits
    for a, b in zip(off, on):
        assert b.max_inflight_seen <= 2
        assert_same_outputs(a.runtime.outputs, b.runtime.outputs)


@pytest.mark.parametrize("use_kernel,dedup", [(False, True), (True, False), (True, True)])
def test_serve_routes_match_the_table_route(engine, dataset, use_kernel, dedup):
    queues = _queues(dataset, n=2, batches=2)
    _, base, base_states = _serve(engine, queues, _cfg(2))
    _, rep, states = _serve(engine, queues, _cfg(2, use_kernel=use_kernel, dedup=dedup))
    assert rep.config.engine.use_kernel == use_kernel and rep.dedup == dedup
    assert (rep.feat_hits, rep.adj_hits) == (base.feat_hits, base.adj_hits)
    for a, b in zip(base_states, states):
        assert_same_outputs(a.runtime.outputs, b.runtime.outputs)


def test_single_stream_server_matches_engine(engine, dataset):
    (queue,) = _queues(dataset, n=1, batches=4)
    server, report, _ = _serve(engine, [queue], _cfg(1))
    ref_rep, ref_out = _solo(engine, queue, STREAM_SEEDS[0])
    s = report.streams[0]
    assert (s.adj_hits, s.feat_hits) == (ref_rep.adj_hits, ref_rep.feat_hits)
    assert report.total_batches == ref_rep.num_batches
    assert_same_outputs(ref_out, server.streams[0].runtime.outputs)


# ---------------------------------------------------------------- accounting


def test_aggregate_accounting_sums_streams(engine, dataset):
    _, rep, _ = _serve(engine, _queues(dataset), _cfg(2))
    assert rep.adj_hits == sum(s.adj_hits for s in rep.streams)
    assert rep.adj_lookups == sum(s.adj_lookups for s in rep.streams)
    assert rep.feat_hits == sum(s.feat_hits for s in rep.streams)
    assert rep.feat_lookups == sum(s.feat_lookups for s in rep.streams)
    assert rep.total_batches == 9 and rep.total_seeds == 9 * BATCH
    assert 0 < rep.feat_hit_rate <= 1 and rep.throughput_seeds_per_s > 0
    # the H100's published link rates, never a TPU's
    assert rep.modeled_transfer_seconds() == pytest.approx(
        (rep.feat_lookups - rep.feat_hits) * rep.feat_row_bytes / 64e9
        + (rep.adj_lookups - rep.adj_hits) * 4 / 64e9
        + (rep.feat_hits * rep.feat_row_bytes + rep.adj_hits * 4) / 3.35e12
    )
    summary = rep.summary()
    assert summary["streams"] == 3 and len(summary["per_stream"]) == 3
    assert summary["device"] == "cpu" and summary["config"]["engine"]["pipeline_depth"] == 2
    assert "faults" not in summary  # no injector: no fault accounting


def test_per_stream_clocks_and_latencies(engine, dataset):
    _, rep, _ = _serve(engine, _queues(dataset, batches=2), _cfg(2))
    for s in rep.streams:
        assert s.num_batches == 2
        assert s.sample_seconds > 0 and s.feature_seconds > 0 and s.compute_seconds > 0
        assert s.mean_latency_s > 0 and s.max_latency_s >= s.mean_latency_s
        assert s.p99_latency_s >= s.p50_latency_s > 0
    assert rep.p99_latency_s >= rep.p95_latency_s >= rep.p50_latency_s > 0


# ----------------------------------------------------------------- admission


def test_round_robin_admission_with_backpressure(engine, dataset):
    """Uneven queues (6/2/1), cap 1: round-robin while everyone has work;
    the lone remaining stream is allowed past its cap only once the
    others drained (admission must make progress)."""
    all_batches = _queues(dataset, n=1, batches=9)[0]
    queues = [all_batches[:6], all_batches[6:8], all_batches[8:9]]
    server, rep, _ = _serve(engine, queues,
                            ServeConfig(engine=EngineConfig(pipeline_depth=2), max_inflight=1))
    assert server.admission_log == [
        (0, 0), (1, 0), (2, 0), (0, 1), (1, 1), (0, 2), (0, 3), (0, 4), (0, 5),
    ]
    assert [s.num_batches for s in rep.streams] == [6, 2, 1]
    assert [s.max_inflight_seen for s in server.streams] == [2, 1, 1]


def test_no_starvation_first_round_covers_every_stream(engine, dataset):
    server, _, _ = _serve(engine, _queues(dataset, batches=2), _cfg(3))
    assert {sid for sid, _ in server.admission_log[:3]} == {0, 1, 2}


def test_make_stream_batches_matches_reference(small_dataset, dataset):
    kw = dict(num_streams=3, batches_per_stream=4, batch_size=32, seed=5)
    ours, theirs = make_stream_batches(dataset, **kw), jax_make_stream_batches(small_dataset, **kw)
    assert len(ours) == 3 and all(len(q) == 4 for q in ours)
    for q_ours, q_theirs in zip(ours, theirs):
        assert_same_outputs(q_ours, q_theirs)
    assert not all(np.array_equal(a, b) for a, b in zip(ours[0], ours[1]))


# -------------------------------------------------------------------- errors


def test_server_rejects_bad_config(engine, dataset):
    with pytest.raises(ValueError):
        MultiStreamServer(engine, config=ServeConfig(engine=EngineConfig(pipeline_depth=0)))
    with pytest.raises(ValueError):
        ServeConfig(max_inflight=0)
    with pytest.raises(RuntimeError):
        MultiStreamServer(engine, config=_cfg(1)).run()
    with pytest.raises(ValueError):  # an interval mode needs an interval
        MultiStreamServer(engine, config=ServeConfig(engine=EngineConfig(
            refresh_mode="interval", refresh_interval=0)))
    with pytest.raises(ValueError):
        ServeConfig(mesh=-1)
    server = MultiStreamServer(engine, config=_cfg(1))
    with pytest.raises(ValueError, match="draws cover"):
        server.add_stream(_queues(dataset, n=1, batches=2)[0], draws=[[]])
    unprepared = solo_engine(engine, 0)
    unprepared.pipeline = None
    with pytest.raises(RuntimeError):
        MultiStreamServer(unprepared)


def test_a_kernel_error_propagates_through_a_shedding_server(engine, dataset, monkeypatch):
    """fault_policy="shed" drops only fault-subsystem errors: a kernel's
    RuntimeError is no fault of the plan and ends the run unchanged."""
    calls = []

    def broken(*args, **kwargs):
        calls.append(1)
        raise RuntimeError("dci_cached_gather launch failed: CUDA error 700")

    monkeypatch.setattr(tk, "cached_gather", broken)
    cfg = ServeConfig(engine=EngineConfig(pipeline_depth=2, use_kernel=True),
                      fault_policy="shed", retry_attempts=3, retry_backoff_ms=0.01,
                      degraded_mode=True)
    server = MultiStreamServer(engine, config=cfg)
    server.add_stream(_queues(dataset, n=1, batches=2)[0])
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        server.run(warmup=False, raise_on_error=False)
    assert calls == [1]  # neither retried nor rerouted
    assert server.streams[0].batches_shed == 0


# ----------------------------------------------------------------------- CLI


@pytest.mark.parametrize("extra", [
    ["--streams", "3", "--batches-per-stream", "2", "--use-kernel", "--pipeline-depth", "2"],
    ["--arrival", "burst", "--admission", "slo", "--slo-ms", "400",
     "--batches-per-stream", "2"],
    ["--arrival", "poisson", "--streams", "2", "--batches-per-stream", "2",
     "--mean-interarrival-ms", "1", "--admission", "edf"],
])
def test_cli_serves(capsys, tmp_path, extra):
    trace, metrics = tmp_path / "t.json", tmp_path / "m.prom"
    infer_gnn.main(["--device", "cpu", "--dataset", "reddit", "--scale", "0.002",
                    "--fanouts", "4,3", "--batch-size", "128", "--presample", "2",
                    "--cache-mb", "0.5", "--trace", str(trace), "--metrics", str(metrics),
                    *extra])
    rep = json.loads(capsys.readouterr().out)
    streams = 2 if "burst" in extra or "poisson" in extra else 3
    assert rep["device"] == "cpu" and rep["streams"] == streams
    assert rep["batches"] == (6 if "burst" in extra else 2 * streams)
    assert rep["p99_latency_s"] >= rep["p50_latency_s"] > 0
    if "--arrival" in extra:
        assert rep["admission"] == extra[extra.index("--admission") + 1]
    assert any(e.get("name") == "service" for e in json.loads(trace.read_text())["traceEvents"])
    assert "seeds_served_total" in metrics.read_text()


def test_cli_refuses_what_is_not_ported():
    """Refresh and the mesh are ported, so the CLI refuses only the values
    the reference refuses: a negative mesh, an interval refresh without
    an interval, a threshold outside (0, 1], an unknown mode."""
    base = ["--device", "cpu", "--dataset", "reddit", "--scale", "0.001"]
    with pytest.raises(ValueError, match="mesh"):
        infer_gnn.main([*base, "--mesh", "-1"])
    with pytest.raises(ValueError, match="interval"):
        infer_gnn.main([*base, "--refresh-mode", "interval", "--refresh-interval", "0"])
    with pytest.raises(ValueError, match="miss_threshold"):
        infer_gnn.main([*base, "--refresh-mode", "events", "--refresh-miss-threshold", "1.5"])
    with pytest.raises(SystemExit):
        infer_gnn.main([*base, "--refresh-mode", "sometimes"])
