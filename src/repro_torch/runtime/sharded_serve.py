"""Sharded dual-cache serving over a list of devices.

Layout: the feature table and feature cache are range-partitioned into
shards (graph/shard.py — each shard holds its id range's view of the host
table and a local hot table re-slotted from the global fill), while the
adjacency cache is replicated per device so sampling never crosses
devices.  Streams round-robin over the replicas; each batch's frontier is
partitioned on the host, every shard gathers only its rows on its own
device (kernel #1, or #2 under dedup, once per shard with rows), and the
results are copied to the assembling device and reassembled through the
inverse permutation.  With one device (one H100, or the CPU) the shards
are co-resident: the same partition, the same per-shard accounting, no
copies between devices, and one adjacency copy shared by every stream.

Per-shard Eq. 1 allocation runs on each shard's slice of the visit
counts (:func:`repro_torch.core.allocation.shard_allocations`); Eq. 1's
split fraction is scale-invariant, so every shard's adj:feat split is
the global one and the globally ranked fill partitions by id range
without moving a row.  That is what makes sharded serving bit-for-bit
the single-store path: logits, hit masks, per-epoch counters and refresh
deltas are the same at any shard count and across the knob grid
(tests/test_torch_sharded_serve.py).

Online refresh stays global: the shared refresh manager re-allocates and
delta re-fills the base caches, and the server then repartitions the
per-shard stores to the new epoch on the same retire boundary, recording
per-shard allocations from the sliced history.

The host partition (``np.argsort``/``searchsorted`` over the frontier's
ids, read back from the card once per batch) and the per-shard hit
accounting at retire run on the host, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.allocation import shard_allocations
from repro_torch.core.faults import InjectedFault
from repro_torch.graph.csc import BYTES_PER_ADJ_ELEMENT
from repro_torch.graph.shard import ShardedFeatureStore, make_shard_plan
from repro_torch.launch.mesh import make_serving_mesh, serving_devices
from repro_torch.runtime.gnn_engine import StreamRuntime, modeled_transfer_seconds
from repro_torch.runtime.gnn_serve import MultiStreamServer, ServeReport

__all__ = ["ShardedDualCache", "ShardedServer", "ShardedStreamRuntime"]


@dataclasses.dataclass
class ShardedDualCache:
    """The DualCache's sharded runtime view: per-shard feature stores and
    per-device adjacency replicas, rebuilt (repartitioned) whenever the
    base caches move to a new epoch.

    ``base`` stays the single source of truth — the dedup pad id, the
    refresh manager and the epoch counter all read it — so the sharded
    layout cannot drift from the global fill."""

    base: object  # core.cache.DualCache
    plan: object  # graph.shard.ShardPlan
    store: ShardedFeatureStore
    adj_replicas: list
    devices: list | None
    epoch: int
    # Failover state (core/faults.py ``shard_exchange`` site): shard id ->
    # retired batches left until rejoin (-1: until the process ends).
    # While a shard is down its id range is read from its host table onto
    # the assembling device — the same values and hit accounting, another
    # byte route.
    down: dict = dataclasses.field(default_factory=dict)
    failovers: list = dataclasses.field(default_factory=list)

    @property
    def down_set(self) -> set:
        return set(self.down)

    def mark_down(self, shard: int, *, down_for: int | None = None, call: int = 0) -> None:
        """Record a lost shard; idempotent while already down."""
        if shard not in self.down:
            self.down[shard] = -1 if down_for is None else int(down_for)
            self.failovers.append(
                {"shard": int(shard), "down_for": self.down[shard], "call": int(call)}
            )

    def note_retired(self) -> list[int]:
        """Tick rejoin countdowns at a retire boundary; returns the shards
        that just rejoined (their exchange resumes on the next batch)."""
        rejoined = []
        for shard in list(self.down):
            if self.down[shard] < 0:
                continue
            self.down[shard] -= 1
            if self.down[shard] <= 0:
                del self.down[shard]
                rejoined.append(shard)
        return rejoined

    @classmethod
    def build(cls, caches, num_shards: int, devices=None) -> "ShardedDualCache":
        plan = make_shard_plan(caches.store.num_nodes, num_shards)
        return cls(
            base=caches,
            plan=plan,
            store=ShardedFeatureStore.partition_store(caches.store, plan, devices),
            adj_replicas=cls._replicate_adj(caches.dgraph, devices),
            devices=devices,
            epoch=caches.epoch,
        )

    @staticmethod
    def _replicate_adj(dgraph, devices) -> list:
        """One adjacency replica per shard device (shards on the same
        device share one copy; the co-resident layout shares the base
        tensors outright)."""
        if not devices:
            return [dgraph]
        copies: dict = {}
        out = []
        for d in devices:
            if d not in copies:
                copies[d] = dgraph if d == dgraph.device else type(dgraph)(
                    **{f.name: getattr(dgraph, f.name).to(d) for f in dataclasses.fields(dgraph)}
                )
            out.append(copies[d])
        return out

    def adj_replica(self, i: int):
        return self.adj_replicas[i % len(self.adj_replicas)]

    def repartition(self) -> dict:
        """Re-slice the per-shard stores and replicas from the base caches
        (after a base refresh).  Returns the per-shard cached-row counts
        before and after, for the repartition log."""
        before = self.store.shard_cached_rows()
        self.store = ShardedFeatureStore.partition_store(self.base.store, self.plan, self.devices)
        self.adj_replicas = self._replicate_adj(self.base.dgraph, self.devices)
        self.epoch = self.base.epoch
        return {
            "epoch": self.epoch,
            "rows_before": before,
            "rows_after": self.store.shard_cached_rows(),
        }


class ShardedStreamRuntime(StreamRuntime):
    """A :class:`StreamRuntime` whose cache accesses go through the
    sharded layout.  Only the cache-access hooks (and the per-shard
    accounting at retire) differ from the base class: control flow,
    draws and every counter the reports show stay the same."""

    def __init__(self, *args, sharded: ShardedDualCache, replica: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.sharded = sharded
        self.replica = replica
        k = sharded.plan.num_shards
        self.shard_feat_hits = np.zeros(k, np.int64)
        self.shard_feat_lookups = np.zeros(k, np.int64)
        self.shard_gathered_rows = np.zeros(k, np.int64)
        self.shard_prefetched_rows = np.zeros(k, np.int64)
        self.shard_gathers = np.zeros(k, np.int64)  # segments gathered (one launch each)

    # --------------------------------------------------- cache-access hooks
    def _sample_graph(self):
        return self.sharded.adj_replica(self.replica)

    def _resolve_dedup(self, ctx, block):
        view = super()._resolve_dedup(ctx, block)
        assemble = self.sharded.store.assemble_device
        if assemble is not None:
            # The inverse was made on this stream's sampling replica; the
            # forward reads it beside the exchanged rows on the assembling
            # device, so it is copied there (the same values).
            dd, nu, bucket, uids = view
            dd = dataclasses.replace(dd, inverse=dd.inverse.to(assemble))
            view = (dd, nu, bucket, uids)
            ctx.outputs["_dedup"] = view
        return view

    def _partition(self, ctx, ids):
        part = ctx.outputs.get("_shardpart")
        if part is None:
            if isinstance(ids, torch.Tensor):
                ids = ids.cpu().numpy()  # the id read: one device->host copy
            num_live = self._dedup_view(ctx)[1] if self.dedup else None
            part = self.sharded.store.partition(ids, num_live=num_live)
            ctx.outputs["_shardpart"] = part
        return part

    def _prefetch(self, ctx, nodes, num_live=None):
        del num_live  # the partition's per-shard live windows carry it
        if self.injector is not None:
            # Charged once per batch (the per-shard fan-out below is one
            # staging), as FeatureStore.prefetch_misses charges it.
            self.injector.check("prefetch")
        staged = self.sharded.store.prefetch(
            self._partition(ctx, nodes), down=self.sharded.down_set or None
        )
        for s, p in enumerate(staged.parts):
            if p is not None:
                self.shard_prefetched_rows[s] += p.num_miss
        return staged

    def _gather(self, ctx, indices, **gather_kw):
        if self.injector is not None:
            # Charged once per batch, as FeatureStore.gather charges them.
            self.injector.check("host_fetch")
            if gather_kw.get("use_kernel"):
                self.injector.check("kernel_gather")
        part = self._partition(ctx, indices)
        for s, buf in enumerate(part.seg_ids):
            if buf is not None:
                self.shard_gathered_rows[s] += len(buf)
                self.shard_gathers[s] += 1
        while True:
            try:
                return self.sharded.store.gather(
                    part,
                    tracer=self.tracer,
                    injector=self.injector,
                    down=self.sharded.down_set or None,
                    **gather_kw,
                )
            except InjectedFault as err:
                if err.site != "shard_exchange" or err.shard is None:
                    raise
                # A shard lost mid-exchange: fail it over to its host
                # table and gather again.  Shards already exchanged gather
                # the same bits again, the victim's segment is read from its
                # host table, and a downed shard is never charged again, so the
                # loop ends.
                rule = self.injector.plan.rule_for("shard_exchange")
                self.sharded.mark_down(
                    err.shard,
                    down_for=rule.down_for if rule is not None else None,
                    call=err.call,
                )
                if self.tracer.enabled:
                    self.tracer.complete(
                        "shard-down",
                        lane="faults",
                        ts_us=self.tracer.now_us(),
                        dur_us=0.0,
                        args={"shard": err.shard, "call": err.call},
                    )

    # ----------------------------------------------------------- accounting
    def record(self, ctx) -> None:
        super().record(ctx)
        part = ctx.outputs.get("_shardpart")
        if part is None:
            return
        feature_out = ctx.outputs["feature"]
        k = self.sharded.plan.num_shards
        if self.dedup:
            # Per-VISIT accounting by owning shard: each unique node's hit
            # bit weighted by its visit multiplicity — the shards' sums are
            # the global per-visit counters.
            dd, nu, _, _ = self._dedup_view(ctx)
            mult = np.bincount(dd.inverse.cpu().numpy(), minlength=nu)[:nu].astype(np.int64)
            hit_u = feature_out[3][:nu].cpu().numpy().astype(bool)
            asgn = part.asgn[:nu]
            np.add.at(self.shard_feat_lookups, asgn, mult)
            np.add.at(self.shard_feat_hits, asgn[hit_u], mult[hit_u])
        else:
            hit = feature_out[1].cpu().numpy().astype(bool)
            self.shard_feat_lookups += np.bincount(part.asgn, minlength=k).astype(np.int64)
            self.shard_feat_hits += np.bincount(part.asgn[hit], minlength=k).astype(np.int64)


class ShardedServer(MultiStreamServer):
    """:class:`MultiStreamServer` over the sharded dual cache.

    ``mesh`` (a list of devices; default :func:`make_serving_mesh` on the
    engine's device type) and ``num_shards`` (default ``config.mesh``,
    else one per mesh device) pick the layout: shards map round robin
    onto the mesh's devices, and when the mesh holds one device the
    shards co-reside there (one shard is bit-for-bit the base server).
    Every base knob (depth, prefetch, kernel, dedup, refresh, faults)
    composes unchanged."""

    def __init__(self, engine, *, num_shards: int | None = None, mesh=None, **kwargs):
        super().__init__(engine, **kwargs)
        if num_shards is None and self.config.mesh:
            num_shards = self.config.mesh
        if mesh is None:
            mesh = make_serving_mesh(num_shards or 1, device=engine.device)
        devices = serving_devices(mesh)
        if num_shards is None:
            num_shards = len(devices)
        self.mesh = mesh
        self.num_shards = num_shards
        shard_devices = [devices[s % len(devices)] for s in range(num_shards)]
        if len(set(devices)) == 1:
            # One device: co-resident shards, no copies between devices.
            shard_devices = None
        self.sharded = ShardedDualCache.build(engine.pipeline.caches, num_shards, shard_devices)
        self.repartition_log: list[dict] = []
        self.shard_allocations = self._initial_shard_allocations()

    # ----------------------------------------------------------- plumbing
    def _make_runtime(self, sid: int, seed: int, *, collect_outputs: bool, draws=None):
        eng = self.engine
        replica = sid % self.num_shards
        # Draws come from the stream's replica's device: a CUDA generator's
        # sequence depends on its seed and offset, not on the card.
        gen_device = self.sharded.adj_replica(replica).device
        return ShardedStreamRuntime(
            eng.pipeline,
            eng.model,
            fanouts=eng.fanouts,
            route=self.route,
            generator=(
                None
                if draws is not None
                else torch.Generator(device=gen_device).manual_seed(seed + 1)
            ),
            draws=draws,
            collect_outputs=collect_outputs,
            injector=self.injector,
            retry_policy=self.retry_policy,
            degraded_mode=self.degraded_mode,
            sharded=self.sharded,
            replica=replica,
        )

    def _initial_shard_allocations(self):
        """Per-shard Eq. 1 from the presample profile (the counts the
        global fill ranked on); None for cacheless policies."""
        alloc = self.engine.pipeline.caches.allocation
        if alloc is None:
            return None
        plan = self.sharded.plan
        bounds = [plan.bounds(s) for s in range(plan.num_shards)]
        ps = self.engine.pipeline.presample
        if ps is not None:
            counts = np.asarray(ps.node_counts, np.float64)
            weights = [float(counts[lo:hi].sum()) for lo, hi in bounds]
            sample_times = list(ps.sample_times)
            feature_times = list(ps.feature_times)
        else:
            weights = []
            sample_times = [alloc.sample_fraction]
            feature_times = [1.0 - alloc.sample_fraction]
        if not any(w > 0 for w in weights):
            weights = [float(hi - lo) for lo, hi in bounds]
        return shard_allocations(
            alloc,
            weights,
            sample_times=sample_times,
            feature_times=feature_times,
            adj_need_bytes=self.engine.dataset.graph.num_edges * BYTES_PER_ADJ_ELEMENT,
            feat_need_bytes=self.engine.dataset.features.nbytes,
        )

    def _on_retire(self, ctx) -> None:
        super()._on_retire(ctx)
        if self.sharded.down:
            # Rejoin ticks on the retire boundary, like every epoch-style
            # transition, so no batch sees a mixed layout mid-flight.
            for shard in self.sharded.note_retired():
                if self.tracer.enabled:
                    self.tracer.instant("shard-rejoin", lane="faults", args={"shard": shard})

    def _apply_refresh_event(self, event) -> None:
        super()._apply_refresh_event(event)
        # The manager refreshed the BASE caches; re-slice the shards to the
        # new epoch on the same retire boundary, and record the per-shard
        # allocations of the sliced history.
        stats = self.sharded.repartition()
        stats["reason"] = event.reason
        self.repartition_log.append(stats)
        self.shard_allocations = self.refresh_manager.shard_allocations(self.sharded.plan)

    # ---------------------------------------------------------------- run
    def _warmup_sharded(self, seeds: np.ndarray) -> None:
        """One batch through each replica's sampler, the per-shard gathers
        and the forward, outside the timed loop: ``run_batch`` on a scratch
        runtime per replica (stream state and draws untouched; no
        fault-plan calls)."""
        for r in range(min(self.num_shards, len(self.sharded.adj_replicas))):
            rt = self._make_runtime(r, self.engine.seed, collect_outputs=False)
            rt.injector = None
            rt.retry_policy = None
            rt.run_batch(seeds)

    def run(self, *, warmup: bool = True, raise_on_error: bool = True) -> ServeReport:
        if warmup:
            seeds = self._warmup_seeds()
            if seeds is not None:
                self._warmup_sharded(seeds)
        return super().run(warmup=False, raise_on_error=raise_on_error)

    # ------------------------------------------------------------- report
    def _shard_summaries(self) -> list[dict]:
        k = self.num_shards
        hits = np.zeros(k, np.int64)
        lookups = np.zeros(k, np.int64)
        gathered = np.zeros(k, np.int64)
        prefetched = np.zeros(k, np.int64)
        gathers = np.zeros(k, np.int64)
        adj_hits = np.zeros(k, np.int64)
        adj_lookups = np.zeros(k, np.int64)
        for s in self.streams:
            rt = s.runtime
            hits += rt.shard_feat_hits
            lookups += rt.shard_feat_lookups
            gathered += rt.shard_gathered_rows
            prefetched += rt.shard_prefetched_rows
            gathers += rt.shard_gathers
            # Adjacency traffic lands on the stream's sampling replica.
            adj_hits[rt.replica % k] += rt.adj_hits
            adj_lookups[rt.replica % k] += rt.adj_lookups
        row_bytes = self.engine.dataset.feature_nbytes_per_row()
        rows_cached = self.sharded.store.shard_cached_rows()
        out = []
        for i in range(k):
            entry = {
                "shard": i,
                "rows_cached": rows_cached[i],
                "feat_hits": int(hits[i]),
                "feat_lookups": int(lookups[i]),
                "adj_hits": int(adj_hits[i]),
                "adj_lookups": int(adj_lookups[i]),
                "gathered_rows": int(gathered[i]),
                "gathers": int(gathers[i]),
                "prefetched_rows": int(prefetched[i]),
                # Each shard drives its own link pair, so the mesh's
                # modeled transfer time is the max over shards.
                "modeled_transfer_s": modeled_transfer_seconds(
                    feat_lookups=int(lookups[i]),
                    feat_hits=int(hits[i]),
                    adj_lookups=int(adj_lookups[i]),
                    adj_hits=int(adj_hits[i]),
                    feat_row_bytes=row_bytes,
                ),
            }
            if self.shard_allocations is not None:
                a = self.shard_allocations[i]
                entry["allocation"] = {
                    "total_bytes": a.total_bytes,
                    "adj_bytes": a.adj_bytes,
                    "feat_bytes": a.feat_bytes,
                    "sample_fraction": round(a.sample_fraction, 6),
                }
            out.append(entry)
        return out

    def _resolved_config(self):
        # The shard count actually built (mesh=0 derives it from the mesh).
        return super()._resolved_config().replace(mesh=self.num_shards)

    def _serve_report(self, wall: float) -> ServeReport:
        rep = super()._serve_report(wall)
        rep.num_shards = self.num_shards
        rep.shards = self._shard_summaries()
        if self.sharded.failovers:
            for shard, entry in enumerate(rep.shards):
                entry["failed_over"] = any(f["shard"] == shard for f in self.sharded.failovers)
            rep.failovers = list(self.sharded.failovers)
        return rep
