"""The port's node-id-range sharding of the feature store
(``repro_torch.graph.shard``) and its serving mesh
(``repro_torch.launch.mesh``) on the CPU.

  * against the reference — the same store and frontier give the same
    shard plan, the same per-shard local position maps and hot rows, and
    bit-identical partitions (``asgn``, ``order``, ``inv``, ``seg_ids``,
    ``seg_len``, ``seg_live``);
  * the exchange's contract — partition, per-shard gather, reassembly
    returns the bits of a single ``FeatureStore.gather`` over the same ids
    on every route (table, kernel, row-block kernel, prefetched), for any
    frontier and shard count; per-visit hits by owning shard sum to the
    single-store counters; a failed-over shard serves the same bits;
  * a shard's host table is a row-range view of the one host table.
"""

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.graph import features as jfeatures
from repro.graph import shard as jshard
from repro_torch.graph.features import build_feature_cache, plain_feature_store
from repro_torch.graph.sampling import pow2_bucket
from repro_torch.graph.shard import (
    ShardedFeatureStore,
    make_shard_plan,
    partition_feature_store,
)
from repro_torch.kernels.cached_gather.kernel import ROW_BLOCK
from repro_torch.launch.mesh import make_serving_mesh, serving_devices

N, F = 50, 8
CPU = torch.device("cpu")


def _feats_counts(n=N, f=F, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, f)).astype(np.float32), rng.integers(0, 10, n).astype(np.float64)


def _store(n=N, f=F, cached_frac=0.5, seed=0):
    feats, counts = _feats_counts(n, f, seed)
    if not cached_frac:
        return plain_feature_store(feats, device=CPU)
    budget = int(cached_frac * n) * f * feats.dtype.itemsize
    return build_feature_cache(feats, counts, budget, device=CPU)


def _jax_store(cached_frac=0.5, seed=0):
    feats, counts = _feats_counts(seed=seed)
    if not cached_frac:
        return jfeatures.plain_feature_store(feats)
    return jfeatures.build_feature_cache(feats, counts, int(cached_frac * N) * F * 4)


def _sharded(store, k, devices=None):
    return ShardedFeatureStore.partition_store(store, make_shard_plan(store.num_nodes, k), devices)


# ------------------------------------------------------------------- plan


@pytest.mark.parametrize("n,k", [(10, 3), (3, 5), (50, 1), (50, 7)])
def test_plan_matches_the_reference(n, k):
    plan, jplan = make_shard_plan(n, k), jshard.make_shard_plan(n, k)
    np.testing.assert_array_equal(plan.row_starts, jplan.row_starts)
    assert plan.num_shards == k and plan.shard_sizes().sum() == n
    ids = np.arange(n)
    np.testing.assert_array_equal(plan.shard_of(ids), jplan.shard_of(ids))
    # ids never land on an empty shard
    assert all(plan.shard_sizes()[s] > 0 for s in plan.shard_of(ids))
    with pytest.raises(ValueError):
        make_shard_plan(n, 0)


def test_plan_balanced_and_boundary_mapping():
    plan = make_shard_plan(10, 3)
    assert plan.shard_sizes().tolist() == [4, 3, 3]
    assert plan.shard_of(np.array([0, 3, 4, 6, 7, 9])).tolist() == [0, 0, 1, 1, 2, 2]


# --------------------------------------------------------- the shard stores


@pytest.mark.parametrize("cached_frac", [0.0, 0.5, 1.0])
def test_partition_store_matches_the_reference(cached_frac):
    """Same local position maps and hot rows as the reference's shards;
    each host table a view of the one host table (no copy)."""
    store = _store(cached_frac=cached_frac)
    plan = make_shard_plan(N, 4)
    shards = partition_feature_store(store, plan)
    jshards = jshard.partition_feature_store(_jax_store(cached_frac), jshard.make_shard_plan(N, 4))
    host = store.host_np()
    for s, (fs, js) in enumerate(zip(shards, jshards)):
        lo, hi = plan.bounds(s)
        assert fs.host_table.untyped_storage().data_ptr() == (
            store.host_table.untyped_storage().data_ptr())
        assert fs.host_table.data_ptr() == store.host_table[lo].data_ptr()
        np.testing.assert_array_equal(fs.host_np(), host[lo:hi])
        np.testing.assert_array_equal(fs.position_np(), js.position_np())
        np.testing.assert_array_equal(fs.position_map.numpy(), fs.position_np())
        assert tuple(fs.hot_table.shape) == js.hot_table.shape
        np.testing.assert_array_equal(fs.hot_table.numpy(), np.asarray(js.hot_table))
    assert sum(int((fs.position_np() >= 0).sum()) for fs in shards) == store.num_cached


@pytest.mark.parametrize("num_live", [None, 0, 3, 8])
@pytest.mark.parametrize("ids", [
    [3, 17, 44, 9, 28, 46, 1, 30],  # unsorted
    [1, 1, 5, 12, 12, 13, 40, 49],  # sorted, duplicates
    [20, 21, 22, 23],  # one shard
])
def test_partition_matches_the_reference(ids, num_live):
    ids = np.asarray(ids, np.int64)
    if num_live is not None and num_live > ids.size:
        num_live = ids.size
    part = _sharded(_store(), 4).partition(ids, num_live=num_live)
    jpart = jshard.ShardedFeatureStore.partition_store(
        _jax_store(), jshard.make_shard_plan(N, 4)).partition(ids, num_live=num_live)
    for name in ("ids", "asgn", "order"):
        np.testing.assert_array_equal(getattr(part, name), getattr(jpart, name))
    assert (part.inv is None) == (jpart.inv is None)
    if part.inv is not None:
        np.testing.assert_array_equal(part.inv, jpart.inv)
    assert part.seg_len == jpart.seg_len and part.seg_live == jpart.seg_live
    for a, b in zip(part.seg_ids, jpart.seg_ids):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


# ---------------------------------------------------------------- round trip


@pytest.mark.parametrize("k", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("cached_frac", [0.0, 0.5, 1.0])
def test_gather_matches_single_store(k, cached_frac):
    store = _store(cached_frac=cached_frac)
    ss = _sharded(store, k)
    ids = np.random.default_rng(3).integers(0, N, size=37).astype(np.int64)  # unsorted, dups
    part = ss.partition(ids)
    want_f, want_h = store.gather(torch.from_numpy(ids))
    for kw in (dict(), dict(use_kernel=True), dict(use_kernel=True, row_block=ROW_BLOCK)):
        feats, hit = ss.gather(part, **kw)
        assert torch.equal(feats, want_f) and torch.equal(hit, want_h)


def test_all_ids_on_one_shard_and_sorted_identity():
    store = _store()
    ss = _sharded(store, 4)
    lo, hi = ss.plan.bounds(2)
    ids = np.arange(lo, hi, dtype=np.int64)
    part = ss.partition(ids)
    assert part.inv is None  # the stable shard-sort is the identity
    assert [b is not None for b in part.seg_ids] == [False, False, True, False]
    feats, hit = ss.gather(part)
    want_f, want_h = store.gather(torch.from_numpy(ids))
    assert torch.equal(feats, want_f) and torch.equal(hit, want_h)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefetch_counts_and_gather_match_single_store(use_kernel):
    store = _store()
    ss = _sharded(store, 3)
    ids = np.unique(np.random.default_rng(5).integers(0, N, size=40)).astype(np.int64)
    nu = ids.size
    padded = np.full(pow2_bucket(nu), store.pad_node_id(), np.int64)
    padded[:nu] = ids
    part = ss.partition(padded, num_live=nu)
    staged = ss.prefetch(part)
    want_staged = store.prefetch_misses(padded, num_live=nu)
    assert staged.num_miss == want_staged.num_miss
    feats, hit = ss.gather(part, prefetched=staged, use_kernel=use_kernel)
    want_f, want_h = store.gather(torch.from_numpy(padded), prefetched=want_staged,
                                  use_kernel=use_kernel)
    assert torch.equal(feats, want_f) and torch.equal(hit, want_h)


def test_seg_live_windows_cover_exactly_the_live_prefix():
    ss = _sharded(_store(), 4)
    ids = np.array([3, 17, 44, 9, 28, 46, 1, 30], np.int64)
    for num_live in range(len(ids) + 1):
        part = ss.partition(ids, num_live=num_live)
        assert sum(part.seg_live) == num_live
        counts = np.bincount(ss.plan.shard_of(ids[:num_live]), minlength=4)
        assert part.seg_live == counts.tolist()


def test_failover_and_placed_shards_give_the_same_bits():
    """A failed-over shard is read from its host table (on every route:
    the kernel's plain version, the row-block one and the table route),
    and shards placed on an explicit device list (copies to the
    assembling device) give the bits of the co-resident layout."""
    store = _store()
    ids = np.random.default_rng(9).integers(0, N, size=33).astype(np.int64)
    want_f, want_h = store.gather(torch.from_numpy(ids))
    ss = _sharded(store, 4)
    part = ss.partition(ids)
    for kw in ({"use_kernel": True}, {"use_kernel": True, "row_block": 4}, {}):
        feats, hit = ss.gather(part, down={1, 3}, **kw)
        assert torch.equal(feats, want_f) and torch.equal(hit, want_h)
    placed = _sharded(store, 4, devices=[CPU] * 4)
    assert placed.assemble_device == CPU
    feats, hit = placed.gather(placed.partition(ids), use_kernel=True)
    assert torch.equal(feats, want_f) and torch.equal(hit, want_h)


# ------------------------------------------------------ properties (given)


@settings(max_examples=25, deadline=None)
@given(
    ids=st.lists(st.integers(min_value=0, max_value=N - 1), min_size=1, max_size=60),
    k=st.integers(min_value=1, max_value=8),
    cached_frac=st.sampled_from([0.0, 0.3, 1.0]),
)
def test_property_round_trip_bitwise(ids, k, cached_frac):
    store = _store(cached_frac=cached_frac)
    ss = _sharded(store, k)
    ids = np.asarray(ids, np.int64)
    part = ss.partition(ids)
    assert np.array_equal(np.sort(part.order), np.arange(ids.size))
    assert sum(part.seg_len) == ids.size
    for s, buf in enumerate(part.seg_ids):
        lo, hi = ss.plan.bounds(s)
        if buf is None:
            assert part.seg_len[s] == 0
            continue
        assert len(buf) == pow2_bucket(part.seg_len[s])
        assert (buf >= 0).all() and (buf < hi - lo).all()
    feats, hit = ss.gather(part)
    want_f, want_h = store.gather(torch.from_numpy(ids))
    assert torch.equal(feats, want_f) and torch.equal(hit, want_h)


@settings(max_examples=25, deadline=None)
@given(
    ids=st.lists(st.integers(min_value=0, max_value=N - 1), min_size=1, max_size=60),
    k=st.integers(min_value=1, max_value=6),
)
def test_property_per_visit_hits_sum_across_shards(ids, k):
    store = _store()
    ss = _sharded(store, k)
    ids = np.asarray(ids, np.int64)
    uids, inverse = np.unique(ids, return_inverse=True)
    _, hit_u = ss.gather(ss.partition(uids))
    hit_u = hit_u.numpy()
    mult = np.bincount(inverse, minlength=uids.size).astype(np.int64)
    asgn = ss.plan.shard_of(uids)
    lookups, hits = np.zeros(k, np.int64), np.zeros(k, np.int64)
    np.add.at(lookups, asgn, mult)
    np.add.at(hits, asgn[hit_u], mult[hit_u])
    _, want_hit = store.gather(torch.from_numpy(ids))
    assert lookups.sum() == ids.size and hits.sum() == int(want_hit.sum())


# --------------------------------------------------------------------- mesh


def test_serving_mesh_clamps_to_the_devices_present():
    mesh = make_serving_mesh(64, device="cpu")
    assert serving_devices(mesh) == [CPU]
    assert serving_devices([CPU] * 4) == [CPU] * 4
    with pytest.raises(ValueError):
        make_serving_mesh(0, device="cpu")
