"""The sampler's per-layer wrapper (``kernels/sample_layer``) on the CPU.

On CPU tensors :func:`sample_layer` is the plain version (``ref.py``) and
launches nothing; on CUDA tensors it launches the kernel (the ``gpu``
tests hold the two to the same bits).  These tests hold the wrapper's
refusals, its CPU route, the frontier buffer that ``sample_blocks`` lays
out for it (every frontier a prefix view of the deepest one, equal to
the concatenations it replaced), the device hit total against the hit
flags, the one ``torch.rand`` call a layer, and the ``kernel_layers``
arg of the engine's ``sample`` span.
"""

import collections

import numpy as np
import pytest
import torch

from repro_torch.core.config import EngineConfig
from repro_torch.core.trace import Tracer
from repro_torch.graph.datasets import load_dataset
from repro_torch.graph.sampling import DeviceGraph, sample_blocks, sample_neighbors
from repro_torch.kernels.sample_layer import kernel as sk
from repro_torch.kernels.sample_layer.ref import sample_layer_ref, slots_from_uniforms
from repro_torch.runtime.gnn_engine import GNNInferenceEngine

torch.set_num_threads(1)

FANOUTS = (4, 3, 2)


def _graph(n: int = 60, seed: int = 0) -> DeviceGraph:
    """A CSC graph with isolated nodes (3, 17 and the trailing one, whose
    slot is E), nodes with no cached prefix and with the whole list cached,
    and the cache holding each node's first ``cached_len`` neighbours."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 9, n)
    deg[[3, 17, n - 1]] = 0
    col_ptr = np.concatenate([[0], np.cumsum(deg)])
    row = rng.integers(0, n, col_ptr[-1])
    clen = np.minimum(deg, rng.integers(0, 9, n))
    clen[[5, 9]] = 0
    clen[[6, 10]] = deg[[6, 10]]
    cache_ptr = np.concatenate([[0], np.cumsum(clen)])
    cache_row = np.concatenate([row[col_ptr[v]:col_ptr[v] + clen[v]] for v in range(n)])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))  # noqa: E731
    return DeviceGraph(col_ptr=t(col_ptr), row_index=t(row), cache_ptr=t(cache_ptr),
                       cache_row_index=t(cache_row), cached_len=t(clen))


SEEDS = torch.tensor([0, 3, 17, 59, 5, 9, 6, 10, 59, 1, 2, 3, 40, 41], dtype=torch.int32)


def _args(g, fanout=3, seeds=SEEDS, draws=None):
    if draws is None:
        draws = torch.rand((seeds.shape[0], fanout), generator=torch.Generator().manual_seed(1),
                           dtype=torch.float64)
    nbr = torch.empty(draws.numel(), dtype=torch.int32)
    return g, seeds, draws, nbr, torch.zeros((), dtype=torch.int64)


@pytest.mark.parametrize("case,match", [
    ("seeds_int64", "seeds must be a 1-D int32"),
    ("seeds_2d", "seeds must be a 1-D int32"),
    ("draws_float32", "float64 uniforms or int32 slots"),
    ("draws_int64", "float64 uniforms or int32 slots"),
    ("draws_rows", "draws must be"),
    ("draws_1d", "draws must be"),
    ("draws_no_fanout", "draws must be"),
    ("nbr_int64", "nbr must be int32"),
    ("nbr_short", "nbr must be int32"),
    ("nbr_strided", "nbr must be contiguous"),
    ("count_int32", "hit_count must be an int64 scalar"),
    ("count_vector", "hit_count must be an int64 scalar"),
    ("graph_int64", "graph.col_ptr must be a contiguous 1-D int32"),
    ("graph_strided", "graph.row_index must be a contiguous 1-D int32"),
    ("graph_on_meta", "graph.cached_len on meta"),
    ("draws_on_meta", "draws on meta"),
    ("nbr_on_meta", "nbr on meta"),
    ("count_on_meta", "hit_count on meta"),
    ("all_on_meta", "unsupported device meta"),
])
def test_wrapper_refuses_what_it_cannot_take(case, match):
    g, seeds, draws, nbr, count = _args(_graph())
    meta = lambda t: torch.empty_like(t, device="meta")  # noqa: E731
    if case == "seeds_int64":
        seeds = seeds.long()
    elif case == "seeds_2d":
        seeds = seeds[:, None]
    elif case == "draws_float32":
        draws = draws.float()
    elif case == "draws_int64":
        draws = (draws * 2).long()
    elif case == "draws_rows":
        draws = draws[1:]
    elif case == "draws_1d":
        draws = draws.reshape(-1)
    elif case == "draws_no_fanout":
        draws = draws[:, :0]
    elif case == "nbr_int64":
        nbr = nbr.long()
    elif case == "nbr_short":
        nbr = nbr[1:]
    elif case == "nbr_strided":
        nbr = torch.empty(2 * nbr.numel(), dtype=torch.int32)[::2]
    elif case == "count_int32":
        count = count.int()
    elif case == "count_vector":
        count = count[None]
    elif case == "graph_int64":
        g = DeviceGraph(g.col_ptr.long(), g.row_index, g.cache_ptr, g.cache_row_index,
                        g.cached_len)
    elif case == "graph_strided":
        g = DeviceGraph(g.col_ptr, g.row_index.repeat_interleave(2)[::2], g.cache_ptr,
                        g.cache_row_index, g.cached_len)
    elif case == "graph_on_meta":
        g = DeviceGraph(g.col_ptr, g.row_index, g.cache_ptr, g.cache_row_index,
                        meta(g.cached_len))
    elif case == "draws_on_meta":
        draws = meta(draws)
    elif case == "nbr_on_meta":
        nbr = meta(nbr)
    elif case == "count_on_meta":
        count = meta(count)
    elif case == "all_on_meta":
        g = DeviceGraph(*(meta(t) for t in (g.col_ptr, g.row_index, g.cache_ptr,
                                              g.cache_row_index, g.cached_len)))
        seeds, draws, nbr, count = meta(seeds), meta(draws), meta(nbr), meta(count)
    with pytest.raises(ValueError, match=match):
        sk.sample_layer(g, seeds, draws, nbr, count)


def _old_sample_neighbors(g, seeds, r):
    """The eager sampler as it stood before the kernel, for given slots."""
    s64 = seeds.to(torch.int64)
    start = g.col_ptr[s64]
    deg = g.col_ptr[s64 + 1] - start
    edge_slots = start[:, None] + r
    num_edges = g.row_index.shape[0]
    host_nbr = g.row_index[edge_slots.to(torch.int64).clamp_(0, max(num_edges - 1, 0))]
    clen = g.cached_len[s64]
    hit = r < clen[:, None]
    cache_idx = g.cache_ptr[s64][:, None] + torch.minimum(r, (clen - 1).clamp_min(0)[:, None])
    cache_idx = cache_idx.to(torch.int64).clamp_max_(g.cache_row_index.shape[0] - 1)
    nbr = torch.where(hit, g.cache_row_index[cache_idx], host_nbr)
    isolated = (deg == 0)[:, None]
    return torch.where(isolated, seeds[:, None], nbr), hit | isolated, edge_slots


@pytest.mark.parametrize("mode", ["uniforms", "slots"])
@pytest.mark.parametrize("fanout", [1, 3, 8])
def test_cpu_route_is_the_plain_path(mode, fanout):
    g = _graph()
    seeds = SEEDS
    deg = g.col_ptr[seeds.long() + 1] - g.col_ptr[seeds.long()]
    u = torch.rand((seeds.shape[0], fanout), generator=torch.Generator().manual_seed(fanout),
                   dtype=torch.float64)
    r = slots_from_uniforms(deg, u)
    draws = u if mode == "uniforms" else r
    before = sk.sample_layer.launches
    _, _, _, nbr, count = _args(g, fanout, draws=draws)
    hit, slots = sk.sample_layer(g, seeds, draws, nbr, count)
    _, _, _, ref_nbr, ref_count = _args(g, fanout, draws=draws)
    ref_hit, ref_slots = sample_layer_ref(g, seeds, draws, ref_nbr, ref_count)
    assert sk.sample_layer.launches == before  # the CPU launches nothing
    old_nbr, old_hit, old_slots = _old_sample_neighbors(g, seeds, r)
    for got, ref, old in ((nbr.view(-1, fanout), ref_nbr.view(-1, fanout), old_nbr),
                          (hit, ref_hit, old_hit), (slots, ref_slots, old_slots)):
        assert torch.equal(got, ref) and torch.equal(got, old)
    assert int(count) == int(ref_count) == int(hit.sum())
    # The rules of the watch list: isolated seeds loop to themselves as hits,
    # the trailing one's slot is E, and r stays below max(deg, 1).
    isolated = deg == 0
    assert torch.equal(nbr.view(-1, fanout)[isolated], seeds[isolated, None].expand(-1, fanout))
    assert hit[isolated].all()
    assert (slots[seeds == 59] == g.row_index.shape[0]).all()
    assert ((r >= 0) & (r < deg.clamp_min(1)[:, None])).all()


def test_slots_from_uniforms_at_the_edges():
    deg = torch.tensor([0, 1, 7, 1 << 30], dtype=torch.int32)
    below_one = float(np.nextafter(1.0, 0.0))
    u = torch.tensor([[0.0, below_one]] * 4, dtype=torch.float64)
    r = slots_from_uniforms(deg, u)
    assert r.dtype == torch.int32
    assert r.tolist() == [[0, 0], [0, 0], [0, 6], [0, (1 << 30) - 1]]


@pytest.mark.parametrize("mode", ["generator", "draws", "full_neighborhood"])
def test_frontiers_are_prefixes_of_one_buffer_equal_to_the_concatenations(mode):
    g = _graph(seed=2)
    seeds = torch.tensor([0, 3, 59, 6, 9, 30], dtype=torch.int32)
    rev = tuple(reversed(FANOUTS))
    sizes = [seeds.shape[0]]
    for f in rev:
        sizes.append(sizes[-1] * (1 + f))
    # The draws mode replays the generator's slots, recovered from its block.
    drawn = sample_blocks(g, seeds, FANOUTS, generator=torch.Generator().manual_seed(9))
    draws = [slots - g.col_ptr[drawn.frontiers[i].long()][:, None]
             for i, slots in enumerate(drawn.edge_slots)]
    kw = {"generator": dict(generator=torch.Generator().manual_seed(9)),
          "draws": dict(draws=draws), "full_neighborhood": dict(full_neighborhood=True)}[mode]
    block = sample_blocks(g, seeds, FANOUTS, **kw)
    if mode != "full_neighborhood":
        assert torch.equal(block.input_nodes, drawn.input_nodes)
    buf = block.input_nodes
    assert [f.shape[0] for f in block.frontiers] == sizes
    # Replay layer by layer through sample_neighbors (a buffer of its own per
    # layer) and the concatenation sample_blocks no longer makes.
    replay = {"generator": dict(generator=torch.Generator().manual_seed(9)),
              "draws": {}, "full_neighborhood": dict(full_neighborhood=True)}[mode]
    frontier = seeds
    for i, f in enumerate(rev):
        layer_kw = dict(replay, r=draws[i]) if mode == "draws" else replay
        nbr, hit, slots = sample_neighbors(g, frontier, f, **layer_kw)
        assert block.frontiers[i].data_ptr() == buf.data_ptr()
        assert block.frontiers[i].is_contiguous()
        assert torch.equal(block.neighbor_hits[i], hit)
        assert torch.equal(block.edge_slots[i], slots)
        frontier = torch.cat([frontier, nbr.reshape(-1)])
        assert torch.equal(block.frontiers[i + 1], frontier)
    assert torch.equal(block.frontiers[0], seeds)


@pytest.mark.parametrize("dedup", [False, True])
def test_hit_count_is_the_sum_of_the_hit_flags(dedup):
    g = _graph(seed=3)
    seeds = torch.arange(60, dtype=torch.int32)
    block = sample_blocks(g, seeds, FANOUTS, generator=torch.Generator().manual_seed(5),
                          dedup=dedup)
    hits, lookups = block.adj_hit_stats()
    assert hits.dtype == torch.int64 and hits.shape == ()
    assert int(hits) == sum(int(h.sum()) for h in block.neighbor_hits) > 0
    assert lookups == sum(h.numel() for h in block.neighbor_hits) == 60 * (2 + 3 * 3 + 12 * 4)
    assert int(hits) < lookups
    if dedup:  # dedup reads the same buffer: the frontier's ids, sorted
        assert torch.equal(block.dedup.unique_ids[: int(block.dedup.num_unique)],
                           torch.unique(block.input_nodes))


def test_one_rand_call_a_layer_on_the_generator():
    """The generator ends where one float64 ``torch.rand`` of each layer's
    shape leaves it, and the slots come from those uniforms."""
    g = _graph(seed=4)
    seeds = torch.arange(0, 60, 3, dtype=torch.int32)
    gen = torch.Generator().manual_seed(11)
    block = sample_blocks(g, seeds, FANOUTS, generator=gen)
    mirror = torch.Generator().manual_seed(11)
    for i, f in enumerate(reversed(FANOUTS)):
        frontier = block.frontiers[i]
        u = torch.rand((frontier.shape[0], f), generator=mirror, dtype=torch.float64)
        start = g.col_ptr[frontier.long()]
        deg = g.col_ptr[frontier.long() + 1] - start
        assert torch.equal(block.edge_slots[i], start[:, None] + slots_from_uniforms(deg, u))
    assert torch.equal(gen.get_state(), mirror.get_state())


def test_engine_sample_spans_count_the_kernel_layers():
    """The engine's ``sample`` span carries ``kernel_layers``: the layers
    its batch sampled through the kernel, 0 on the CPU; no other span
    carries it, and the batch index the stages share stays as it was."""
    ds = load_dataset("ogbn-products", scale=0.002, seed=0)
    eng = GNNInferenceEngine(ds, fanouts=(3, 2), batch_size=64, seed=3, device="cpu")
    eng.prepare("dci", total_cache_bytes=100_000, n_presample=2)
    tracer = Tracer()
    eng.run(config=EngineConfig(pipeline_depth=2, use_kernel=True, dedup=True), max_batches=3,
            tracer=tracer)
    spans = [e for e in tracer.events if e["ph"] == "X"]
    by_name = collections.defaultdict(list)
    for e in spans:
        by_name[e["name"]].append(e.get("args", {}))
    assert len(by_name["sample"]) == 3
    assert [a["kernel_layers"] for a in by_name["sample"]] == [0, 0, 0]
    assert sorted(a["batch"] for a in by_name["sample"]) == [0, 1, 2]
    for name, args in by_name.items():
        if name != "sample":
            assert not any("kernel_layers" in a for a in args), name
    assert sorted(a["batch"] for a in by_name["feature"]) == [0, 1, 2]


def test_annotate_writes_the_innermost_open_span_only():
    tr = Tracer()
    shared = {"batch": 7}
    with tr.span("outer", lane="slot 0", args=shared):
        with tr.span("inner", args=shared):
            tr.annotate(kernel_layers=3)
        tr.annotate(note="outer")
    tr.annotate(ignored=True)  # no span open: nothing to write
    args = {e["name"]: e.get("args") for e in tr.events if e["ph"] == "X"}
    assert args == {"inner": {"batch": 7, "kernel_layers": 3},
                    "outer": {"batch": 7, "note": "outer"}}
    assert shared == {"batch": 7}
