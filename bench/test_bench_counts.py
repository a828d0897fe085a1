"""The roofline's bytes (bench/roofline.py) and the model's FLOPs
(bench/flops.py) come from shapes and counts alone, on the CPU."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import check, drive
from bench.data import make_graph
from bench.flops import FP32_PEAK, full_graph_flops, layer_dims, sampled_flops
from bench.harness import cell_spec
from bench.roofline import HBM_BYTES_PER_S, PCIE_BYTES_PER_S, gather_bytes, least_seconds
from repro_torch.models.gnn.models import forward

# The two configurations' models, by the names their files have.
SAGE = cell_spec("sage-products.offline4096")[2]["model"]
GCN = cell_spec("gcn-reddit.offline4096")[2]["model"]


def test_gather_bytes_by_hand():
    # 3 hit rows and 2 miss rows of 400 bytes: 3 rows read and 5 written
    # over HBM with 8 bytes of id and slot each, 2 rows over PCIe.
    assert gather_bytes([(3, 2, 400)]) == (3 * 400 + 5 * 400 + 5 * 8, 2 * 400)
    assert gather_bytes([(3, 2, 400), (1, 0, 512)]) == (3240 + 512 + 512 + 8, 800)
    hbm, pcie = 3240, 800
    assert least_seconds(hbm, pcie) == max(hbm / HBM_BYTES_PER_S, pcie / PCIE_BYTES_PER_S)
    assert least_seconds(10**12, 0) == pytest.approx(10**12 / 3.35e12)


def test_flops_by_hand():
    # One GraphSAGE layer, 2 seeds, fan-out 2, 3 -> 4: 2 * 1 * 3 neighbour
    # adds, two products of 2 * 2 * 3 * 4, two adds per output.
    assert sampled_flops(SAGE, 2, (2,), [3, 4]) == 6 + 96 + 16
    # GCN: 2 * 2 * 3 adds (self and two neighbours), 2 * 3 divides, one
    # product, the bias.
    assert sampled_flops(GCN, 2, (2,), [3, 4]) == 12 + 6 + 48 + 8
    assert full_graph_flops(GCN, 5, 9, [3, 4]) == 27 + 15 + 120 + 20
    assert FP32_PEAK == 67e12


@pytest.mark.parametrize("model", [SAGE, GCN])
def test_products_match_a_flop_counter(model):
    """The linear maps' share of the count equals what torch's counter
    sees in the port's forward over the same block."""
    fanouts, dims, batch = (3, 2), [5, 6, 4], 3
    gen = torch.Generator().manual_seed(0)
    params = [{"w_self": torch.randn(dims[i], dims[i + 1], generator=gen),
               "w_nbr": torch.randn(dims[i], dims[i + 1], generator=gen),
               "b": torch.zeros(dims[i + 1])} for i in range(2)]
    rows = batch * (1 + 2) * (1 + 3)
    feats = torch.randn(rows, dims[0], generator=gen)
    with FlopCounterMode(display=False) as counter:
        forward(params, feats, model=model, fanouts=fanouts)
    sizes = [batch, batch * 3]
    per_map = 2 * (sizes[1] * dims[0] * dims[1] + sizes[0] * dims[1] * dims[2])
    assert counter.get_total_flops() == per_map * (2 if model == SAGE else 1)
    assert sampled_flops(model, batch, fanouts, dims) > counter.get_total_flops()


class FourBatches(drive.WindowBatches):
    """The window's first four batches, whatever the clock says: a loaded host
    must not give one route fewer batches to compare than another."""

    def __iter__(self):
        while self.count < 4:
            yield self.batches[self.count % len(self.batches)]
            self.count += 1


def test_counts_do_not_depend_on_the_gather_route(monkeypatch):
    """The roofline's rows come from the reference's replay of the
    window's batches, so every route of the program is held to the same
    count; the program's own hit counts agree on each route."""
    monkeypatch.setattr(drive, "WindowBatches", FourBatches)
    cell = "sage-products.offline4096"
    _, _, config, mix = cell_spec(cell)
    config = {**config, "cache_mb": 0.1, "n_presample": 2}
    mix = {**mix, "batch_size": 64}
    data = make_graph(config["dataset"], 11, device="cpu", scale=0.002)
    params = drive.make_params(config, 11, torch.device("cpu"))
    seen = []
    for use_kernel, dedup in ((True, True), (False, False), (True, False)):
        cfg = {**config, "use_kernel": use_kernel, "dedup": dedup}
        out = drive.run_offline(cfg, mix, data, params, 11, 0.2, torch.device("cpu"), False, {}, {})
        assert len(out.batches) == len(out.outputs) == 4
        out.allocation = dict(seen[0][1]) if seen else out.allocation
        numbers, counts = check.compare(cfg, mix, data, params, out, 11, device=torch.device("cpu"))
        seen.append((counts["gather_groups"], out.allocation))
        assert numbers["logit_gap"][0] < numbers["logit_gap"][1]
    assert all(groups == seen[0][0] for groups, _ in seen)
    assert layer_dims(config) == [100, 128, 128, 47]
