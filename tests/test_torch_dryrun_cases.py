"""The port's dry-runs, in-process on the CPU with no card and no XLA
flags: the reference's five dry-run cases (tests/test_dryrun_subprocess.py)
and the pod-scale GNN dry-run, their records and printed lines; the
per-device parameter bytes on 16 x 16; and the psums ``tp_shardmap``
records on a smoke config against a hand count.
"""

import math

import pytest

from repro_torch.analysis.counts import count_step
from repro_torch.configs import ARCH_IDS, InputShape, get_config, get_smoke
from repro_torch.launch import dryrun, dryrun_gnn
from repro_torch.launch.mesh import HW, AbstractMesh, make_production_mesh
from repro_torch.launch.specs import abstract_prefill_inputs
from repro_torch.models.lm import model as TM
from repro_torch.models.lm import moe as TMoE
from repro_torch.models.lm import tp as TTP
from repro_torch.models.lm.sharding import param_specs
from repro_torch.utils.tree import tree_leaves_with_path

CASES = [
    ("gemma-2b", "decode_32k", "baseline"),
    ("qwen2-vl-2b", "train_4k", "baseline"),
    ("phi3.5-moe-42b-a6.6b", "prefill_32k", "moe_shardmap"),
    ("deepseek-v2-236b", "decode_32k", "mla_absorb"),
    ("rwkv6-3b", "long_500k", "baseline"),
]
# The reference's record keys (src/repro/launch/dryrun.py dryrun_one).
KEYS = {"arch", "shape", "variant", "mesh", "devices", "lower_s", "compile_s", "cost_analysis",
        "memory_analysis", "hlo"}
HLO_KEYS = {"flops_per_device", "dot_bytes_per_device", "collective_bytes_per_device",
            "collective_counts", "parameter_bytes_per_device", "num_whiles",
            "unresolved_trip_counts"}


@pytest.mark.parametrize("arch,shape,variant", CASES)
def test_dryrun_case_runs_and_keeps_the_reference_record(arch, shape, variant, capsys, tmp_path):
    (rec,) = dryrun.main(["--arch", arch, "--shape", shape, "--variant", variant,
                          "--out", str(tmp_path)])
    assert "1 combos compiled, 1 with analyses" in capsys.readouterr().out
    assert KEYS <= rec.keys() and rec["hlo"].keys() == HLO_KEYS
    assert set(rec["memory_analysis"]) == {"argument_size_in_bytes", "output_size_in_bytes"}
    assert set(rec["cost_analysis"]) == {"flops", "bytes accessed"}
    assert (rec["source"], rec["mesh"], rec["devices"]) == ("torch-meta", "16x16", 256)
    assert len(list(tmp_path.glob("*.json"))) == 1
    h = rec["hlo"]
    batch = dryrun.INPUT_SHAPES[shape].global_batch
    split = 256 if batch % 16 == 0 else 16
    assert h["flops_per_device"] == rec["cost_analysis"]["flops"] / split > 0
    assert h["num_whiles"] == h["unresolved_trip_counts"] == 0
    if variant == "moe_shardmap":
        # one bf16 psum of the [T_local, d] output per MoE layer
        cfg = get_config(arch)
        t_local = batch // 16 * dryrun.INPUT_SHAPES[shape].seq_len
        assert rec["collectives"] == "recorded psums"
        assert h["collective_counts"]["all-reduce"] == cfg.n_layers
        assert h["collective_bytes_per_device"]["all-reduce"] == (
            cfg.n_layers * t_local * cfg.d_model * 2)
    else:
        assert rec["collectives"] == "not modelled" and h["collective_bytes_per_device"] == {}
    # the switches are reset
    assert TTP.remat_policy() is None and TMoE._SHARD_MAP_CTX is None and TTP._TP_CTX is None


def test_pod_scale_gnn_dryrun(capsys):
    """``cold`` and ``hot`` lines, the stated collective model, and the
    GraphSAGE FLOPs (each device runs the whole step) by hand."""
    cold, hot = dryrun_gnn.main(["--batch", "256"])
    out = capsys.readouterr().out
    assert "cold" in out and "hot" in out and "(P-1)/P" in out
    rows, flops = 256 * 6 * 11 * 16, 0
    for f, width in zip((5, 10, 15), (128, 128, 47)):
        rows //= 1 + f
        flops += 2 * 2 * rows * 128 * width
    assert cold["flops_per_dev"] == hot["flops_per_dev"] == flops == 3_227_385_856
    assert hot["collective_bytes_per_dev"] == 0
    # every col_ptr offset (two per frontier node and layer), neighbour id
    # and feature row, remote with share 255/256
    sizes = [256, 256 * 6, 256 * 6 * 11]
    entries = sum(2 * n * 8 + n * f * 4 for n, f in zip(sizes, (5, 10, 15)))
    entries += 256 * 6 * 11 * 16 * 128 * 2
    assert cold["collective_bytes_per_dev"] == entries * 255 / 256
    assert cold["collective_s"] == cold["collective_bytes_per_dev"] / HW["ici_bw_per_link"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_parameter_bytes_per_device_is_the_per_leaf_spec_sum(arch):
    """Each leaf's bytes over 16 per ``model`` entry of its spec (every such
    dim divides by 16), summed."""
    params = TM.abstract_params(get_config(arch))
    specs = param_specs(params)
    want = 0
    for (_, leaf), spec in zip(tree_leaves_with_path(params), dryrun.spec_leaves(specs)):
        shards = math.prod(16 for e in spec if e == "model")
        assert leaf.numel() % shards == 0
        want += leaf.numel() * leaf.element_size() // shards
    assert dryrun.shard_bytes(params, specs, make_production_mesh()) == want


def test_gemma_decode_record_bytes_are_exact():
    rec = dryrun.dryrun_one("gemma-2b", "decode_32k", verbose=False)
    params = TM.abstract_params(get_config("gemma-2b"))
    assert rec["hlo"]["parameter_bytes_per_device"] == dryrun.shard_bytes(
        params, param_specs(params), make_production_mesh())
    cfg = get_config("gemma-2b")
    # caches: k and v [R, B/16, S/16, Hkv, Dh] per layer, bf16; tokens B/16, cache_len 4 B
    cache = 2 * cfg.n_layers * (128 // 16) * (32768 // 16) * cfg.n_kv_heads * cfg.head_dim * 2
    assert rec["memory_analysis"]["argument_size_in_bytes"] == (
        rec["hlo"]["parameter_bytes_per_device"] + cache + 128 // 16 * 4 + 4)


def test_tp_shardmap_records_the_psums_of_a_hand_count():
    """Two bf16 psums per layer (attention's ``wo``, the FFN's ``w2``), each
    of the per-device operand [B/2 * S, d] on a (data 2, model 4) mesh."""
    cfg = get_smoke("yi-6b")
    mesh = AbstractMesh(("data", "model"), (2, 4))
    params, batch = abstract_prefill_inputs(cfg, InputShape("smoke", 16, 4, "prefill"))
    TTP.set_tp_context(mesh, "model")
    try:
        _, counts = count_step(lambda p, b: TM.prefill(p, b, cfg, cache_size=16), params, batch)
    finally:
        TTP.set_tp_context(None)
    per = 4 // 2 * 16 * cfg.d_model * 2
    assert counts.collective_counts["all-reduce"] == 2 * cfg.n_layers
    assert counts.collective_bytes["all-reduce"] == 2 * cfg.n_layers * per
