"""Command-line entry point: the port's single-stream GNN inference.

    PYTHONPATH=src python -m repro_torch.launch.infer_gnn \
        --dataset ogbn-products --policy dci --fanouts 15,10,5 \
        --batch-size 1024 --cache-mb 2 --use-kernel --prefetch

``--policy`` takes dci, sci, aci, dgl, ducati and rain; ``--mode
layerwise`` scores every node layer by layer in ``--chunk-size`` node
ranges instead of sampling mini-batches.  Runs on the CUDA card unless
``--device cpu`` is given; with no card and no ``--device cpu`` it fails.
Prints the InferenceReport (or, layer-wise, the LayerwiseReport) as JSON.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.core.config import INFERENCE_MODES, EngineConfig
from repro_torch.core.policies import POLICIES
from repro_torch.graph.datasets import load_dataset
from repro_torch.runtime.gnn_engine import GNNInferenceEngine


def _depth(value: str):
    """--pipeline-depth accepts an int or 'auto' (measured compute:prep)."""
    return "auto" if value == "auto" else int(value)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="ogbn-products")
    ap.add_argument("--policy", default="dci", choices=sorted(POLICIES))
    ap.add_argument("--model", default="graphsage", choices=("graphsage", "gcn"))
    ap.add_argument("--fanouts", default="15,10,5")
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--cache-mb", type=float, default=2.0)
    ap.add_argument("--scale", type=float, default=0.004)
    ap.add_argument("--presample", type=int, default=8)
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument(
        "--mode",
        default="sampling",
        choices=INFERENCE_MODES,
        help="'sampling' (default) = mini-batch neighborhood-sampled inference over "
        "the test seeds; 'layerwise' = full-graph layer-wise scoring — every layer over "
        "ALL nodes in node-range chunks, the feature cache serving layer-0 rows and an "
        "embedding cache serving intermediate layer outputs",
    )
    ap.add_argument(
        "--chunk-size",
        type=int,
        default=None,
        help="node-range chunk for --mode layerwise (default 4096, clamped to the graph)",
    )
    ap.add_argument(
        "--pipeline-depth",
        type=_depth,
        default=1,
        help="batches kept in flight: 1 = serial (per-stage sync, the paper's "
        "timing), 2+ = overlap batch i+1's sample/gather with batch i's compute, "
        "'auto' = derive the window from a measured compute:prep probe",
    )
    ap.add_argument(
        "--use-kernel",
        action="store_true",
        help="route feature gathers through the CUDA cached_gather kernels",
    )
    ap.add_argument(
        "--gather-buffers",
        type=int,
        default=2,
        help="validated for parity with the reference; no effect on the card",
    )
    ap.add_argument(
        "--dedup",
        action="store_true",
        help="sort-and-unique each input frontier on the device and gather/model "
        "one row per DISTINCT node; outputs and hit accounting are identical",
    )
    ap.add_argument(
        "--prefetch",
        action="store_true",
        help="stage each batch's MISSED host feature rows onto the device (pinned "
        "pack, side-stream copy) before its gather; outputs and hit accounting are "
        "identical, only where the miss bytes move changes",
    )
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    fanouts = tuple(int(x) for x in args.fanouts.split(","))
    cfg = EngineConfig(
        mode=args.mode,
        chunk_size=args.chunk_size,
        pipeline_depth=args.pipeline_depth,
        prefetch=args.prefetch,
        use_kernel=args.use_kernel,
        gather_buffers=args.gather_buffers,
        dedup=args.dedup,
    )
    ds = load_dataset(args.dataset, scale=args.scale, max_nodes=200_000)
    eng = GNNInferenceEngine(
        ds,
        model=args.model,
        fanouts=fanouts,
        batch_size=args.batch_size,
        pipeline_depth=args.pipeline_depth,
        device=args.device,
    )
    eng.prepare(
        args.policy,
        config=cfg,
        total_cache_bytes=int(args.cache_mb * 1e6),
        n_presample=args.presample,
    )
    rep = eng.run(config=cfg, max_batches=args.max_batches)
    print(json.dumps(rep.summary(), indent=1))


if __name__ == "__main__":
    main()
