"""Find the highest rate a served cell sustains: one set-up, then the cell's
request-serving window at each of a list of aggregate rates.

    python -m bench.sweep --workload <cell> --seed <n> --seconds <s> --rates 100,200,400

Prints one JSON line per rate: requests, p50 and p95 in ms, the mean
latency of the last quarter of arrivals over that of the first quarter
(above about 2 the backlog grows through the window), and how long after
the last arrival the last request retired.  A mix's ``rate_per_s`` is
then set by hand at about four fifths of the highest rate whose backlog
stays flat.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from bench.run import _environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    _environment()

    import numpy as np
    import torch

    from bench import drive
    from bench.data import make_graph, sub_seed
    from bench.generator import poisson_requests
    from bench.harness import cell_spec

    _, _, config, mix = cell_spec(args.workload)
    dev = torch.device("cuda", torch.cuda.current_device())
    data = make_graph(config["dataset"], args.seed, device=dev)
    params = drive.make_params(config, args.seed, dev)
    engine = drive._prepared(config, mix, data, params, args.seed, dev, {})
    streams = mix["streams"]
    stream_seeds = [sub_seed(args.seed, 10 + s) for s in range(streams)]
    warm = poisson_requests(data.test_idx, streams=streams, rate_per_s=1e6,
                            seconds=2 * streams / 1e6, batch_size=mix["batch_size"], seed=1)
    engine.warmup(warm[0][0][1])
    drive._serve(engine, config, mix, warm, stream_seeds, collect=False)
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = poisson_requests(data.test_idx, streams=streams, rate_per_s=rate,
                                   seconds=args.seconds, batch_size=mix["batch_size"],
                                   seed=args.seed)
        t0 = time.perf_counter()
        states, report = drive._serve(engine, config, mix, traffic, stream_seeds, collect=True)
        reqs = sorted((r.arrival_s, r.retired_s - r.arrival_s) for st in states for r in st.completed)
        lat = np.array([x[1] for x in reqs])
        q = max(len(lat) // 4, 1)
        print(json.dumps({
            "rate_per_s": rate,
            "requests": len(lat),
            "p50_ms": 1e3 * float(np.percentile(lat, 50)),
            "p95_ms": 1e3 * float(np.percentile(lat, 95)),
            "growth": float(lat[-q:].mean() / lat[:q].mean()),
            "tail_after_last_arrival_s": report.wall_seconds - reqs[-1][0],
            "wall_s": time.perf_counter() - t0,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
