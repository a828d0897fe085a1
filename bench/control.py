"""The precision control of a cell, on the chip: for each seed, one run of
the cell (a short window) whose check is made twice, once of the program
and once of the reference put in the program's place in float32 with TF32
on (the next precision below the configuration's float32).  Prints one
JSON line per seed with both sets of compared numbers.

    python -m bench.control --workload <cell> --seeds 11,12,13 --seconds 3

The benchmark's own runs never run this; ``limits.json`` is set from its
readings and from the sound runs'.
"""

from __future__ import annotations

import argparse
import json
import sys

from bench.run import _environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    _environment()
    from bench.harness import run_cell

    for seed in (int(s) for s in args.seeds.split(",")):
        result = run_cell(args.workload, seed, args.seconds, False, control=True)
        print(json.dumps({
            "seed": seed,
            "program": {k: v["value"] for k, v in result["checks"].items()},
            "control": {k: v["value"] for k, v in result["control"].items()},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
