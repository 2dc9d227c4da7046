"""The readings that the limits of ``checks/<workload>.json`` are set
from, in one process: for each seed a run of the cell (set-up, a short
window, the check) with the compared numbers printed unjudged, and for
the control seeds also the numbers of the control, the reference in
bfloat16 put in the program's place on the same stretch.

    python portbench/readings.py --workload <name> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 5
"""

import time

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.harness.cells import Cell
    from portbench.harness.check import NUMBERS
    from portbench.run import run_cell

    cell = Cell(args.workload)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    unjudged = {k: math.inf for k in NUMBERS}
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(cell, seed, args.seconds, False, "cuda",
                     time.perf_counter(), unjudged,
                     control=seed in control)
        line = {"seed": seed,
                "program": {k: v["value"] for k, v in r["checks"].items()},
                "ns_per_day": r["metrics"]["ns_per_day"]["value"]}
        if "control" in r:
            line["control"] = r["control"]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
