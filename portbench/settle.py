"""How a configuration's fixed capacities were found: run the cell's
batch from the program's own default plan (the capacities the program
plans from the density, the slab path's default cadence of 20 steps) in
the cell's chunks with the overflow retry, and print every re-plan and
the plan it settles on.

    python portbench/settle.py --workload <name> --seed <n> --steps 2000
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_REBUILD_EVERY = 20
PLANNED = ("cap", "nb_cap", "ns_cap", "window")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness import program, scene as scene_mod
    from portbench.harness.cells import Cell

    cell = Cell(args.workload)
    cfg = json.loads(json.dumps(cell.config))
    for k in PLANNED:
        cfg["path"].pop(k, None)
    if "rebuild_every" in cfg["path"]:
        cfg["path"]["rebuild_every"] = DEFAULT_REBUILD_EVERY
    B = int(cell.traffic["replicas"])
    chunk = int(cell.traffic["chunk_steps"])
    scene = scene_mod.make_scene(cfg, args.seed)
    vel = scene_mod.thermal_velocities(cfg, scene, B, args.seed, "cuda")
    prog = program.Program(cfg, scene, vel, B, args.seed,
                           torch.device("cuda"))
    print(f"start: {prog.plan_text()}", flush=True)
    t0 = time.perf_counter()
    done = 0
    while done < args.steps:
        before = prog.replans
        prog.run_chunk(chunk)
        done += chunk
        if prog.replans != before:
            print(f"step {done}: {prog.replans - before} re-plan(s) -> "
                  f"{prog.plan_text()}", flush=True)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "steps": done, "replans": prog.replans,
                      "plan": prog.plan_text(),
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
