#!/usr/bin/env python3
"""Replica batches of cavmd_tpu_torch on one GPU: the batched step and the
batched kernels K1-K5 at N = 501, per batch size.

Run from the root of a checkout on a machine with a CUDA device:
``python3 scripts/bench_torch_replicas.py [--batches 1,2,4,8,16,32,64]
[--kernel-batches 8,32] [--warm 500] [--chunk 500] [--chunks 5]``.

The scene is ``chip_smoke.py``'s N = 501 reference scene (250 O2/N2 +
photon in a 46-bohr box, f32, dense ForceField, Bussi + Langevin, dt
0.25 fs), B replicas thermalized at seeds 7 + r
(``init_replica_states``). For each batch size one JSON line: the batched
step through ``run_replica_steps`` (one warm-up chunk, then ``--chunks``
chunks of ``--chunk`` steps, each ended by ``torch.cuda.synchronize()``):
wall ms a step (median chunk), steps/s and aggregate steps/s (B times
it), each batched kernel's launches a step, and from ``torch.profiler``
over 50 steps the device operations a step, the device us a step (the
union of their intervals) and the busy share (that over the wall time);
each replica's universe drift is held to ``chip_smoke.py``'s phase-3
bound. ``"replicas": null`` is the one-replica step (``run_steps`` on an
unbatched state), profiled only. Then for each kernel one line: the
device ms of one unbatched call (replica 0's rows) and of the batched
call at each of ``--kernel-batches``, with its bound (``chip_smoke.py``'s
``device_ms`` and ``replica_work_counts``). The last line names the card
and its power limit as nvidia-smi reports them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="1,2,4,8,16,32,64")
    ap.add_argument("--kernel-batches", default="8,32")
    ap.add_argument("--warm", type=int, default=500)
    ap.add_argument("--chunk", type=int, default=500)
    ap.add_argument("--chunks", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_torch_replicas.py needs a CUDA device")
    import cavmd_tpu_torch as pt

    cs.N_WARM, cs.CHUNK, cs.N_CHUNKS = args.warm, args.chunk, args.chunks
    one = cs.replica_step_path(torch, pt, None)
    print(json.dumps(dict(one, what="step")), flush=True)
    for B in (int(b) for b in args.batches.split(",")):
        res = cs.replica_step_path(torch, pt, B)
        print(json.dumps(dict(res, what="step")), flush=True)
        torch.cuda.empty_cache()

    calls = cs.replica_calls()
    rows = {k: dict(what="kernel", kernel=k) for k in calls}
    for B in (int(b) for b in args.kernel_batches.split(",")):
        snap, ff, inputs = cs.replica_inputs(torch, pt, B, torch.float32)
        counts = cs.replica_work_counts(torch, snap, ff, inputs, B)
        for key, bargs in inputs.items():
            kern = calls[key][0]
            row = rows[key]
            if "unbatched_ms" not in row:
                single = cs.replica_row(bargs, 0, key)
                row["unbatched_ms"] = cs.device_ms(torch,
                                                   lambda: kern(*single))
            row[f"b{B}_ms"] = cs.device_ms(torch, lambda: kern(*bargs))
            row[f"b{B}_bound_ms"], row[f"b{B}_bound_by"] = cs.bound_ms(
                *counts[key])
    for row in rows.values():
        print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
