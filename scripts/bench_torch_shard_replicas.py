#!/usr/bin/env python3
"""Replicas over ranks on one GPU: the batched CLI in one process against
``--shard-replicas R`` on R processes that share the card.

Run from the root of a checkout on a machine with a CUDA device:
``python3 scripts/bench_torch_shard_replicas.py [--batches 8,16]
[--ranks 2] [--runtime 0.08]``.

The command is ``chip_smoke.py`` phase 11d's (``CLI_ARGS``: the N = 501
scene, f32, adaptive dt, the energy tracker and F(k,t); ``--vmap-replicas
--replicas 1-B``). For each batch size B it runs, in this order, the
batch in this process, the batch split over ``--ranks`` ranks
(``parallel.launch.run_ranks``: gloo ranks with file rendezvous, each on
card ``rank % device_count``), the split batch again and the one-process
batch again, each in a fresh directory. One JSON line a run: the
replicas, the ranks, the steps and seconds of the CLI's run phase and
its aggregate steps/s (the CLI's own ``vmapped ...`` line). Then a line a
batch size with the two medians and their ratio, and the card's name and
power limit as nvidia-smi reports them.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="8,16")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--runtime", type=float, default=0.08)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_torch_shard_replicas.py needs a CUDA device")
    from cavmd_tpu_torch.parallel.launch import run_ranks

    R = args.ranks
    cwd = os.getcwd()
    for B in (int(b) for b in args.batches.split(",")):
        argv = cs.CLI_ARGS + ["--runtime", str(args.runtime),
                              "--vmap-replicas", "--replicas", f"1-{B}"]
        rates = {1: [], R: []}
        for ranks in (1, R, R, 1):
            work = tempfile.mkdtemp(prefix="cavmd_shard_bench_")
            try:
                if ranks == 1:
                    res = [cs.rank_cli_job(argv, work)]
                else:
                    res = run_ranks([(cs.rank_cli_job, (
                        argv + ["--shard-replicas", str(ranks)], work))],
                        ranks, timeout=900)[0]
            finally:
                os.chdir(cwd)
                shutil.rmtree(work, ignore_errors=True)
            for k, r in enumerate(res):
                cs.check(r["rc"] == 0, f"rank {k} of {ranks} exited "
                         f"{r['rc']}: {r['out'][-2000:]}")
            n_rep, steps, wall, agg = cs.vmapped_line(
                f"B={B} on {ranks} rank(s)", res[0]["out"])
            rates[ranks].append(agg)
            print(json.dumps(dict(replicas=n_rep, ranks=ranks, steps=steps,
                                  run_seconds=wall,
                                  aggregate_steps_per_s=agg)), flush=True)
        one, split = (statistics.median(rates[k]) for k in (1, R))
        print(json.dumps(dict(replicas=B, ranks=R, one_rank_median=one,
                              split_median=split, ratio=split / one)),
              flush=True)
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
