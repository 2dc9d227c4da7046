#!/usr/bin/env python3
"""The JAX package's reading on ``chip_smoke.py`` phase 11's batched CLI
protocol, on the CPU: each replica's universe-energy drift.

Run from the repository root: ``python scripts/jax_vmap_cli_reference.py
[--precision f32|f64]`` (f32 by default). It runs the JAX ``advanced_run``
CLI in a temporary directory on phase 5's arguments (250 molecules,
``--runtime 0.06``, energy tracker and F(k,t), seed 0) with
``--vmap-replicas --replicas 1-8 --device CPU --precision P``, and prints
one JSON line: the CLI's exit code or the error it raised, for each
replica max |U - U[0]| of the ``universe_total_energy`` column (index 18)
of its energy tracker over its sound rows, and the number of rows that are
not (not finite, or |U| of 1e3 Ha or more: a replica that blew up), and
the wall seconds.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("CAVMD_JIT_CACHE", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from cavmd_tpu.drivers import advanced_run  # noqa: E402

ARGS = ["--device", "CPU", "--n-molecules", "250",
        "--enable-energy-tracker", "--enable-fkt", "--seed", "0",
        "--runtime", "0.06", "--vmap-replicas", "--replicas", "1-8"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--precision", choices=("f32", "f64"), default="f32")
    args = ap.parse_args()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="jax_vmap_cli_") as work:
        os.chdir(work)
        t0 = time.perf_counter()
        try:
            rc = advanced_run.main(ARGS + ["--precision", args.precision])
        except ValueError as e:  # the CLI's own error, reported as read
            rc = f"ValueError: {e}"
        finally:
            os.chdir(cwd)
        seconds = time.perf_counter() - t0
        drifts, blown = {}, {}
        for path in sorted(glob.glob(os.path.join(
                work, "**", "prod-*_energy_tracker.txt"), recursive=True)):
            rows = np.loadtxt(path, comments=("#", "time"), ndmin=2)[:, 18]
            replica = os.path.basename(path).split("_")[0]
            ok = np.isfinite(rows) & (np.abs(rows) < 1e3)
            blown[replica] = int((~ok).sum())
            drifts[replica] = (float(np.abs(rows[ok] - rows[0]).max())
                               if ok[0] else None)
    print(json.dumps(dict(precision=args.precision, rc=rc, seconds=seconds,
                          universe_drift_ha=drifts, rows_blown_up=blown)),
          flush=True)


if __name__ == "__main__":
    main()
