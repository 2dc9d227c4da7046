#!/usr/bin/env python3
"""The JAX package's reading on ``chip_smoke.py`` phase 5's CLI protocol,
on the CPU: the universe-energy drift of the N = 501 CLI at several seeds.

Run from the repository root: ``python scripts/jax_cli_reference.py
[--seeds 0 1 2 3 4]``. For each seed it runs the JAX ``advanced_run`` CLI
in a temporary directory on phase 5's arguments (250 molecules,
``--runtime 0.06``, energy tracker and F(k,t), ``--device CPU
--precision f32``) and prints one JSON line: the seed, the CLI's exit
code, max |U - U[0]| of the ``universe_total_energy`` column (index 18)
of its energy tracker (the printed energies are rounded to 1e-6 Ha), the
rows read and the wall seconds. Phase 5's bound is 3x the largest drift.
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

ARGS = ["--device", "CPU", "--precision", "f32", "--n-molecules", "250",
        "--enable-energy-tracker", "--enable-fkt", "--runtime", "0.06"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    args = ap.parse_args()
    cwd = os.getcwd()
    for seed in args.seeds:
        with tempfile.TemporaryDirectory(prefix="jax_cli_") as work:
            os.chdir(work)
            t0 = time.perf_counter()
            try:
                rc = advanced_run.main(ARGS + ["--seed", str(seed)])
            finally:
                os.chdir(cwd)
            seconds = time.perf_counter() - t0
            path, = glob.glob(os.path.join(
                work, "**", "prod-1_energy_tracker.txt"), recursive=True)
            rows = np.loadtxt(path, comments=("#", "time"), ndmin=2)[:, 18]
        print(json.dumps(dict(seed=seed, rc=rc, seconds=seconds,
                              rows=len(rows),
                              universe_drift_ha=float(
                                  np.abs(rows - rows[0]).max()))),
              flush=True)


if __name__ == "__main__":
    main()
