#!/usr/bin/env python3
"""Where the cell kernel's time goes at N = 100,001, on one GPU.

Run from the root of a checkout on a machine with a CUDA device:
``python3 scripts/bench_cell_kernel_parts.py [--n-molecules 50000]``. On
the scene of ``build_large_n`` (``--n-molecules`` O2/N2 + photon at the
reference density, f32, cell mode, the list built once) it times one call
of ``ops/cell_kernels.py:cell_pair_force_fused`` four ways through its own
``lj_on`` / ``coul_on`` switches: both terms (the main path), LJ only,
Ewald only, and neither. With neither, the kernel still stages the 27
neighbour cells, runs the candidate loop (displacement, r^2, cutoff test,
the per-warp queue) and takes the queued pairs, but evaluates no pair
term; the difference to the full call is the pair term's share. Each time
is the median device time of one call over 15 samples of 10 calls queued
behind a spin kernel (CUDA events), as ``chip_smoke.py`` times kernels.
Prints one JSON line, then the card's name and power limit as nvidia-smi
reports them.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_ms(torch, fn, reps=15, inner=10, spin_cycles=200_000_000):
    """Median device time of one call: ``inner`` calls queued behind a spin
    kernel, so the device runs them back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        covered = not start.query()
        end.synchronize()
        if not covered:
            sys.exit("bench_cell_kernel_parts.py: the host fell behind the "
                     "device; raise spin_cycles")
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-molecules", type=int, default=50_000)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_cell_kernel_parts.py needs a CUDA device")
    import cavmd_tpu_torch as pt
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.ops import cell_kernels as ck

    n_mol = args.n_molecules
    snap = pt.add_cavity_particle(
        pt.make_diatomic_system(n_mol, box_L=reference_box_for(n_mol),
                                temperature_K=100.0, seed=0),
        coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0,
        seed=1).astype(torch.float32)
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                              pair_mode="cell")
    clist = ff.build_cells(snap.position, snap.box_L)
    if bool(clist.overflow):
        sys.exit("bench_cell_kernel_parts.py: the cell list overflowed")
    cell_args = (snap.position, snap.box_L, clist, ff.cell_cfg, snap.typeid,
                 snap.charge, ff.lj_eps, ff.lj_sig2, ff.lj_rcut2,
                 ff.lj_vshift, ff.cell_exclusions, ff.kappa_value)
    res = dict(n_particles=snap.N, ncells=ff.cell_cfg.ncells,
               cap=ff.cell_cfg.cap)
    for label, lj, coul in (("both_ms", True, True), ("lj_only_ms", True, False),
                            ("ewald_only_ms", False, True),
                            ("neither_ms", False, False)):
        res[label] = device_ms(torch, lambda: ck.cell_pair_force_fused(
            *cell_args, lj_on=lj, coul_on=coul))
    res["pair_term_share"] = 1.0 - res["neither_ms"] / res["both_ms"]
    print(json.dumps(res), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
