#!/usr/bin/env python3
"""Where the time of one step of cavmd_tpu_torch goes, on one GPU.

Run from the root of a checkout on a machine with a CUDA device:
``python3 scripts/profile_torch_step.py [--variants unfused,default,cli]
[--n-molecules 250] [--root DIR] [--no-profile]``. For each step variant
of the scene (``--n-molecules`` O2/N2 + photon at the reference density,
250 by default: the N = 501 reference scene in a 46-bohr box; f32, the
ForceField's own pair mode, dense up to N = 4096 and cell lists above;
Bussi + Langevin, dt 0.25 fs) it prints one JSON line:

- ``default``: ``Simulation`` with no options (on the card: the fused
  tail, K4/K5 around the force pass);
- ``unfused``: ``fuse_integrator=False``;
- ``cli``: the CLI's step: fused, adaptive dt (period 500) and the F(k,t)
  observables (dipole + 50 wavevectors), as ``advanced_run`` runs it;
- ``domain``: ``shard_atoms=1``, the slab domain pipeline on one process
  (cell mode whatever N; a rebuild every 20 steps);
- ``zcol``: ``Simulation`` with ``pair_mode='zcol'`` (z-sorted columns;
  needs 3 columns of r_cut + skin per axis: ``--n-molecules`` 300 or
  more).

Per variant: the host wall time per step without the profiler (median of
five 200-step chunks, each ended by ``torch.cuda.synchronize()``); and,
unless ``--no-profile``, from ``torch.profiler`` over 50 steps: the device
kernels (and memory operations) per step, their summed device time per
step, the union of their intervals per step, the device busy share (that
union over the unprofiled wall time) and the twelve largest kernels by
device time (at N > 4096 the cell or zcol pass, the list build's sorts
and scan, and K2-K5 each show). ``--root`` imports ``cavmd_tpu_torch`` from another checkout
(for example an unpacked parent commit; only ``default`` runs there), so
two versions can be timed in one run on one card. The last line names
the card and its power limit as nvidia-smi reports them.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

PROFILED_STEPS = 50


def build(pt, torch, variant, n_mol):
    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.core.system import reference_box_for

    snap = pt.add_cavity_particle(
        pt.make_diatomic_system(n_mol, box_L=reference_box_for(n_mol),
                                temperature_K=100.0, seed=0),
        coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0,
        seed=1).astype(torch.float32).to(torch.device("cuda"))
    pair_mode = {"domain": "cell", "zcol": "zcol"}.get(variant)
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                              pair_mode=pair_mode)
    kT = PC.kT_from_kelvin(100.0)
    methods = (
        pt.MethodSpec(kind="bussi", group="molecular", kT=kT,
                      tau=PC.ps_to_atomic_units(5.0)),
        pt.MethodSpec(kind="langevin", group="cavity", kT=kT,
                      gamma=PC.gamma_from_tau_ps(5.0)),
    )
    kw = dict(dt=PC.fs_to_atomic_units(0.25), seed=7, chunk_size=200)
    if variant == "unfused":
        kw["fuse_integrator"] = False
    if variant == "domain":
        kw["shard_atoms"] = 1
    if variant == "cli":
        from cavmd_tpu_torch.observe import (
            generate_fibonacci_sphere,
            make_extra_obs,
        )

        kw.update(error_tolerance=1.0, adaptive_period=500,
                  extra_obs=make_extra_obs(
                      dipole=True,
                      wavevectors=generate_fibonacci_sphere(50)))
    sim = pt.Simulation(snap, ff, methods, **kw)
    if variant == "cli":
        sim.set_optimal_timestep(1e-3)
    return sim


def union_us(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profile(pt, torch, variant, with_profiler, n_mol):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    sim = build(pt, torch, variant, n_mol)
    sim.run(n_steps=400)
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        sim.run(n_steps=200)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / 200 * 1e3)
    wall_ms = statistics.median(walls)
    res = dict(variant=variant, n_particles=sim.snapshot.N,
               pair_mode=sim.ff.pair_mode, wall_ms_per_step=wall_ms,
               steps_per_s=1e3 / wall_ms, chunk_wall_ms_per_step=walls)
    if not with_profiler:
        return res
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        sim.run(n_steps=PROFILED_STEPS)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    intervals = [(e.time_range.start, e.time_range.end) for e in dev]
    by_name = {}
    for e in dev:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    busy_us = union_us(intervals) / PROFILED_STEPS
    return dict(
        res, device_ops_per_step=len(dev) / PROFILED_STEPS,
        device_us_per_step_summed=sum(b - a for a, b in intervals)
        / PROFILED_STEPS,
        device_us_per_step_union=busy_us,
        device_busy_share=busy_us / (wall_ms * 1e3),
        top_kernels_us_per_step={k[:80]: v / PROFILED_STEPS
                                 for k, v in top})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="unfused,default,cli")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))),
        help="checkout whose cavmd_tpu_torch is imported")
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--n-molecules", type=int, default=250,
                    help="diatomics at the reference density (50000: the "
                         "N = 100,001 cell-mode scene)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_torch_step.py needs a CUDA device")
    import cavmd_tpu_torch as pt

    for variant in args.variants.split(","):
        res = profile(pt, torch, variant, not args.no_profile,
                      args.n_molecules)
        res["root"] = args.root
        print(json.dumps(res), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)


if __name__ == "__main__":
    main()
