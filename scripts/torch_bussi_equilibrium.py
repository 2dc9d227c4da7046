#!/usr/bin/env python3
"""The Bussi bath's equilibrium temperature on the port, fused and unfused.

The scene and start of ``examples/06_reference_anchor_validation_torch.py``
(its ``setup``: 250 O2/N2 + the photon, 46 bohr, float32, FIRE 300 steps,
thermalized at 100 K, Langevin on the photon; dt 0.25 fs),
with the molecules' Bussi bath at ``--tau-ps`` (default 0.05 ps: the
bath, not the slow relaxation of the lattice, then sets the kinetic
energy, whose mean is (dof / 2) kT exactly for a canonical sampler). Runs
``--steps`` steps with the fused tail (K4/K5, CUDA only) and without it
(``fuse_integrator=False``) from the same start, and prints for each the
molecules' mean temperature over the second half, its standard error
from 20 blocks, and the Bussi reservoir's change over that half, as one
JSON line.

    python3 scripts/torch_bussi_equilibrium.py [--device CPU]
        [--tau-ps 0.05] [--steps 20000]

``--device CPU`` runs the unfused tail alone (K4/K5 need the card).
With ``--replicas R`` it runs R replicas of that start instead, as one
batch (``init_replica_states``: replica r thermalized at seed 100 + r,
the default tail), in chunks of 10,000 steps, and prints for each
replica its universe drift, its mean temperature over the run and after
the first 15 ps, and its Bussi reservoir: ``--replicas 8 --tau-ps 5
--steps 200000`` is 06's 50-ps protocol over eight realizations.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cavmd_tpu_torch.core import PhysicalConstants as PC  # noqa: E402
from cavmd_tpu_torch.core.device import resolve_device  # noqa: E402
from cavmd_tpu_torch.integrate import (  # noqa: E402
    init_state,
    make_step_fn,
    run_steps,
    universe_energy,
)

EXAMPLE_06 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "06_reference_anchor_validation_torch.py")


def start(dev, tau_ps):
    """06's start (its ``setup``) with the molecules' bath at ``tau_ps``:
    (snapshot, force field, methods, molecular atoms)."""
    spec = importlib.util.spec_from_file_location("example_06", EXAMPLE_06)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    snap, ff, methods = ex.setup(dev, bussi_tau_ps=tau_ps)
    return snap, ff, methods, int((snap.typeid != ff.l_typeid).sum())


def reading(snap, ff, methods, n_mol, fused, steps):
    step = make_step_fn(ff, methods, fuse_integrator=fused)
    state = init_state(snap, ff, dt=PC.fs_to_atomic_units(0.25), seed=11)
    t0 = time.perf_counter()
    state, obs = run_steps(step, state, steps)
    if state.device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    T = (2 * obs["kinetic_molecular"].astype(np.float64)
         / (3 * n_mol * PC.KB_HARTREE_PER_K))[steps // 2:]
    blocks = np.array_split(T, 20)
    means = np.array([b.mean() for b in blocks])
    res = obs["bussi_reservoir_molecular"]
    return dict(fused=fused, steps=steps, seconds=seconds,
                mean_T_K=float(T.mean()),
                stderr_K=float(means.std(ddof=1) / np.sqrt(len(means))),
                reservoir_change_ha=float(res[-1] - res[steps // 2]))


def replica_readings(snap, ff, methods, n_mol, replicas, steps,
                     chunk=10_000):
    """R realizations of the start through the default (fused on the
    card) batched step: per replica drift, mean T, mean T past 15 ps and
    the final Bussi reservoir."""
    from cavmd_tpu_torch.parallel import (
        init_replica_states,
        run_replica_steps,
    )

    dt = PC.fs_to_atomic_units(0.25)
    state = init_replica_states(snap, ff, n_replicas=replicas, dt=dt,
                                seed=100, kT=PC.kT_from_kelvin(100.0))
    step = make_step_fn(ff, methods)
    late = int(PC.ps_to_atomic_units(15.0) / dt)
    T_sum, T_late, U0, drift, done = 0.0, 0.0, None, 0.0, 0
    t0 = time.perf_counter()
    while done < steps:
        n = min(chunk, steps - done)
        state, obs = run_replica_steps(step, state, n)
        U = universe_energy(obs).astype(np.float64)
        U0 = U[0] if U0 is None else U0
        drift = np.maximum(drift, np.abs(U - U0).max(axis=0))
        T = (2 * obs["kinetic_molecular"].astype(np.float64)
             / (3 * n_mol * PC.KB_HARTREE_PER_K))
        T_sum = T_sum + T.sum(axis=0)
        T_late = T_late + T[max(0, late - done):].sum(axis=0)
        done += n
    if state.device.type == "cuda":
        torch.cuda.synchronize()
    reservoir = state.bussi_reservoir[:, 0].cpu()
    return dict(replicas=replicas, steps=steps,
                seconds=time.perf_counter() - t0,
                drift_ha=np.asarray(drift).tolist(),
                mean_T_K=(T_sum / steps).tolist(),
                mean_T_after_15ps_K=(T_late / max(steps - late, 1)).tolist(),
                bussi_reservoir_ha=reservoir.tolist())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("GPU", "CPU"), default="GPU")
    ap.add_argument("--tau-ps", type=float, default=0.05)
    ap.add_argument("--steps", type=int, default=20_000)
    ap.add_argument("--replicas", type=int, default=1)
    args = ap.parse_args()
    dev = resolve_device("cpu" if args.device == "CPU" else None)
    snap, ff, methods, n_mol = start(dev, args.tau_ps)
    if args.replicas > 1:
        runs = [replica_readings(snap, ff, methods, n_mol, args.replicas,
                                 args.steps)]
    else:
        runs = [reading(snap, ff, methods, n_mol, fused, args.steps)
                for fused in ((True, False) if dev.type == "cuda"
                              else (False,))]
    card = None
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    print(json.dumps(dict(device=str(dev), card=card, tau_ps=args.tau_ps,
                          runs=runs)), flush=True)


if __name__ == "__main__":
    main()
