#!/usr/bin/env python3
"""Reproduce the reference's headline validation on the PyTorch/CUDA port.

The cav-hoomd notebook's only quantitative result (BASELINE.md): universe
energy (system + reservoirs) drifts 0.0055 Ha over 50.9 ps at 501
particles with Bussi + Langevin baths, a ~4.5 h CPU run. This script runs
the same 50 ps of physics (250 O2/N2 + the photon, FIRE-relaxed,
thermalized at 100 K, float32, dt 0.25 fs: 200,000 steps) and prints the
drift, the molecular temperature and the rate. On the GPU this is the
port's fused main path: the dense pair kernel (K1), the PPPM spread and
interpolation (K2, K3) and the fused integrator tail (K4, K5), each once
a step. Measured on an NVIDIA H100 80GB HBM3 at 700 W: see PERF.md.

    python examples/06_reference_anchor_validation_torch.py [--device CPU]
        [--runtime-ps 50]
"""

import argparse
import time

import numpy as np
import torch

from cavmd_tpu_torch.core import PhysicalConstants as PC
from cavmd_tpu_torch.core import add_cavity_particle, make_diatomic_system
from cavmd_tpu_torch.core.device import resolve_device
from cavmd_tpu_torch.integrate import (
    ForceField,
    MethodSpec,
    init_state,
    make_step_fn,
    resolve_methods,
    run_steps,
    thermalize_velocities,
    universe_energy,
)
from cavmd_tpu_torch.integrate.rng import STREAM_THERMALIZE, make_generator
from cavmd_tpu_torch.utils import fire_minimize


def setup(device=None, n_molecules=250, box_L=46.0, fire_steps=300,
          bussi_tau_ps=5.0):
    """06's start: the scene FIRE-relaxed, thermalized at 100 K (the
    molecules with their drift removed, the photon apart), and its baths
    (Bussi on the molecules at ``bussi_tau_ps``, Langevin on the photon
    at 5 ps). Returns (snapshot, force field, methods)."""
    dev = resolve_device(device)
    snap = make_diatomic_system(n_molecules, box_L=box_L, seed=0,
                                dtype=torch.float64, device=dev)
    snap = add_cavity_particle(
        snap, coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1
    ).astype(torch.float32)
    ff = ForceField.create(snap, coupling=1e-3, dtype=torch.float32)
    snap = fire_minimize(snap, ff, n_steps=fire_steps)

    kT = PC.kT_from_kelvin(100.0)
    mol = snap.typeid != ff.l_typeid
    v = thermalize_velocities(
        make_generator(5, STREAM_THERMALIZE, device=dev), snap.mass, mol, kT)
    v = v + thermalize_velocities(
        make_generator(6, STREAM_THERMALIZE, device=dev), snap.mass, ~mol,
        kT, remove_drift=False)
    snap = snap.replace(velocity=v)

    methods = resolve_methods(snap, (
        MethodSpec(kind="bussi", group="molecular", kT=kT,
                   tau=PC.ps_to_atomic_units(bussi_tau_ps)),
        MethodSpec(kind="langevin", group="cavity", kT=kT,
                   gamma=PC.gamma_from_tau_ps(5.0)),
    ), ff.l_typeid)
    return snap, ff, methods


def main(runtime_ps=50.0, dt_fs=0.25, n_molecules=250, box_L=46.0,
         fire_steps=300, chunk=10_000, device=None):
    """Run the example; returns its figures: ``steps``, ``wall_s`` and
    ``steps_per_s`` of the run (the set-up apart), ``drift_ha`` (max
    |U - U[0]| of the universe energy over the run), ``final_T_K``,
    ``mean_T_K`` and ``chunk_mean_T_K`` (the molecules' temperature at
    the last step, over the run and over each chunk), and the final
    ``bussi_reservoir_ha`` (molecules) and ``langevin_reservoir_ha``
    (photon): the energy each bath has taken out of the system."""
    snap, ff, methods = setup(device, n_molecules, box_L, fire_steps)
    dev = snap.device
    mol = snap.typeid != ff.l_typeid
    step = make_step_fn(ff, methods)

    dt = PC.fs_to_atomic_units(dt_fs)
    n_steps = int(PC.ps_to_atomic_units(runtime_ps) / dt)
    state = init_state(snap, ff, dt=dt, seed=11)
    to_K = 2 / (3 * int(mol.sum()) * PC.KB_HARTREE_PER_K)

    print(f"running {n_steps} steps ({runtime_ps} ps) on {dev} ...",
          flush=True)
    t0 = time.perf_counter()
    U0, drift, chunk_T, done = None, 0.0, [], 0
    while done < n_steps:
        n = min(chunk, n_steps - done)
        state, obs = run_steps(step, state, n)
        U = universe_energy(obs)
        if U0 is None:
            U0 = U[0]
        drift = max(drift, float(np.abs(U - U0).max()))
        chunk_T.append(float(obs["kinetic_molecular"].mean()) * to_K)
        done += n
        print(f"  {done} steps: drift so far {drift:.3e} Ha, mean T over "
              f"the chunk {chunk_T[-1]:.1f} K", flush=True)
    wall = time.perf_counter() - t0
    sizes = [min(chunk, n_steps - k) for k in range(0, n_steps, chunk)]
    out = dict(steps=done, wall_s=wall, steps_per_s=done / wall,
               drift_ha=drift,
               final_T_K=float(obs["kinetic_molecular"][-1]) * to_K,
               mean_T_K=float(np.dot(chunk_T, sizes)) / done,
               chunk_mean_T_K=chunk_T,
               bussi_reservoir_ha=float(state.bussi_reservoir[0]),
               langevin_reservoir_ha=float(state.langevin_reservoir[1]))
    print(f"wall time: {wall:.1f} s ({out['steps_per_s']:.0f} steps/s)")
    print(f"universe drift over {runtime_ps} ps: {drift:.2e} Ha "
          f"(reference anchor: 5.5e-3 Ha)")
    print(f"molecular T: final {out['final_T_K']:.1f} K, mean "
          f"{out['mean_T_K']:.1f} K (target 100)")
    print(f"reservoirs: Bussi {out['bussi_reservoir_ha']:+.5f} Ha, "
          f"Langevin {out['langevin_reservoir_ha']:+.5f} Ha")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("GPU", "CPU"), default="GPU")
    ap.add_argument("--runtime-ps", type=float, default=50.0)
    args = ap.parse_args()
    main(runtime_ps=args.runtime_ps,
         device="cpu" if args.device == "CPU" else None)
