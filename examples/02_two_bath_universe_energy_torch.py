#!/usr/bin/env python3
"""The reference workflow's physics on the PyTorch/CUDA port: a Bussi
molecular bath and a Langevin cavity bath, with the conserved universe
energy (system + reservoirs) as the correctness diagnostic.

Runs in float64, as the JAX example does: on the GPU the pair pass and
the PPPM mesh run in the port's CUDA kernels, the baths in the unfused
tail (the fused tail K4/K5 takes float32 states).

    python examples/02_two_bath_universe_energy_torch.py [--device CPU]
"""

import argparse

import numpy as np

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


def main(n_molecules=100, box_L=36.0, n_steps=4000, fire_steps=300,
         t_window=500, state_seed=4, device=None):
    """Run the example; returns its figures: ``drift_ha`` (max |U - U[0]|
    of the universe energy), ``mean_T_K`` (the molecules' mean T over the
    last ``t_window`` steps), the two reservoirs (Ha) and ``time_ps``."""
    dev = resolve_device(device)
    kT = PC.kT_from_kelvin(100.0)
    snap = make_diatomic_system(n_molecules, box_L=box_L, seed=0,
                                device=dev)
    snap = add_cavity_particle(
        snap, coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1
    )
    ff = ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0)
    snap = fire_minimize(snap, ff, n_steps=fire_steps)
    mol = snap.typeid != ff.l_typeid
    v = thermalize_velocities(
        make_generator(2, STREAM_THERMALIZE, device=dev), snap.mass, mol, kT)
    v = v + thermalize_velocities(
        make_generator(3, STREAM_THERMALIZE, device=dev), snap.mass, ~mol,
        kT, remove_drift=False)
    snap = snap.replace(velocity=v)

    methods = resolve_methods(snap, (
        MethodSpec(kind="bussi", group="molecular", kT=kT,
                   tau=PC.ps_to_atomic_units(5.0)),
        MethodSpec(kind="langevin", group="cavity", kT=kT,
                   gamma=PC.gamma_from_tau_ps(5.0)),
    ), ff.l_typeid)
    step = make_step_fn(ff, methods)
    state = init_state(snap, ff, dt=PC.fs_to_atomic_units(0.25),
                       seed=state_seed)

    final, obs = run_steps(step, state, n_steps)
    U = universe_energy(obs)
    T = obs["kinetic_molecular"] * 2 / (
        3 * int(mol.sum()) * PC.KB_HARTREE_PER_K
    )
    out = dict(time_ps=float(final.time_au) * PC.TIME_PS_CONVERSION,
               drift_ha=float(np.abs(U - U[0]).max()),
               mean_T_K=float(T[-t_window:].mean()),
               bussi_reservoir_ha=float(final.bussi_reservoir[0]),
               langevin_reservoir_ha=float(final.langevin_reservoir[1]))
    print(f"universe energy drift over {out['time_ps']:.2f} ps on {dev}: "
          f"{out['drift_ha']:.3e} Ha")
    print(f"molecular T: {out['mean_T_K']:.1f} K (target 100)")
    print(f"Bussi reservoir: {out['bussi_reservoir_ha']:+.5f} Ha, "
          f"Langevin cavity reservoir: {out['langevin_reservoir_ha']:+.5f} "
          "Ha")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("GPU", "CPU"), default="GPU")
    main(device="cpu" if ap.parse_args().device == "CPU" else None)
