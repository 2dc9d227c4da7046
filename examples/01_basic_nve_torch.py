#!/usr/bin/env python3
"""Minimal example on the PyTorch/CUDA port: NVE cavity MD with an energy
conservation check.

Generates a small O2/N2 scene, injects the photon, relaxes it with FIRE
and runs NVE velocity Verlet in float64: the total energy is conserved to
the discretization error. On the GPU the pair pass and the PPPM mesh run
in the port's CUDA kernels (float64 instantiations); the integrator tail
runs unfused, as it does for any float64 state.

    python examples/01_basic_nve_torch.py               # on the GPU
    python examples/01_basic_nve_torch.py --device CPU  # on the CPU
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
    potential_energy,
    resolve_methods,
    run_steps,
)
from cavmd_tpu_torch.utils import fire_minimize


def main(n_molecules=50, box_L=30.0, n_steps=2000, fire_steps=200,
         device=None):
    """Run the example; returns its figures: the simulated ``time_ps``,
    the total ``energy`` a step (Ha) and its ``drift_ha``."""
    dev = resolve_device(device)
    snap = make_diatomic_system(n_molecules, box_L=box_L,
                                temperature_K=100.0, seed=0, device=dev)
    snap = add_cavity_particle(
        snap, coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1
    )
    ff = ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0)
    snap = fire_minimize(snap, ff, n_steps=fire_steps)

    methods = resolve_methods(
        snap, (MethodSpec(kind="nve", group="all"),), ff.l_typeid
    )
    step = make_step_fn(ff, methods)
    state = init_state(snap, ff, dt=PC.fs_to_atomic_units(0.25), seed=2)

    final, obs = run_steps(step, state, n_steps)
    E = (potential_energy(obs) + obs["kinetic_molecular"]
         + obs["kinetic_cavity"])
    time_ps = float(final.time_au) * PC.TIME_PS_CONVERSION
    drift = float(np.abs(E - E[0]).max())
    print(f"ran {n_steps} NVE steps ({time_ps:.3f} ps) on {dev}")
    print(f"total energy drift: {drift:.3e} Ha")
    return dict(time_ps=time_ps, energy=E, drift_ha=drift)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("GPU", "CPU"), default="GPU")
    main(device="cpu" if ap.parse_args().device == "CPU" else None)
