#!/usr/bin/env python3
"""Replica parallelism on the PyTorch/CUDA port: a batch of independent
trajectories advanced as one state with a leading replica axis (the
one-device form of the reference's SLURM array jobs).

Runs in float32, as the JAX example does on an accelerator: on the GPU
the batched step launches each of the dense pair kernel (K1), the PPPM
spread and interpolation (K2, K3) and the fused integrator tail (K4, K5)
once a step for the whole batch.

    python examples/03_replicas_torch.py [--device CPU]
"""

import argparse

import numpy as np
import torch

from cavmd_tpu_torch.core import PhysicalConstants as PC
from cavmd_tpu_torch.core import add_cavity_particle, make_diatomic_system
from cavmd_tpu_torch.core.device import resolve_device
from cavmd_tpu_torch.integrate import (
    ForceField,
    MethodSpec,
    make_step_fn,
    resolve_methods,
    universe_energy,
)
from cavmd_tpu_torch.parallel import (
    init_replica_states,
    run_replica_steps,
    split_replica_obs,
)
from cavmd_tpu_torch.utils import fire_minimize


def main(n_replicas=8, n_molecules=50, box_L=30.0, n_steps=300,
         fire_steps=200, t_window=100, device=None):
    """Run the example; returns its figures, one entry a replica:
    ``mean_T_K`` (the molecules' mean T over the last ``t_window``
    steps), ``cavity_ke_ha`` (the photon's last kinetic energy),
    ``drift_ha`` (max |U - U[0]| of the universe energy) and the final
    ``bussi_reservoir_ha`` (molecules) and ``langevin_reservoir_ha``
    (photon)."""
    dev = resolve_device(device)
    kT = PC.kT_from_kelvin(100.0)
    snap = make_diatomic_system(n_molecules, box_L=box_L, seed=0,
                                dtype=torch.float32, device=dev)
    snap = add_cavity_particle(
        snap, coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1
    )
    ff = ForceField.create(snap, coupling=1e-3)
    snap = fire_minimize(snap, ff, n_steps=fire_steps)

    methods = resolve_methods(snap, (
        MethodSpec(kind="bussi", group="molecular", kT=kT,
                   tau=PC.ps_to_atomic_units(5.0)),
        MethodSpec(kind="langevin", group="cavity", kT=kT,
                   gamma=PC.gamma_from_tau_ps(5.0)),
    ), ff.l_typeid)
    step = make_step_fn(ff, methods)

    batched = init_replica_states(
        snap, ff, n_replicas=n_replicas,
        dt=PC.fs_to_atomic_units(0.25), seed=100, kT=kT,
    )
    final, obs = run_replica_steps(step, batched, n_steps)

    out = dict(mean_T_K=[], cavity_ke_ha=[], drift_ha=[],
               bussi_reservoir_ha=final.bussi_reservoir[:, 0].tolist(),
               langevin_reservoir_ha=final.langevin_reservoir[:, 1].tolist())
    for r, o in enumerate(split_replica_obs(obs, n_replicas)):
        ke = o["kinetic_molecular"][-t_window:].mean()
        U = universe_energy(o)
        out["mean_T_K"].append(
            float(2 * ke / (3 * (snap.N - 1) * PC.KB_HARTREE_PER_K)))
        out["cavity_ke_ha"].append(float(o["kinetic_cavity"][-1]))
        out["drift_ha"].append(float(np.abs(U - U[0]).max()))
        print(f"replica {r}: <T> = {out['mean_T_K'][-1]:.1f} K, "
              f"cavity KE = {out['cavity_ke_ha'][-1]:.2e} Ha, "
              f"universe drift {out['drift_ha'][-1]:.2e} Ha")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("GPU", "CPU"), default="GPU")
    main(device="cpu" if ap.parse_args().device == "CPU" else None)
