#!/usr/bin/env python3
"""Replicas x slabs on the PyTorch/CUDA port: a replica batch whose
trajectories run on R x S processes, each process one x slab of its
replicas (the port's form of the JAX example's (replica x atoms) mesh).

Each rank runs ``make_domain_runner(n_replicas=R)`` (``parallel/
domain.py``): the slab's pair pass in the slab tile kernel
(``cell_pair_slab``), the PPPM spread and interpolation (K2, K3), once a
step for the rank's replicas. As in the JAX example, a world of W ranks
is R = 2 replicas x S = W / 2 slabs when W is even, else 1 x W. Start it
with ``torch.distributed.run``:

    python -m torch.distributed.run --nproc-per-node 2 \\
        examples/04_slab_replicas_torch.py               # 2 x 1, one GPU
    python -m torch.distributed.run --nproc-per-node 2 \\
        examples/04_slab_replicas_torch.py --device CPU  # 2 x 1, gloo

or with no launcher for one process (1 x 1). The replica axis carries
small host arrays over gloo, so R ranks may share one GPU; S > 1 slabs on
the GPU need S GPUs (NCCL refuses two ranks on one card). The scene is
the JAX example's 64 molecules in a 32-bohr box with an 8-bohr cutoff, so
that the cells (cutoff + 0.5 wide, at least 3 an axis) fit one slab; two
slabs need a box of at least 51 bohr (``box_L=``).
"""

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from cavmd_tpu_torch.core import PhysicalConstants as PC
from cavmd_tpu_torch.core import add_cavity_particle, make_diatomic_system
from cavmd_tpu_torch.core.device import resolve_device
from cavmd_tpu_torch.integrate import (
    ForceField,
    MethodSpec,
    resolve_methods,
    universe_energy,
)
from cavmd_tpu_torch.parallel import (
    grid_communicators,
    init_replica_states,
    make_domain_runner,
    plan_domain,
    split_replica_obs,
)


def grid(world: int):
    """(replicas, slabs) of a world: 2 x world/2 when even, else 1 x it."""
    R = 2 if world % 2 == 0 and world > 1 else 1
    return R, world // R


def join_ranks(dev) -> bool:
    """Join the process group ``torch.distributed.run`` describes in the
    environment, unless one is up or there is none; returns whether this
    call made it. NCCL with the card ``LOCAL_RANK`` for slabs on the GPU,
    else gloo."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    _, S = grid(int(os.environ["WORLD_SIZE"]))
    backend = "nccl" if S > 1 and dev.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend)
    return True


def main(n_molecules=64, box_L=32.0, r_cut=8.0, n_steps=200,
         rebuild_every=20, device=None):
    """Run the example on this rank; returns its figures (the whole batch
    on every rank): ``replicas`` R, ``slabs`` S, and a replica each
    ``final_ke_ha`` (the molecules' last kinetic energy), ``mean_T_K``
    (their mean T), ``drift_ha`` (max |U - U[0]| of the universe energy)
    and the final ``bussi_reservoir_ha`` (molecules) and
    ``langevin_reservoir_ha`` (photon). Raises when a slab overflowed its
    cells or capacity."""
    dev = resolve_device(device)
    made = join_ranks(dev)
    try:
        world = dist.get_world_size() if dist.is_initialized() else 1
        R, S = grid(world)
        lead = not dist.is_initialized() or dist.get_rank() == 0
        if lead:
            print(f"ranks: {world} -> (replica={R}, slabs={S})")

        kT = PC.kT_from_kelvin(100.0)
        snap = make_diatomic_system(n_molecules, box_L=box_L, seed=0,
                                    dtype=torch.float32, device=dev)
        snap = add_cavity_particle(
            snap, coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0,
            seed=1
        )
        ff = ForceField.create(snap, coupling=1e-3, r_cut=r_cut,
                               pair_mode="cell", pppm_mesh=(16, 16, 16))
        methods = resolve_methods(snap, (
            MethodSpec(kind="bussi", group="molecular", kT=kT,
                       tau=PC.ps_to_atomic_units(5.0)),
            MethodSpec(kind="langevin", group="cavity", kT=kT,
                       gamma=PC.gamma_from_tau_ps(5.0)),
        ), ff.l_typeid)

        comm = grid_communicators(1, S)[1] if world > 1 and R == 1 else None
        run = make_domain_runner(ff, methods, plan_domain(snap, ff, S), comm,
                                 rebuild_every=rebuild_every, n_replicas=R)
        batched = init_replica_states(
            snap, ff, n_replicas=R, dt=PC.fs_to_atomic_units(0.25), seed=0,
            kT=kT,
        )
        final, obs = run(batched, n_steps)
        if obs["cell_overflow"].any():
            raise RuntimeError(
                "a slab overflowed its cells or capacity: rerun with a "
                "smaller rebuild_every")

        n_mol_atoms = snap.N - 1
        out = dict(replicas=R, slabs=S, final_ke_ha=[], mean_T_K=[],
                   drift_ha=[],
                   bussi_reservoir_ha=final.bussi_reservoir[:, 0].tolist(),
                   langevin_reservoir_ha=(
                       final.langevin_reservoir[:, 1].tolist()))
        for r, o in enumerate(split_replica_obs(obs, R)):
            U = universe_energy(o)
            ke = o["kinetic_molecular"]
            out["final_ke_ha"].append(float(ke[-1]))
            out["mean_T_K"].append(float(
                2 * ke.mean() / (3 * n_mol_atoms * PC.KB_HARTREE_PER_K)))
            out["drift_ha"].append(float(np.abs(U - U[0]).max()))
        if lead:
            print(f"ran {n_steps} steps over {S} slab(s) on {dev}; final "
                  f"molecular KE per replica: {out['final_ke_ha']} Ha, "
                  f"universe drift {out['drift_ha']} Ha")
        return out
    finally:
        if made:
            dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("GPU", "CPU"), default="GPU")
    main(device="cpu" if ap.parse_args().device == "CPU" else None)
