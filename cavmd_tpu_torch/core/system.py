"""System generator: an O2/N2 diatomic liquid equivalent to ``init-0.gsd``.

Port of ``cavmd_tpu/core/system.py``. The scene is drawn host-side with the
same ``np.random.default_rng`` call sequence as the JAX package, so both
packages build bit-identical scenes from one seed.
"""

from __future__ import annotations

import numpy as np
import torch

from cavmd_tpu_torch.core.device import resolve_device
from cavmd_tpu_torch.core.snapshot import Snapshot

# Bond parameters — reference examples/05_advanced_run.py:568-569
BOND_PARAMS = {
    "O-O": dict(k=2 * 0.36602, r0=2.281655158),
    "N-N": dict(k=2 * 0.71625, r0=2.0743522177),
}

# LJ parameters — reference examples/05_advanced_run.py:577-582
LJ_PARAMS = {
    ("O", "O"): dict(epsilon=0.00016685201, sigma=6.230426584),
    ("N", "N"): dict(epsilon=0.000083426, sigma=5.48277488),
    ("N", "O"): dict(epsilon=0.00025027802, sigma=4.9832074319),
}

# Atomic masses in electron-mass units (m_u = 1822.888486 m_e)
MASS_O = 15.999 * 1822.888486
MASS_N = 14.007 * 1822.888486

# the reference scene: 250 molecules in a 46.0-bohr box (init-0.gsd)
REFERENCE_N_MOLECULES = 250
REFERENCE_BOX_L = 46.0


def reference_box_for(n_molecules: int) -> float:
    """Cubic box edge holding ``n_molecules`` at the reference density."""
    return REFERENCE_BOX_L * (n_molecules / REFERENCE_N_MOLECULES) ** (1 / 3)


def make_diatomic_system(
    n_molecules: int = 250,
    *,
    box_L: float = 46.0,
    charge_magnitude: float = 0.2,
    fraction_oxygen: float = 0.5,
    temperature_K: float | None = None,
    seed: int = 0,
    dtype=torch.float64,
    device=None,
) -> Snapshot:
    """Generate a periodic box of O-O / N-N diatomics.

    Molecules sit on a jittered cubic lattice with random orientations; the
    two atoms of a molecule carry +q and -q. With ``temperature_K`` the
    velocities are Maxwell-Boltzmann with the centre-of-mass drift removed.
    Types: 0 = 'O', 1 = 'N'; bond b joins atoms (2b, 2b+1). The tensors
    go to ``device``; None is the CUDA device, and raises without one.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_atoms = 2 * n_molecules

    n_side = int(np.ceil(n_molecules ** (1.0 / 3.0)))
    spacing = box_L / n_side
    grid = np.arange(n_side) * spacing - box_L / 2 + spacing / 2
    centers = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"), axis=-1)
    centers = centers.reshape(-1, 3)[:n_molecules]
    centers = centers + rng.normal(scale=0.05 * spacing, size=centers.shape)

    u = rng.normal(size=(n_molecules, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)

    n_oxy = int(round(fraction_oxygen * n_molecules))
    is_oxygen = np.zeros(n_molecules, dtype=bool)
    is_oxygen[:n_oxy] = True
    rng.shuffle(is_oxygen)

    r0 = np.where(is_oxygen, BOND_PARAMS["O-O"]["r0"], BOND_PARAMS["N-N"]["r0"])
    half = 0.5 * r0[:, None] * u

    pos = np.empty((n_atoms, 3))
    pos[0::2] = centers - half
    pos[1::2] = centers + half

    typeid = np.empty(n_atoms, dtype=np.int32)
    typeid[0::2] = np.where(is_oxygen, 0, 1)
    typeid[1::2] = typeid[0::2]

    mass = np.where(typeid == 0, MASS_O, MASS_N)

    charge = np.empty(n_atoms)
    charge[0::2] = charge_magnitude
    charge[1::2] = -charge_magnitude

    box = np.full(3, box_L)
    image = np.floor((pos + box / 2) / box).astype(np.int32)
    pos = pos - image * box

    bond_group = np.stack(
        [np.arange(0, n_atoms, 2), np.arange(1, n_atoms, 2)], axis=1
    ).astype(np.int32)
    bond_typeid = np.where(is_oxygen, 0, 1).astype(np.int32)

    velocity = np.zeros((n_atoms, 3))
    if temperature_K is not None:
        from cavmd_tpu_torch.core.units import PhysicalConstants

        kT = PhysicalConstants.kT_from_kelvin(temperature_K)
        velocity = rng.normal(size=(n_atoms, 3)) * np.sqrt(kT / mass)[:, None]
        velocity -= np.average(velocity, axis=0, weights=mass)

    return Snapshot.create(
        position=pos,
        box_L=box,
        velocity=velocity,
        image=image,
        mass=mass,
        charge=charge,
        typeid=typeid,
        types=("O", "N"),
        bond_group=bond_group,
        bond_typeid=bond_typeid,
        bond_types=("O-O", "N-N"),
        dtype=dtype,
        device=device,
    )
