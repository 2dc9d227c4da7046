"""The benchmark's inputs, made from ``--seed``: the scene and the
replicas' thermal velocities. Both the program and the reference are
handed these arrays.

The scene is the cav-hoomd diatomic liquid at the configuration's scale:
``n_molecules`` O2/N2 molecules on a jittered cubic lattice with random
orientations, at the density of the 250-molecule reference box, charges
+q/-q on each molecule's two atoms, bonds (2b, 2b + 1), and one cavity
photon (type 'L', charge 0) drawn from its thermal distribution.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def seed_words(seed: int, *salt: int) -> list:
    """Entropy words for NumPy's SeedSequence: any whole seed >= 0."""
    if seed < 0:
        raise ValueError(f"--seed must be >= 0 (got {seed})")
    return [seed & 0xFFFFFFFF, seed >> 32, *salt]


def make_scene(cfg: dict, seed: int) -> dict:
    """The scene of configuration ``cfg`` as float64/int host arrays."""
    sc, phys, units = cfg["scene"], cfg["physics"], cfg["units"]
    rng = np.random.default_rng(np.random.SeedSequence(seed_words(seed, 1)))
    n_mol = int(sc["n_molecules"])
    box_L = float(sc["reference_box_L"]) * (
        n_mol / float(sc["reference_n_molecules"])) ** (1.0 / 3.0)
    n_side = int(math.ceil(n_mol ** (1.0 / 3.0) - 1e-9))
    spacing = box_L / n_side
    grid = np.arange(n_side) * spacing - box_L / 2 + spacing / 2
    centers = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"),
                       axis=-1).reshape(-1, 3)[:n_mol]
    centers = centers + rng.normal(scale=float(sc["lattice_jitter"])
                                   * spacing, size=centers.shape)
    u = rng.normal(size=(n_mol, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    is_o = np.zeros(n_mol, dtype=bool)
    is_o[:int(round(float(sc["fraction_oxygen"]) * n_mol))] = True
    rng.shuffle(is_o)
    bonds = phys["bonds"]
    r0 = np.where(is_o, bonds["O-O"]["r0"], bonds["N-N"]["r0"])
    half = 0.5 * r0[:, None] * u
    n = 2 * n_mol
    pos = np.empty((n + 1, 3))
    pos[0:n:2] = centers - half
    pos[1:n:2] = centers + half
    types = list(sc["types"])
    typeid = np.empty(n + 1, dtype=np.int32)
    typeid[0:n:2] = np.where(is_o, types.index("O"), types.index("N"))
    typeid[1:n:2] = typeid[0:n:2]
    typeid[n] = types.index("L")
    me = float(units["me_per_amu"])
    mass = np.array([float(sc["mass_amu"][types[t]]) * me
                     if types[t] != "L" else float(sc["photon_mass"])
                     for t in typeid])
    q = float(sc["charge_magnitude"])
    charge = np.zeros(n + 1)
    charge[0:n:2] = q
    charge[1:n:2] = -q
    kT = float(units["kB_hartree_per_K"]) * float(phys["temperature_K"])
    omega = float(phys["freq_cm1"]) / float(units["cm1_per_hartree"])
    pos[n] = rng.normal(scale=math.sqrt(kT / omega ** 2), size=3)
    box = np.full(3, box_L)
    image = np.floor((pos + box / 2) / box).astype(np.int32)
    pos = pos - image * box
    return dict(
        position=pos, image=image, typeid=typeid, mass=mass, charge=charge,
        box=box, types=tuple(types),
        bond_group=np.stack([np.arange(0, n, 2), np.arange(1, n, 2)],
                            axis=1).astype(np.int32),
        bond_typeid=np.where(is_o, 0, 1).astype(np.int32),
        bond_types=("O-O", "N-N"))


def thermal_velocities(cfg: dict, scene: dict, replicas: int, seed: int,
                       device) -> torch.Tensor:
    """(B, N, 3) float64 Maxwell-Boltzmann velocities at the bath
    temperature, made on ``device`` from the seed: the molecules with each
    replica's centre-of-mass drift removed, the photon drawn apart."""
    gen = torch.Generator(device=device)
    words = np.random.SeedSequence(seed_words(seed, 2)).generate_state(2)
    gen.manual_seed(int(words[0]) << 31 ^ int(words[1]))
    mass = torch.as_tensor(scene["mass"], dtype=torch.float64, device=device)
    kT = float(cfg["units"]["kB_hartree_per_K"]) * float(
        cfg["physics"]["temperature_K"])
    v = torch.randn((replicas,) + tuple(mass.shape) + (3,), generator=gen,
                    dtype=torch.float64, device=device)
    v = v * torch.sqrt(kT / mass)[:, None]
    mol = torch.as_tensor(
        np.asarray(scene["typeid"]) != list(scene["types"]).index("L"),
        device=device)
    w = torch.where(mol, mass, 0.0)[:, None]
    drift = (w * v).sum(-2, keepdim=True) / w.sum()
    return torch.where(mol[:, None], v - drift, v)
