"""Harmonic bond force: V = 1/2 k (r - r0)^2 per bond.

Port of ``cavmd_tpu/ops/bonds.py``: the strided path for consecutive-pair
topology (bond b = particles (2b, 2b+1), the reference scene's layout) and
the general scatter path (``index_add_``) for any bond table. Minimum-image
displacements, so bonds work across the periodic boundary. Positions may
carry a leading replica axis, (B, N, 3), with one shared bond table: the
energies then come back (B,).
"""

from __future__ import annotations

import numpy as np
import torch

from cavmd_tpu_torch.core.box import minimum_image


def _bond_terms(dr, kb, rb):
    """Force on endpoint j and the total energy, given displacements
    ``dr = r_j - r_i`` (..., Nb, 3) and per-bond parameters (Nb,)."""
    r = torch.sqrt(torch.sum(dr * dr, dim=-1))
    safe_r = torch.where(r > 0, r, torch.ones_like(r))
    fmag = -kb * (r - rb) / safe_r
    return fmag[..., None] * dr, torch.sum(0.5 * kb * (r - rb) ** 2, dim=-1)


def harmonic_bond_force_strided(position, box_L, n_bonds: int, kb, rb):
    """Harmonic bonds for bond b = (2b, 2b+1): endpoint access and force
    accumulation are reshape views. ``kb``/``rb`` are per-bond (Nb,).
    Returns (forces (..., N, 3), energy)."""
    batch = tuple(position.shape[:-2])
    pp = position[..., :2 * n_bonds, :].reshape(batch + (n_bonds, 2, 3))
    dr = minimum_image(pp[..., 1, :] - pp[..., 0, :], box_L)
    f_j, energy = _bond_terms(dr, kb, rb)
    forces = torch.zeros_like(position)
    forces[..., :2 * n_bonds, :] = torch.stack([-f_j, f_j], dim=-2).reshape(
        batch + (2 * n_bonds, 3))
    return forces, energy


def harmonic_bond_force(position, box_L, bond_group, bond_typeid, k, r0):
    """Harmonic bonds for any (Nb, 2) bond table (scatter path).

    ``k``/``r0`` are per-type (n_bond_types,) tables.
    Returns (forces (..., N, 3), energy).
    """
    if bond_group.shape[0] == 0:
        return (torch.zeros_like(position),
                position.new_zeros(position.shape[:-2]))
    i = bond_group[:, 0].long()
    j = bond_group[:, 1].long()
    dr = minimum_image(position[..., j, :] - position[..., i, :], box_L)
    tid = bond_typeid.long()
    f_j, energy = _bond_terms(dr, k[tid], r0[tid])
    forces = torch.zeros_like(position)
    forces.index_add_(-2, j, f_j)
    forces.index_add_(-2, i, -f_j)
    return forces, energy


def bonds_are_consecutive(bond_group) -> bool:
    """True iff bond b connects particles (2b, 2b+1) for every b
    (host-side topology check at setup)."""
    bg = np.asarray(bond_group.cpu() if isinstance(bond_group, torch.Tensor)
                    else bond_group)
    nb = bg.shape[0]
    if nb == 0:
        return False
    return bool(np.array_equal(bg, np.arange(2 * nb).reshape(nb, 2)))
