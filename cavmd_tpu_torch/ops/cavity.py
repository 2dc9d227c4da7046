"""Cavity-QED light-matter force: H = 1/2 K q^2 + g (q.d) + (g^2/2K) d^2.

Port of ``cavmd_tpu/ops/cavity.py`` (reference
``src/CavityForceCompute.cc:131-208``):

- the photon is the unique particle of type ``'L'``;
- ``d = sum_i q_i r_i^unwrapped`` over the non-photon particles;
- only the x, y components of the photon coordinate and of the dipole
  couple; the harmonic term uses the full 3-D photon coordinate;
- molecular force ``F_i = -g q_i (q_xy + (g/K) d_xy)`` with z zero, photon
  force ``F_L = -K q - g d_xy``.

Everything stays on the device: one dipole reduction, no host sync. A
replica batch, positions (B, N, 3) with shared charges and types, has a
dipole and a photon coordinate per replica and (B,) energies.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cavmd_tpu_torch.core.box import unwrap_positions


class CavityParams(NamedTuple):
    """Parameters of the single cavity mode (0-d tensors);
    ``K = phmass * omegac**2``."""

    omegac: torch.Tensor
    couplstr: torch.Tensor
    phmass: torch.Tensor

    @property
    def K(self):
        return self.phmass * self.omegac**2

    @staticmethod
    def create(omegac, couplstr, phmass=1.0, dtype=torch.float64, device=None):
        def t(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        return CavityParams(t(omegac), t(couplstr), t(phmass))


def molecular_dipole(position, image, box_L, charge, photon_mask):
    """Global molecular dipole ``d = sum_i q_i r_i^unwrapped`` with the
    photon excluded: (3,), or (B, 3) for a replica batch (positions and
    images (B, N, 3), ``box_L`` (3,) or (B, 3), charges and the mask (N,)
    or (B, N))."""
    L = box_L[..., None, :] if box_L.dim() > 1 else box_L
    unwrapped = unwrap_positions(position, image, L)
    w = torch.where(photon_mask, position.new_zeros(()), charge)
    return torch.sum(w[..., None] * unwrapped, dim=-2)


def cavity_force(position, image, box_L, charge, typeid, l_typeid, params):
    """Cavity forces and the three energy components.

    Returns (forces (..., N, 3), dict with 'harmonic', 'coupling',
    'dipole_self'). With no photon in ``typeid``, forces and energies are
    zero.
    """
    dtype = position.dtype
    zero = position.new_zeros(())
    photon_mask = typeid == l_typeid
    has_photon = torch.any(photon_mask)

    unwrapped = unwrap_positions(position, image, box_L)
    w = torch.where(photon_mask, zero, charge)
    dipole = torch.sum(w[:, None] * unwrapped, dim=-2)
    q_photon = torch.sum(
        torch.where(photon_mask[:, None], unwrapped, zero), dim=-2)

    # built on the device (a host list would cost a host-to-device copy
    # every step)
    xy = (torch.arange(3, device=position.device) < 2).to(dtype)
    q_xy = q_photon * xy
    d_xy = dipole * xy

    K = params.K.to(dtype)
    g = params.couplstr.to(dtype)

    def dot(a, b):
        return torch.sum(a * b, dim=-1)

    e_harm = 0.5 * K * dot(q_photon, q_photon)
    e_coup = g * dot(d_xy, q_xy)
    e_self = 0.5 * (g * g / K) * dot(d_xy, d_xy)

    Dq = q_xy + (g / K) * d_xy
    f_mol = (-g * charge)[:, None] * Dq[..., None, :] * xy
    f_photon = -K * q_photon - g * d_xy

    forces = torch.where(photon_mask[:, None], f_photon[..., None, :], f_mol)
    forces = torch.where(has_photon, forces, torch.zeros_like(forces))
    energies = {
        "harmonic": torch.where(has_photon, e_harm, zero),
        "coupling": torch.where(has_photon, e_coup, zero),
        "dipole_self": torch.where(has_photon, e_self, zero),
    }
    return forces, energies


def cavity_total_energy(energies):
    """Total cavity energy = harmonic + coupling + dipole self-energy (the
    reference wrapper's ``.energy`` override, ``src/cavitymd/forces.py:
    209-212``, which sums the components instead of per-particle PE)."""
    return (energies["harmonic"] + energies["coupling"]
            + energies["dipole_self"])
