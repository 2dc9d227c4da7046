"""Ewald electrostatics: splitting parameter, self and exclusion corrections,
and the exact k-space sum (the correctness oracle for the PPPM mesh).

Port of ``cavmd_tpu/ops/ewald.py``. Total Coulomb energy of a neutral
periodic system::

    E = E_real + E_kspace - E_self - E_excluded

with the real-space part in the dense pair pass (``ops/lj.py``; on its
own, ``ewald_real_space`` and ``ewald_real_space_pair``), the k-space
part on the PPPM mesh (``ops/pppm.py``), ``E_self = kappa/sqrt(pi)
sum q^2`` and ``E_excl = sum_bonds q_i q_j erf(kappa r)/r``. The
splitting parameter kappa comes from ``auto_kappa`` (erfc(kappa r_cut)
at a set accuracy) or ``auto_kappa_error_estimate`` (the Kolafa-Perram
estimate, HOOMD's choice). The
exclusion corrections take a leading replica axis, (B, N, 3) positions
with shared charges and bonds, and give (B,) energies; the self energy
depends on the charges only and is one number for every replica (a
replica's own (B, N) charges, as a batch over slabs holds them, give one
a replica).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cavmd_tpu_torch.core.box import minimum_image
from cavmd_tpu_torch.ops.lj import fused_pair_terms


def auto_kappa(r_cut, accuracy=1e-6):
    """kappa with erfc(kappa * r_cut) ~ accuracy (host-side bisection)."""
    lo, hi = 0.0, 30.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if math.erfc(mid) > accuracy:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi) / float(r_cut)


def real_space_rms_error(kappa, charge, box_L, r_cut):
    """Kolafa-Perram RMS real-space force error (host NumPy):
    2 Q^2 / sqrt(N r_cut V) exp(-kappa^2 r_cut^2) with Q^2 = sum q_i^2
    (Kolafa and Perram 1992, eq. 18), the estimate HOOMD's PPPM setup
    solves for kappa when it is given alpha = 0."""
    q = np.asarray(charge, np.float64)
    n = max(len(q), 1)
    v = float(np.prod(np.asarray(box_L, np.float64)))
    q2 = float(np.sum(q * q))
    return (2.0 * q2 / math.sqrt(n * float(r_cut) * v)
            * math.exp(-(kappa * float(r_cut)) ** 2))


def auto_kappa_error_estimate(charge, box_L, r_cut, accuracy=1e-4):
    """kappa from the Kolafa-Perram estimate (host NumPy bisection):
    ``real_space_rms_error(kappa) = accuracy max|q|^2 / r_cut^2``, the
    absolute error normalised by the system's force scale; past
    30 / r_cut (the target out of reach inside the cutoff) that bound is
    returned. An uncharged system falls back to :func:`auto_kappa`."""
    q = np.asarray(charge, np.float64)
    if not np.any(q != 0.0):
        return auto_kappa(r_cut)
    target = accuracy * float(np.max(np.abs(q))) ** 2 / float(r_cut) ** 2
    lo, hi = 1e-6, 30.0 / float(r_cut)
    if real_space_rms_error(hi, q, box_L, r_cut) > target:
        return hi
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if real_space_rms_error(mid, q, box_L, r_cut) > target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def ewald_real_space(position, box_L, charge, kappa, r_cut,
                     exclusion_mask=None):
    """Real-space (short-range) Ewald pair force and energy over all pairs
    within ``r_cut``, with the true ``erfc``; pairs of zero charge product
    and those of ``exclusion_mask`` (N, N) bool (tensor or NumPy; True
    where excluded) are skipped. Returns (forces (N, 3), energy)."""
    qq = charge[:, None] * charge[None, :]
    active = ~torch.eye(charge.shape[0], dtype=torch.bool,
                        device=charge.device) & (qq != 0)
    if exclusion_mask is not None:
        active = active & ~torch.as_tensor(exclusion_mask,
                                           device=charge.device)
    return ewald_real_space_pair(position, box_L, qq, active, kappa, r_cut)


def ewald_real_space_pair(position, box_L, qq, active_static, kappa, r_cut):
    """Real-space Ewald from precomputed (N, N) charge products and static
    active mask: the Coulomb half of ``ops/lj.py:fused_pair_terms`` (the
    LJ half off). Returns (forces (..., N, 3), energy)."""
    zero = position.new_zeros(())
    off = torch.zeros((), dtype=torch.bool, device=position.device)
    forces, _, energy = fused_pair_terms(
        position, box_L, zero, zero, zero, zero, off, qq, active_static,
        kappa, r_cut * r_cut)
    return forces, energy


def ewald_self_energy(charge, kappa):
    """Self-interaction correction kappa/sqrt(pi) * sum q_i^2 (subtracted):
    0-d for (N,) charges, (B,) for a row a replica."""
    kappa = torch.as_tensor(kappa, dtype=charge.dtype, device=charge.device)
    return kappa / math.sqrt(math.pi) * torch.sum(charge * charge, dim=-1)


def _excl_pair_terms(dr, qq, kappa):
    """Per-bond exclusion terms: force on endpoint i (``fmag * dr``) and the
    energy, given min-imaged ``dr = r_i - r_j`` (..., Nb, 3) and ``qq``
    (Nb,)."""
    kappa = torch.as_tensor(kappa, dtype=dr.dtype, device=dr.device)
    r2 = torch.sum(dr * dr, dim=-1)
    r = torch.sqrt(r2)
    safe_r = torch.where(r > 0, r, torch.ones_like(r))
    safe_r2 = torch.where(r2 > 0, r2, torch.ones_like(r2))
    erf_term = 1.0 - torch.special.erfc(kappa * r)
    energy = torch.sum(qq * erf_term / safe_r, dim=-1)
    two_over_sqrt_pi = 2.0 / math.sqrt(math.pi)
    fmag = qq * (
        erf_term / safe_r2
        - kappa * two_over_sqrt_pi * torch.exp(-(kappa * r) ** 2) / safe_r
    ) / safe_r
    return fmag[..., None] * dr, energy


def ewald_exclusion_correction(position, box_L, charge, kappa, bond_group):
    """Reciprocal-space contribution of the bonded pairs, for any bond
    table (scatter path). Returns (forces, energy) to be SUBTRACTED."""
    if bond_group.shape[0] == 0:
        return (torch.zeros_like(position),
                position.new_zeros(position.shape[:-2]))
    i = bond_group[:, 0].long()
    j = bond_group[:, 1].long()
    dr = minimum_image(position[..., i, :] - position[..., j, :], box_L)
    f_i, energy = _excl_pair_terms(dr, charge[i] * charge[j], kappa)
    forces = torch.zeros_like(position)
    forces.index_add_(-2, i, f_i)
    forces.index_add_(-2, j, -f_i)
    return forces, energy


def ewald_exclusion_correction_strided(position, box_L, charge, kappa,
                                       n_bonds: int):
    """Exclusion correction for bond b = particles (2b, 2b+1): reshape
    views, no gathers. Returns (forces, energy) to be SUBTRACTED."""
    batch = tuple(position.shape[:-2])
    pp = position[..., :2 * n_bonds, :].reshape(batch + (n_bonds, 2, 3))
    qq_b = charge[:2 * n_bonds].reshape(n_bonds, 2).prod(dim=1)
    dr = minimum_image(pp[..., 0, :] - pp[..., 1, :], box_L)
    f_i, energy = _excl_pair_terms(dr, qq_b, kappa)
    forces = torch.zeros_like(position)
    forces[..., :2 * n_bonds, :] = torch.stack([f_i, -f_i], dim=-2).reshape(
        batch + (2 * n_bonds, 3))
    return forces, energy


def kspace_vectors(box_L, nmax, dtype=torch.float64, device=None):
    """Reciprocal lattice vectors 2 pi n / L for n in [-nmax, nmax]^3, n != 0."""
    ns = np.arange(-nmax, nmax + 1)
    grid = np.stack(np.meshgrid(ns, ns, ns, indexing="ij"), -1).reshape(-1, 3)
    grid = grid[np.any(grid != 0, axis=1)]
    box_np = np.asarray(box_L.cpu() if isinstance(box_L, torch.Tensor)
                        else box_L, dtype=float)
    return torch.as_tensor(2.0 * np.pi * grid / box_np[None, :], dtype=dtype,
                           device=device)


def ewald_kspace_exact(position, charge, box_L, kappa, nmax=12):
    """Exact reciprocal-space Ewald sum (oracle for PPPM; O(N * nk)).

    Returns (forces (N, 3), energy); self/exclusion corrections excluded.
    """
    dtype = position.dtype
    kvecs = kspace_vectors(box_L, nmax, dtype, position.device)
    volume = torch.prod(box_L.to(dtype))
    kappa = torch.as_tensor(kappa, dtype=dtype, device=position.device)

    kr = position @ kvecs.T
    cos_kr = torch.cos(kr)
    sin_kr = torch.sin(kr)
    rho_re = charge @ cos_kr
    rho_im = charge @ sin_kr

    k2 = torch.sum(kvecs * kvecs, dim=1)
    green = torch.exp(-k2 / (4.0 * kappa * kappa)) / k2
    pref = 2.0 * math.pi / volume
    energy = pref * torch.sum(green * (rho_re**2 + rho_im**2))

    coef = 2.0 * pref * green
    site = sin_kr * rho_re[None, :] - cos_kr * rho_im[None, :]
    forces = charge[:, None] * ((coef[None, :] * site) @ kvecs)
    return forces, energy


def coulomb_direct_reference(position, box_L, charge, bond_group=None,
                             nmax_real=2):
    """Brute-force Coulomb energy over periodic images (slow; tests only):
    1/r summed over the real-space images out to ``nmax_real`` boxes, the
    bonded pairs of ``bond_group`` skipped in the home box. It shares no
    maths with the Ewald split, and converges poorly in general but well
    enough for small, well-separated test scenes. Takes tensors or NumPy;
    returns a Python float."""
    def host(x):
        return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                          else x)

    pos, q, L = host(position), host(charge), host(box_L)
    n = len(q)
    excluded = set()
    if bond_group is not None:
        for a, b in host(bond_group):
            excluded.add((int(a), int(b)))
            excluded.add((int(b), int(a)))
    e = 0.0
    shifts = [
        np.array([ix, iy, iz]) * L
        for ix in range(-nmax_real, nmax_real + 1)
        for iy in range(-nmax_real, nmax_real + 1)
        for iz in range(-nmax_real, nmax_real + 1)
    ]
    for i in range(n):
        for j in range(n):
            for s in shifts:
                if i == j and not s.any():
                    continue
                if (i, j) in excluded and not s.any():
                    continue
                r = np.linalg.norm(pos[i] - pos[j] + s)
                e += 0.5 * q[i] * q[j] / r
    return e
