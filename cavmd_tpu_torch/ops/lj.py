"""Shifted Lennard-Jones + short-range Ewald dense pair pass.

Port of ``cavmd_tpu/ops/lj.py``. ``V(r) = 4 eps [(s/r)^12 - (s/r)^6] -
V(r_cut)`` for ``r < r_cut`` (HOOMD shift mode), half-counted per ordered
pair; the photon's ('L', *) pairs carry epsilon 0 and r_cut 0, which
disables them.

The plain functions here are the reference semantics of the dense pair
kernel (``ops/pair_kernels.py``): ``fused_pair_terms`` is the shared pair
math, evaluated on (N, N) parameter matrices. ``lj_dense`` (type tables)
and ``lj_dense_pair`` (``LJPairMatrices``) are its LJ half alone, and
``ops/ewald.py``'s real-space functions its Coulomb half; like the JAX
package's, they run outside any kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def lj_pair_tables(types, lj_params, default_rcut=0.0, dtype=torch.float64,
                   device=None):
    """(T, T) epsilon / sigma / r_cut tables from a {(a, b): dict} mapping.

    Entries may be given as ('O', 'N') or ('N', 'O'); missing pairs default
    to epsilon 0 and r_cut 0 (interaction disabled).
    """
    t = len(types)
    eps = np.zeros((t, t))
    sig = np.ones((t, t))
    rcut = np.full((t, t), default_rcut)
    for (a, b), p in lj_params.items():
        ia, ib = types.index(a), types.index(b)
        eps[ia, ib] = eps[ib, ia] = p["epsilon"]
        sig[ia, ib] = sig[ib, ia] = p["sigma"]
        rc = p.get("r_cut", default_rcut)
        rcut[ia, ib] = rcut[ib, ia] = rc
    return tuple(torch.as_tensor(x, dtype=dtype, device=device)
                 for x in (eps, sig, rcut))


def lj_kernel_tables(eps_table, sigma_table, rcut_table):
    """(T, T) NumPy tables (eps, sigma^2, r_cut^2, v_shift) — the
    per-type-pair constants of the pair pass, formed host-side in the
    tables' own precision exactly as ``cavmd_tpu.ops.lj.LJPairMatrices``
    forms them (so float32 tables round the same way in both packages)."""
    eps_t, sig_t, rc_t = (
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in (eps_table, sigma_table, rcut_table))
    rc_safe = np.where(rc_t > 0, rc_t, 1.0)
    src6 = (sig_t / rc_safe) ** 6
    vshift_t = 4.0 * eps_t * (src6 * src6 - src6)
    return eps_t, sig_t * sig_t, rc_t * rc_t, vshift_t


def lj_active_mask(typeid, eps_table, rcut_table, exclusion_mask=None):
    """(N, N) bool NumPy mask of LJ-enabled pairs: type pair on, not self,
    not excluded (the static part of the LJ predicate)."""
    tid = np.asarray(typeid)
    eps = np.asarray(eps_table)[tid[:, None], tid[None, :]]
    rc = np.asarray(rcut_table)[tid[:, None], tid[None, :]]
    active = (~np.eye(len(tid), dtype=bool)) & (eps != 0) & (rc > 0)
    if exclusion_mask is not None:
        active &= ~np.asarray(exclusion_mask)
    return active


class LJPairMatrices:
    """Rank-T per-pair parameters: (N, T) row gathers and the (N, T)
    one-hot of typeid, so ``X[i, j] = sum_t rows_X[i, t] * oh[j, t]``.

    Same container as the JAX package's; the port's kernel path uses the
    (T, T) tables directly (``lj_kernel_tables``).
    """

    def __init__(self, rows_eps, rows_sig2, rows_rcut2, rows_vshift, oh,
                 active):
        self.rows_eps = rows_eps
        self.rows_sig2 = rows_sig2
        self.rows_rcut2 = rows_rcut2
        self.rows_vshift = rows_vshift
        self.oh = oh
        self.active = active

    def virtual(self):
        """The four (N, N) parameter matrices (eps, sig2, rcut2, vshift)."""
        return tuple(rows @ self.oh.T for rows in (
            self.rows_eps, self.rows_sig2, self.rows_rcut2, self.rows_vshift))

    @staticmethod
    def create(typeid, eps_table, sigma_table, rcut_table,
               exclusion_mask=None, dtype=torch.float64, device=None):
        tid = np.asarray(typeid.cpu() if isinstance(typeid, torch.Tensor)
                         else typeid)
        tables = lj_kernel_tables(eps_table, sigma_table, rcut_table)
        T = tables[0].shape[0]
        oh = (tid[:, None] == np.arange(T)[None, :])

        def t(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        active = lj_active_mask(tid, tables[0], tables[2], exclusion_mask)
        return LJPairMatrices(
            *(t(x[tid]) for x in tables), oh=t(oh),
            active=torch.as_tensor(active, device=device),
        )


def bond_exclusion_mask(n, bond_group):
    """Dense (N, N) bool NumPy mask of bonded pairs."""
    mask = np.zeros((n, n), dtype=bool)
    bg = np.asarray(bond_group.cpu() if isinstance(bond_group, torch.Tensor)
                    else bond_group)
    if bg.shape[0]:
        mask[bg[:, 0], bg[:, 1]] = True
        mask[bg[:, 1], bg[:, 0]] = True
    return mask


def fused_pair_terms(position, box_L, eps, sig2, rcut2, vshift, lj_active,
                     qq, coulomb_active, kappa, coulomb_rc2, rows=None):
    """Dense LJ + erfc-Coulomb pair pass on (N, N) parameter matrices.

    ``lj_active`` / ``coulomb_active`` are the static (N, N) masks; the
    cutoff tests are applied here. Masked pairs contribute exactly zero.
    ``position`` is (N, 3) or a replica batch (..., N, 3) sharing the
    parameter matrices and masks. Returns (forces (..., N, 3), e_lj,
    e_ewald_short), the energies of the leading shape. ``rows`` (a slice
    of the i rows): the matrices and masks are (M, N), those rows', and
    so are the forces (..., M, 3); the energies are the rows' share.
    """
    dtype = position.dtype
    zero = position.new_zeros(())
    one = position.new_ones(())
    box = box_L.to(dtype)

    dxs = []
    r2 = None
    own = slice(None) if rows is None else rows
    for d in range(3):
        x = position[..., d]
        dx = x[..., own, None] - x[..., None, :]
        dx = dx - box[d] * torch.round(dx / box[d])
        dxs.append(dx)
        r2 = dx * dx if r2 is None else r2 + dx * dx

    lj_on = lj_active & (r2 < rcut2)
    r2_lj = torch.where(lj_on, r2, one)
    inv_r2 = sig2 / r2_lj
    s6 = inv_r2 * inv_r2 * inv_r2
    s12 = s6 * s6
    pairs = (-2, -1)
    e_lj = 0.5 * torch.sum(
        torch.where(lj_on, 4.0 * eps * (s12 - s6) - vshift, zero), dim=pairs)
    f_lj = torch.where(lj_on, 24.0 * eps * (2.0 * s12 - s6) / r2_lj, zero)

    # a host number stays one: no host-to-device copy
    kappa = kappa.to(dtype) if torch.is_tensor(kappa) else float(kappa)
    ew_on = coulomb_active & (r2 < coulomb_rc2)
    r2_ew = torch.where(ew_on, r2, one)
    r = torch.sqrt(r2_ew)
    ec = torch.special.erfc(kappa * r)
    e_ew = 0.5 * torch.sum(torch.where(ew_on, qq * ec / r, zero), dim=pairs)
    two_over_sqrt_pi = 2.0 / math.sqrt(math.pi)
    f_ew = torch.where(
        ew_on,
        qq * (ec / r2_ew + kappa * two_over_sqrt_pi
              * torch.exp(-(kappa * r) ** 2) / r) / r,
        zero,
    )

    f_total = f_lj + f_ew
    forces = torch.stack(
        [torch.sum(f_total * dxs[d], dim=-1) for d in range(3)], dim=-1)
    return forces, e_lj, e_ew


def lj_dense(position, box_L, typeid, eps_table, sigma_table, rcut_table,
             exclusion_mask=None):
    """All-pairs shifted LJ forces and energy from (T, T) type tables;
    ``exclusion_mask`` (N, N) bool (tensor or NumPy) is True where a pair
    is excluded. Returns (forces (N, 3), energy)."""
    tid = typeid.long()
    eps = eps_table[tid[:, None], tid[None, :]]
    sig = sigma_table[tid[:, None], tid[None, :]]
    rc = rcut_table[tid[:, None], tid[None, :]]
    active = ~torch.eye(len(tid), dtype=torch.bool, device=eps.device)
    active = active & (eps != 0)
    if exclusion_mask is not None:
        active = active & ~torch.as_tensor(exclusion_mask, device=eps.device)
    src6 = (sig / torch.where(rc > 0, rc, torch.ones_like(rc))) ** 6
    vshift = 4.0 * eps * (src6 * src6 - src6)
    return _lj_terms(position, box_L, eps, sig * sig, rc * rc, vshift, active)


def lj_dense_pair(position, box_L, pair: LJPairMatrices):
    """All-pairs shifted LJ with precomputed pair matrices. Returns
    (forces (..., N, 3), energy)."""
    return _lj_terms(position, box_L, *pair.virtual(), pair.active)


def _lj_terms(position, box_L, eps, sig2, rcut2, vshift, active):
    """The LJ half of ``fused_pair_terms`` (the Coulomb half off):
    (forces, energy)."""
    off = torch.zeros((), dtype=torch.bool, device=position.device)
    forces, e_lj, _ = fused_pair_terms(position, box_L, eps, sig2, rcut2,
                                       vshift, active, 0.0, off, 0.0, 0.0)
    return forces, e_lj


def fused_pair_force(position, box_L, pair: LJPairMatrices, qq,
                     coulomb_active, kappa, coulomb_rcut):
    """Fused dense LJ + short-range-Ewald pass (port of
    ``cavmd_tpu.ops.lj.fused_pair_force``). Returns (forces, e_lj, e_ew)."""
    eps, sig2, rcut2, vshift = pair.virtual()
    return fused_pair_terms(position, box_L, eps, sig2, rcut2, vshift,
                            pair.active, qq, coulomb_active, kappa,
                            coulomb_rcut * coulomb_rcut)
