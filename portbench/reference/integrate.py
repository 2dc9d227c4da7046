"""Plain PyTorch reference of the step: velocity Verlet with a Bussi
(stochastic velocity rescaling) bath on the molecules and an exact
Ornstein-Uhlenbeck Langevin bath on the photon, written from the
published schemes (Bussi, Donadio and Parrinello 2007, with the sign
rule of Bussi and Parrinello 2009, eq. A8; the chi-square draw by the
Wilson-Hilferty transform above a shape of 30).

A step: rescale the molecular velocities by alpha (the bath takes
K (1 - alpha^2)); kick by half a step; drift and wrap into the box; new
forces; kick by half a step; the photon's OU update (the bath takes the
kinetic energy it loses).

The noise is a draw source handed in: ``bussi(R)`` gives (r1, xi) of
shape (R,), ``langevin(R)`` the (R, 1, 3) photon draws.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.physics import Forces, Topology


class Bath:
    """The two baths' constants in atomic units."""

    def __init__(self, cfg: dict, top: Topology):
        phys, units = cfg["physics"], cfg["units"]
        to_au = 1.0 / float(units["ps_per_au"])
        self.dt = float(phys["dt_fs"]) * 1e-3 * to_au
        self.kT = float(units["kB_hartree_per_K"]) * float(
            phys["temperature_K"])
        self.tau = float(phys["bussi_tau_ps"]) * to_au
        self.gamma = 1.0 / (float(phys["langevin_tau_ps"]) * to_au)
        self.dof = 3.0 * float(top.mol.sum())


def kinetic(v, mass, mask):
    return 0.5 * torch.sum(torch.where(mask[:, None], mass[:, None] * v * v,
                                       0.0), dim=(-2, -1))


def bussi_alpha(K, bath: Bath, r1, xi):
    """The rescaling factor of a group of kinetic energy K (R,)."""
    dof, dt, kT = bath.dof, bath.dt, bath.kT
    shape = (dof - 1.0) / 2.0
    if shape > 30.0:
        cube = 1.0 - 1.0 / (9.0 * shape) + xi / math.sqrt(9.0 * shape)
        r_gamma = 2.0 * shape * torch.clamp_min(cube, 0.0) ** 3
    else:
        raise ValueError("the reference draws the chi-square by "
                         "Wilson-Hilferty only (a group of > 61 DOF)")
    c = math.exp(-dt / bath.tau)
    v = kT / 2.0 / K
    a2 = c + v * (1.0 - c) * (r_gamma + r1 * r1) \
        + 2.0 * r1 * torch.sqrt(v * (1.0 - c) * c)
    mag = torch.sqrt(a2)
    k_bar = kT * dof / 2.0
    sign = r1 + torch.sqrt(c * dof * K / ((1.0 - c) * k_bar))
    return torch.where(sign >= 0.0, mag, -mag)


def follow(top: Topology, forces: Forces, bath: Bath, pos, img, vel,
           reservoirs, noise, n_steps: int):
    """``n_steps`` steps of the replicas (R, N, 3) from (pos, img, vel)
    and the reservoirs {'bussi', 'langevin'} (R,). Returns the final
    (pos, img, vel, forces), the last step's energies, kinetic energies
    and reservoirs (a dict of (R,) tensors)."""
    m = top.mass
    box = top.box
    mol = top.mol
    ph = top.photon
    dt = bath.dt
    R = pos.shape[0]
    f, e = forces(pos, img)
    res_b = reservoirs["bussi"].clone()
    res_l = reservoirs["langevin"].clone()
    c_ou = math.exp(-bath.gamma * dt)
    sig_ou = math.sqrt((1.0 - c_ou * c_ou) * bath.kT / float(m[ph]))
    for _ in range(n_steps):
        r1, xi = noise.bussi(R)
        K = kinetic(vel, m, mol)
        alpha = bussi_alpha(K, bath, r1.to(pos.dtype), xi.to(pos.dtype))
        vel = torch.where(mol[:, None], alpha[:, None, None] * vel, vel)
        res_b = res_b + K * (1.0 - alpha * alpha)
        vel = vel + 0.5 * dt * f / m[:, None]
        pos = pos + dt * vel
        shift = torch.floor((pos + 0.5 * box) / box)
        pos = pos - shift * box
        img = img + shift.to(img.dtype)
        f, e = forces(pos, img)
        vel = vel + 0.5 * dt * f / m[:, None]
        draw = noise.langevin(R).to(pos.dtype)[:, 0]
        v_ph = vel[:, ph]
        new_ph = c_ou * v_ph + sig_ou * draw
        res_l = res_l + 0.5 * float(m[ph]) * (
            (v_ph * v_ph).sum(-1) - (new_ph * new_ph).sum(-1))
        vel = vel.clone()
        vel[:, ph] = new_ph
    obs = dict(e)
    obs["kinetic_molecular"] = kinetic(vel, m, mol)
    obs["kinetic_cavity"] = kinetic(vel, m, ~mol)
    obs["bussi_reservoir_molecular"] = res_b
    obs["langevin_reservoir_cavity"] = res_l
    return pos, img, vel, f, obs
