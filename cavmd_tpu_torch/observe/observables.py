"""Observable library: on-device observable functions.

Port of ``cavmd_tpu/observe/observables.py``: total dipole moment, density
field rho(k) and its autocorrelation, Fibonacci k-shell sampling and the
cavity-mode properties.
They run inside the step; the host receives only the small per-step result
columns, once per chunk. Positions may carry a leading replica axis
(B, N, 3): the dipole is then (B, 3) and rho(k) (B, nk).
"""

from __future__ import annotations

import numpy as np
import torch

from cavmd_tpu_torch.core.box import unwrap_positions
from cavmd_tpu_torch.core.units import PhysicalConstants


def compute_total_dipole_moment(position, image, box_L, charge):
    """Total dipole sum_i q_i r_i with unwrapped positions."""
    return charge @ unwrap_positions(position, image, box_L)


def compute_density_field(position, wavevectors):
    """rho(k) = sum_j exp(i k . r_j) per wavevector, from the *wrapped*
    positions. Returns (cos part, sin part), each (nk,): the real and
    imaginary parts of the JAX package's complex result."""
    kr = position @ wavevectors.T  # (..., N, nk)
    return torch.sum(torch.cos(kr), dim=-2), torch.sum(torch.sin(kr), dim=-2)


def generate_fibonacci_sphere(samples: int = 100) -> np.ndarray:
    """Uniform points on the unit sphere via the Fibonacci spiral
    (host-side; the result is a constant)."""
    i = np.arange(samples, dtype=float)
    phi = np.pi * (3.0 - np.sqrt(5.0))  # golden angle
    y = 1.0 - (i / (samples - 1)) * 2.0
    radius = np.sqrt(1.0 - y * y)
    theta = phi * i
    return np.stack([np.cos(theta) * radius, y, np.sin(theta) * radius],
                    axis=1)


def field_autocorrelation(field0, field_t):
    """mean(Re(F0 conj(Ft))) over the k-shell, for complex tensors (or
    NumPy arrays) ``field0`` and ``field_t`` (analysis.py:359-364)."""
    f0, ft = torch.as_tensor(field0), torch.as_tensor(field_t)
    return torch.mean(torch.real(f0 * torch.conj(ft)))


def cavity_mode_properties(ke_cavity, cavity_harmonic_energy):
    """(kinetic, potential, total, temperature) of the photon mode: the
    potential is the harmonic cavity energy only; T = (2/3) KE / k_B."""
    total = ke_cavity + cavity_harmonic_energy
    temperature = (2.0 / 3.0) * ke_cavity / PhysicalConstants.KB_HARTREE_PER_K
    return ke_cavity, cavity_harmonic_energy, total, temperature


def kinetic_temperature(kinetic_energy, n_dof):
    """T = 2 KE / (N_dof k_B)."""
    return 2.0 * kinetic_energy / (n_dof * PhysicalConstants.KB_HARTREE_PER_K)


def make_extra_obs(*, dipole: bool = False,
                   wavevectors: np.ndarray | None = None):
    """Build an ``extra_obs(state) -> dict`` hook for the step function.

    The per-step entries stream to the host with the energy audit:
    - 'dipole': (3,) total dipole (for DipoleAutocorrelation);
    - 'rho_k_re'/'rho_k_im': (nk,) density field (for F(k,t));
    with a leading replica axis (B, ...) in a replica batch.

    The callable carries its spec as attributes (``.dipole``,
    ``.wavevectors``), as in the JAX package. The wavevectors become a
    tensor of the state's type on its device at the first call.
    """
    wv = None if wavevectors is None else np.asarray(wavevectors)
    cache = {}

    def extra(state):
        out = {}
        if dipole:
            out["dipole"] = compute_total_dipole_moment(
                state.position, state.image, state.box_L, state.charge)
        if wv is not None:
            key = (state.position.dtype, state.device)
            if key not in cache:
                cache[key] = torch.as_tensor(wv, dtype=key[0],
                                             device=key[1])
            out["rho_k_re"], out["rho_k_im"] = compute_density_field(
                state.position, cache[key])
        return out

    extra.dipole = dipole
    extra.wavevectors = wv
    return extra
