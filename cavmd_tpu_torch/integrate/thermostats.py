"""Thermostats: Bussi (with reservoir tally), exact-OU Langevin, Brownian,
MTTK (Nose-Hoover) and Berendsen.

Port of ``cavmd_tpu/integrate/thermostats.py``:

- Bussi stochastic velocity rescaling with the Bussi 2009 Eq. A8 sign
  correction (``sign_correction=False``: plain HOOMD Bussi) and the
  exact reservoir tally ``dE_res = KE (1 - alpha^2)`` (reference
  ``src/BussiReservoirThermostat.h:43-225``);
- Langevin as the exact Ornstein-Uhlenbeck velocity update (the BAOAB "O"
  step) with the exact kinetic-energy tally;
- Brownian (overdamped Euler-Maruyama) with the exact tally of its
  velocity resample;
- the MTTK (Nose-Hoover) internal degrees of freedom (xi, eta): the
  velocity factor exp(-xi dt/2), their advance from the group temperature,
  their energy and their random initial xi (reference
  ``Thermostat.h:139-323``);
- the Berendsen factor lambda from the group temperature
  (``Thermostat.h:469-489``);
- Maxwell-Boltzmann thermalization.

The random draws are separate from the updates: ``bussi_noise`` draws from
an explicit generator, and the update functions take the draws as tensors,
so tests can inject the JAX package's noise.

Velocities may carry a leading replica axis, (B, N, 3), with shared masses
and masks: kinetic energies, Bussi factors and reservoir deltas are then
(B,), and ``dt`` and the draws are per replica ((B,), (B, ..., 3)). The
MTTK and Berendsen functions are elementwise, so (xi, eta), T and dt may be
0-d or (B,) alike.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def kinetic_energy(velocity, mass, mask):
    """Group kinetic energy 1/2 sum m v^2 over ``mask``: 0-d for (N, 3)
    velocities, (B,) for a replica batch, whose masses and mask are shared
    (N,) or a replica's own (B, N) (a batch over slabs)."""
    w = torch.where(mask, mass, torch.zeros((), dtype=velocity.dtype,
                                            device=velocity.device))
    return 0.5 * torch.sum(w[..., None] * velocity**2, dim=(-2, -1))


def _per_particle(x):
    """A per-replica scalar (0-d, or (B,) in a batch) shaped to broadcast
    over (..., N, 3)."""
    return x[..., None, None]


def bussi_noise(generator, dof: float, dtype, device, batch=()):
    """The two stochastic draws of one Bussi rescaling: (r1, r_gamma),
    each of shape ``batch`` (0-d by default; (B,) for a replica batch,
    drawn in one call for all replicas).

    r1 ~ N(0, 1); r_gamma = 2 Gamma((dof - 1)/2) for dof > 1. Above a shape
    of 30 the Wilson-Hilferty transform of one more normal draw (as the JAX
    package does); below it the exact chi-square with dof - 1 degrees of
    freedom (a sum of squared normals; dof = 3 N_group is an integer).
    """
    batch = tuple(batch)
    # (2, ...): each draw's rows contiguous, and one replica's draws the
    # same stream as before
    draws = torch.randn((2,) + batch, generator=generator, dtype=dtype,
                        device=device)
    r1 = draws[0]
    if dof <= 1.0:
        return r1, torch.zeros(batch, dtype=dtype, device=device)
    alpha_g = (dof - 1.0) / 2.0
    if alpha_g > 30.0:
        xi = draws[1]
        cube = 1.0 - 1.0 / (9.0 * alpha_g) + xi / math.sqrt(9.0 * alpha_g)
        g = alpha_g * torch.clamp_min(cube, 0.0) ** 3
        return r1, 2.0 * g
    k = int(round(dof - 1.0))
    if k != dof - 1.0:
        raise ValueError(f"Bussi dof {dof} is not an integer")
    z = torch.randn(batch + (k,), generator=generator, dtype=dtype,
                    device=device)
    return r1, torch.sum(z * z, dim=-1)


def bussi_rescale_factor(K, dof: float, dt, tau: float, kT, r1, r_gamma, *,
                         sign_correction: bool = True):
    """Bussi 2007 rescaling factor alpha for group kinetic energy ``K``.

    alpha^2 = c + v(1-c)(r_gamma + r1^2) + 2 r1 sqrt(v(1-c)c), c =
    exp(-dt/tau), v = kT/(2K). With ``sign_correction`` (the default, and
    what every step path uses) the Bussi 2009 Eq. A8 sign correction:
    sign(alpha) = sign(r1 + sqrt(c Nf K / ((1-c) K_bar))), K_bar = kT Nf/2;
    without it alpha = +sqrt(alpha^2), plain HOOMD Bussi.
    ``dof``, ``tau`` and ``kT`` are host numbers (a host number meets a
    tensor at the tensor's precision and costs no host-to-device copy);
    ``K``, ``dt``, ``r1``, ``r_gamma`` are tensors.
    """
    if dof == 0:
        return torch.ones_like(K)
    c = torch.exp(-dt / tau) if tau != 0.0 else torch.zeros_like(K)
    v = kT / 2.0 / K
    term1 = v * (1.0 - c) * (r_gamma + r1 * r1)
    term2 = 2.0 * r1 * torch.sqrt(v * (1.0 - c) * c)
    alpha_mag = torch.sqrt(c + term1 + term2)
    if not sign_correction:
        return alpha_mag
    K_bar = kT * dof / 2.0
    sign_term = r1 + torch.sqrt(c * dof * K / ((1.0 - c) * K_bar))
    return torch.where(sign_term >= 0.0, alpha_mag, -alpha_mag)


def bussi_apply(velocity, mass, mask, dof: float, dt, tau: float, kT, r1,
                r_gamma, *, sign_correction: bool = True):
    """One Bussi rescaling: returns (new_velocity, reservoir_delta) with
    reservoir_delta = KE (1 - alpha^2), positive when energy flows to the
    bath. ``sign_correction`` as in ``bussi_rescale_factor``."""
    K = kinetic_energy(velocity, mass, mask)
    alpha = bussi_rescale_factor(K, dof, dt, tau, kT, r1, r_gamma,
                                 sign_correction=sign_correction)
    new_v = torch.where(mask[:, None], _per_particle(alpha) * velocity,
                        velocity)
    return new_v, K * (1.0 - alpha * alpha)


def langevin_ou_apply(velocity, mass, mask, gamma, kT, dt, noise,
                      indices=None):
    """Exact OU step v' = c v + sqrt((1 - c^2) kT/m) xi, c = exp(-gamma dt).

    ``gamma`` and ``kT`` are host numbers or tensors. ``noise`` holds the
    standard-normal draws: (..., len(indices), 3) when ``indices`` (a
    LongTensor of the group's rows, for small groups such as the single
    photon) is given, else (..., N, 3). Returns (new_velocity,
    reservoir_delta = KE_before - KE_after).
    """
    c = _per_particle(torch.exp(-gamma * dt))
    if indices is not None:
        sigma = torch.sqrt((1.0 - c * c) * kT / mass[indices][:, None])
        new_v = velocity.clone()
        new_v[..., indices, :] = c * velocity[..., indices, :] + sigma * noise
    else:
        sigma = torch.sqrt((1.0 - c * c) * kT / mass[:, None])
        new_v = torch.where(mask[:, None], c * velocity + sigma * noise,
                            velocity)
    ke_before = kinetic_energy(velocity, mass, mask)
    ke_after = kinetic_energy(new_v, mass, mask)
    return new_v, ke_before - ke_after


def brownian_apply(position, velocity, forces, mass, mask, gamma, kT, dt,
                   noise_pos, noise_vel):
    """Overdamped (Brownian / Euler-Maruyama) update for one group.

    dx = F dt / (m gamma) + sqrt(2 kT dt / (m gamma)) xi, with ``gamma``
    the friction rate (1/time), so the drag coefficient is m gamma. The
    group's velocities are resampled from the Maxwell distribution
    (``noise_vel`` scaled by sqrt(kT/m)). ``noise_pos`` and ``noise_vel``
    are (..., N, 3) standard-normal draws. Returns (new_position,
    new_velocity, reservoir_delta = KE_before - KE_after).
    """
    drag = (mass * gamma)[:, None]
    dt = _per_particle(dt)
    dx = forces * (dt / drag) + (
        torch.sqrt(2.0 * kT * dt / drag) * noise_pos)
    new_pos = torch.where(mask[:, None], position + dx, position)
    vmb = torch.sqrt(kT / mass)[:, None] * noise_vel
    new_v = torch.where(mask[:, None], vmb, velocity)
    ke_before = kinetic_energy(velocity, mass, mask)
    ke_after = kinetic_energy(new_v, mass, mask)
    return new_pos, new_v, ke_before - ke_after


class MTTKState(NamedTuple):
    """Nose-Hoover internal degrees of freedom (xi, eta) of one group:
    0-d, or (B,) for a replica batch."""

    xi: torch.Tensor
    eta: torch.Tensor


def mttk_rescale_factor(state: MTTKState, dt):
    """exp(-xi dt / 2), the velocity factor of each half step."""
    return torch.exp(-0.5 * state.xi * dt)


def mttk_advance(state: MTTKState, current_T, set_T, dof: float, dt, tau):
    """(xi, eta) one step on: xi' = xi + dt/(2 tau^2) (T/T0 - 1), applied
    twice; eta += xi' dt (``dof`` is kept for the reference signature)."""
    incr = 0.5 * dt / (tau * tau) * (current_T / set_T - 1.0)
    xi_prime = state.xi + incr
    return MTTKState(xi=xi_prime + incr, eta=state.eta + xi_prime * dt)


def mttk_energy(state: MTTKState, dof: float, set_T, tau):
    """The thermostat's energy dof T0 (xi^2 tau^2 / 2 + eta): with the
    system's energy, the quantity an MTTK run conserves."""
    return dof * set_T * (state.xi ** 2 * tau ** 2 / 2.0 + state.eta)


def mttk_thermalize(generator, dof: float, tau, dtype=torch.float64,
                    device=None, batch=()):
    """A random initial state: xi ~ N(0, 1/(dof tau^2)), eta = 0, of shape
    ``batch``, drawn from ``generator`` (the MTTK stream of
    ``integrate/rng.py``)."""
    batch = tuple(batch)
    sigma = math.sqrt(1.0 / (dof * tau * tau))
    xi = sigma * torch.randn(batch, generator=generator, dtype=dtype,
                             device=device)
    return MTTKState(xi=xi, eta=torch.zeros(batch, dtype=dtype,
                                            device=device))


def berendsen_factor(current_T, set_T, dt, tau):
    """lambda = sqrt(1 + dt/tau (T0/T - 1))."""
    return torch.sqrt(1.0 + dt / tau * (set_T / current_T - 1.0))


def thermalize_velocities(generator, mass, mask, kT, *, remove_drift=True):
    """Maxwell-Boltzmann velocities for the ``mask`` group (zero elsewhere),
    with the group's centre-of-mass drift removed when ``remove_drift``."""
    sigma = torch.sqrt(kT / mass)[:, None]
    v = sigma * torch.randn((mass.shape[0], 3), generator=generator,
                            dtype=mass.dtype, device=mass.device)
    zero = torch.zeros((), dtype=mass.dtype, device=mass.device)
    if remove_drift:
        w = torch.where(mask, mass, zero)
        vcm = torch.sum(w[:, None] * v, dim=-2) / torch.sum(w)
        v = v - vcm[..., None, :]
    return torch.where(mask[:, None], v, zero)
