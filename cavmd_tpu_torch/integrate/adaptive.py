"""Adaptive timestep control with exponential error-tolerance ramping.

Port of ``cavmd_tpu/integrate/adaptive.py`` (the reference's
``AdaptiveTimestepUpdater``), computed on the device with no read-back:

- dt = sqrt(tol / sum_i |F_i| / m_i) from the current total force;
- tol(t) = tol_target - (tol_target - tol_0) exp(-t / tau_ramp), with
  tau_ramp = 50 ps and tol_0 = initial_fraction * tol_target.

The JAX package picks the update steps with ``lax.cond`` on the device
step counter. Here the choice is made on the host, from the state's host
step counter (``MDState.step``), so it costs no host sync and no work on
the other steps.
"""

from __future__ import annotations

import torch

from cavmd_tpu_torch.core.units import PhysicalConstants
from cavmd_tpu_torch.integrate.integrator import MDState


def compute_optimal_dt(forces, mass, tolerance):
    """dt = sqrt(tol / sum |F_i| / m_i): 0-d for (N, 3) forces, (B,) for a
    replica batch (B, N, 3) with (B,) or host tolerances."""
    fnorm = torch.sqrt(torch.sum(forces * forces, dim=-1))
    s = torch.sum(fnorm / mass, dim=-1)
    return torch.sqrt(tolerance / torch.clamp_min(
        s, torch.finfo(forces.dtype).tiny))


def make_adaptive_step(step_fn, *, error_tolerance: float,
                       initial_fraction: float = 1e-3,
                       time_constant_ps: float = 50.0, period: int = 1):
    """Wrap a step function with the adaptive-dt controller.

    On every step whose (pre-step) counter is a multiple of ``period``,
    the controller recomputes the tolerance ramp and sets dt from the
    cached forces. Every step logs the tolerance in force as the
    ``error_tolerance`` observable. In a replica batch each replica ramps
    its own tolerance and dt from its own clock and forces; the period
    runs on the batch's shared host counter.
    """
    target = float(error_tolerance)
    initial = target * float(initial_fraction)
    inv_tau = 1.0 / float(time_constant_ps)

    def update(state: MDState) -> MDState:
        dtype = state.position.dtype
        t_ps = state.time_au * PhysicalConstants.TIME_PS_CONVERSION
        tol = target - (target - initial) * torch.exp(-t_ps * inv_tau)
        new_dt = compute_optimal_dt(state.forces, state.mass, tol)
        return state.replace(dt=new_dt.to(dtype),
                             error_tolerance=tol.to(dtype))

    def astep(state: MDState):
        if state.step % period == 0:
            state = update(state)
        new_state, obs = step_fn(state)
        obs["error_tolerance"] = state.error_tolerance
        return new_state, obs

    astep.force_field = getattr(step_fn, "force_field", None)
    astep.noise = getattr(step_fn, "noise", None)
    if hasattr(step_fn, "rebind"):
        def rebind(**kw):
            """This adaptive step around ``step_fn.rebind(**kw)``."""
            return make_adaptive_step(
                step_fn.rebind(**kw), error_tolerance=error_tolerance,
                initial_fraction=initial_fraction,
                time_constant_ps=time_constant_ps, period=period)

        astep.rebind = rebind
    return astep
