from cavmd_tpu_torch.integrate.adaptive import (
    compute_optimal_dt,
    make_adaptive_step,
)
from cavmd_tpu_torch.integrate.forcefield import ForceField
from cavmd_tpu_torch.integrate.integrator import (
    OBS_KEYS,
    MDState,
    MethodSpec,
    StreamNoise,
    init_state,
    make_step_fn,
    potential_energy,
    resolve_methods,
    run_steps,
    universe_energy,
)
from cavmd_tpu_torch.integrate.thermostats import (
    brownian_apply,
    bussi_apply,
    bussi_noise,
    bussi_rescale_factor,
    kinetic_energy,
    langevin_ou_apply,
    thermalize_velocities,
)

__all__ = [
    "compute_optimal_dt",
    "make_adaptive_step",
    "ForceField",
    "OBS_KEYS",
    "MDState",
    "MethodSpec",
    "StreamNoise",
    "init_state",
    "make_step_fn",
    "potential_energy",
    "resolve_methods",
    "run_steps",
    "universe_energy",
    "brownian_apply",
    "bussi_apply",
    "bussi_noise",
    "bussi_rescale_factor",
    "kinetic_energy",
    "langevin_ou_apply",
    "thermalize_velocities",
]
