"""Adaptive dt of cavmd_tpu_torch against cavmd_tpu.integrate.adaptive
(float64, CPU): the optimal-dt formula, and the controller over 20 steps
of the Bussi + Langevin step with the JAX package's noise injected."""

import jax
import numpy as np
import pytest
import torch

from cavmd_tpu.core import PhysicalConstants as PC
from cavmd_tpu.integrate import MethodSpec as JMethodSpec
from cavmd_tpu.integrate import init_state as j_init_state
from cavmd_tpu.integrate import make_step_fn as j_make_step_fn
from cavmd_tpu.integrate import resolve_methods as j_resolve_methods
from cavmd_tpu.integrate import run_steps as j_run_steps
from cavmd_tpu.integrate.adaptive import compute_optimal_dt as j_opt_dt
from cavmd_tpu.integrate.adaptive import make_adaptive_step as j_adaptive
from cavmd_tpu_torch.integrate import (
    MethodSpec,
    compute_optimal_dt,
    make_adaptive_step,
    make_step_fn,
    resolve_methods,
    run_steps,
)

from test_torch_integrate import GAMMA, KT, TAU, JaxNoise, build, port_state
from test_torch_ops import port_forcefield


def test_compute_optimal_dt_matches_jax():
    rng = np.random.default_rng(4)
    for n in (5, 41, 501):
        forces = rng.normal(scale=1e-2, size=(n, 3))
        mass = rng.uniform(1.0, 3e4, size=n)
        for tol in (1e-3, 0.37):
            j = float(j_opt_dt(forces, mass, tol))
            t = float(compute_optimal_dt(torch.as_tensor(forces),
                                         torch.as_tensor(mass), tol))
            assert t == pytest.approx(j, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("period", [1, 6])
def test_adaptive_step_matches_jax(period):
    """20 adaptive steps (tolerance ramp from 1e-3 of the target, dt reset
    every ``period`` steps): positions to 1e-10 bohr, the dt and
    error_tolerance columns to 1e-12 relative."""
    js, ts, jff, _ = build()
    jm = j_resolve_methods(js, (
        JMethodSpec(kind="bussi", group="molecular", kT=KT, tau=TAU),
        JMethodSpec(kind="langevin", group="cavity", kT=KT, gamma=GAMMA)),
        jff.l_typeid)
    jstate = j_init_state(js, jff, dt=PC.fs_to_atomic_units(0.1), seed=3,
                          error_tolerance=1.0)
    # the driver's bootstrap (advanced_run.py:_set_timestep)
    jstate = jstate.replace(dt=j_opt_dt(jstate.forces, jstate.mass, 1e-3))
    kw = dict(error_tolerance=1.0, time_constant_ps=0.002, period=period)
    jstep = j_adaptive(j_make_step_fn(jff, jm), **kw)
    jfinal, jobs = jax.jit(lambda s: j_run_steps(jstep, s, 20))(jstate)

    tff = port_forcefield(jff, js)
    tm = resolve_methods(ts, (
        MethodSpec(kind="bussi", group="molecular", kT=KT, tau=TAU),
        MethodSpec(kind="langevin", group="cavity", kT=KT, gamma=GAMMA)),
        tff.l_typeid)
    tstep = make_adaptive_step(
        make_step_fn(tff, tm, noise=JaxNoise(jstate.key)), **kw)
    tstate = port_state(jstate, seed=3).replace(
        error_tolerance=torch.tensor(1.0, dtype=torch.float64))
    tfinal, tobs = run_steps(tstep, tstate, 20)

    np.testing.assert_allclose(tfinal.position.numpy(),
                               np.asarray(jfinal.position), rtol=0,
                               atol=1e-10)
    np.testing.assert_array_equal(tfinal.image.numpy(),
                                  np.asarray(jfinal.image))
    for k in ("dt", "error_tolerance"):
        np.testing.assert_allclose(tobs[k], np.asarray(jobs[k]), rtol=1e-12,
                                   atol=0, err_msg=k)
    # the ramp moved dt and the tolerance inside the window
    assert len(np.unique(tobs["dt"])) > 1
    assert len(np.unique(tobs["error_tolerance"])) > 1
