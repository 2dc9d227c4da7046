"""The slice end to end: cavmd_tpu_torch's step and runner against
cavmd_tpu's run_steps (float64, CPU), the universe-energy oracle on the
port's own RNG, the Simulation facade, and the no-JAX import rule."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cavmd_tpu.core import PhysicalConstants as PC
from cavmd_tpu.integrate import ForceField as JForceField
from cavmd_tpu.integrate import MethodSpec as JMethodSpec
from cavmd_tpu.integrate import init_state as j_init_state
from cavmd_tpu.integrate import make_step_fn as j_make_step_fn
from cavmd_tpu.integrate import resolve_methods as j_resolve_methods
from cavmd_tpu.integrate import run_steps as j_run_steps
from cavmd_tpu.integrate.rng import (
    STREAM_BROWNIAN,
    STREAM_BUSSI,
    STREAM_LANGEVIN,
    stream_key,
)
from cavmd_tpu.integrate.thermostats import bussi_noise as j_bussi_noise
from cavmd_tpu_torch import Simulation
from cavmd_tpu_torch.integrate import (
    OBS_KEYS,
    ForceField,
    MethodSpec,
    init_state,
    make_step_fn,
    resolve_methods,
    run_steps,
    universe_energy,
)
from cavmd_tpu_torch.interop import state_from_numpy

from test_torch_ops import port_forcefield, scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = PC.fs_to_atomic_units(0.25)
KT = PC.kT_from_kelvin(100.0)
TAU = PC.ps_to_atomic_units(5.0)
GAMMA = PC.gamma_from_tau_ps(5.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: its tensors are small, and the
    suite runs six workers on the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def build(seed=0):
    """tests/test_integrate.py:build_system in both packages (N = 41, 16^3
    mesh, r_cut 10), photon with a thermal velocity."""
    js, ts = scene(n_mol=20, box_L=24.0, seed=seed, jitter=0.0)
    v = np.asarray(js.velocity).copy()
    v[-1] = np.random.default_rng(seed + 2).normal(0.0, np.sqrt(KT), size=3)
    js = js.replace(velocity=jnp.asarray(v))
    ts = ts.replace(velocity=torch.as_tensor(v))
    kw = dict(coupling=1e-3, freq_cm1=2000.0, pppm_mesh=(16, 16, 16),
              r_cut=10.0)
    return js, ts, JForceField.create(js, **kw), kw


def port_state(jstate, seed=0):
    return state_from_numpy(
        **{k: np.asarray(getattr(jstate, k)) for k in (
            "position", "image", "velocity", "mass", "charge", "typeid",
            "box_L", "forces", "dt", "time_au", "time_comp", "timestep",
            "bussi_reservoir", "bussi_instantaneous", "langevin_reservoir")},
        seed=seed, device="cpu")


class JaxNoise:
    """Hands the JAX package's own per-step draws to the port's step
    (integrator.py:_fused_step draws them the same way), in ``dtype``."""

    def __init__(self, key, dtype=jnp.float64):
        self.key = key
        self.dtype = dtype
        self.tdtype = torch.float32 if dtype == jnp.float32 else torch.float64

    def _t(self, x):
        return torch.tensor(np.asarray(x), dtype=self.tdtype)

    def bussi(self, state, i, m):
        r1, rg = j_bussi_noise(
            stream_key(self.key, STREAM_BUSSI, state.step, i), m.dof,
            self.dtype)
        return self._t(r1), self._t(rg)

    def langevin(self, state, i, m, shape):
        key = stream_key(self.key, STREAM_LANGEVIN, state.step, i)
        return self._t(jax.random.normal(key, shape, dtype=self.dtype))

    def brownian(self, state, i, m):
        key = stream_key(self.key, STREAM_BROWNIAN, state.step, i)
        k1, k2 = jax.random.split(key)
        shape = tuple(state.position.shape)
        return (self._t(jax.random.normal(k1, shape, dtype=self.dtype)),
                self._t(jax.random.normal(k2, shape, dtype=self.dtype)))


def _trajectories(methods_j, methods_t, n_steps, noise_for):
    js, ts, jff, _ = build()
    jm = j_resolve_methods(js, methods_j, jff.l_typeid)
    jstate = j_init_state(js, jff, dt=DT, seed=3)
    jfinal, jobs = jax.jit(
        lambda s: j_run_steps(j_make_step_fn(jff, jm), s, n_steps))(jstate)

    tff = port_forcefield(jff, js)
    tm = resolve_methods(ts, methods_t, tff.l_typeid)
    assert [m.dof for m in tm] == [m.dof for m in jm]
    step = make_step_fn(tff, tm, noise=noise_for(jstate))
    tfinal, tobs = run_steps(step, port_state(jstate, seed=3), n_steps)
    return jfinal, jobs, tfinal, tobs


def _assert_traj(jfinal, jobs, tfinal, tobs, tol):
    pos_j = np.asarray(jfinal.position)
    np.testing.assert_allclose(tfinal.position.numpy(), pos_j, rtol=0,
                               atol=tol * np.abs(pos_j).max())
    np.testing.assert_array_equal(tfinal.image.numpy(),
                                  np.asarray(jfinal.image))
    vel_j = np.asarray(jfinal.velocity)
    np.testing.assert_allclose(tfinal.velocity.numpy(), vel_j, rtol=0,
                               atol=tol * np.abs(vel_j).max())
    for k in OBS_KEYS:
        j = np.asarray(jobs[k], dtype=np.float64)
        scale = max(np.abs(j).max(), 1e-12)
        np.testing.assert_allclose(tobs[k], j, rtol=0, atol=tol * scale,
                                   err_msg=k)
    np.testing.assert_array_equal(tobs["timestep"], np.arange(1, 21))


def test_nve_trajectory_matches_jax():
    jfinal, jobs, tfinal, tobs = _trajectories(
        (JMethodSpec(kind="nve", group="all"),),
        (MethodSpec(kind="nve", group="all"),), 20, lambda s: None)
    _assert_traj(jfinal, jobs, tfinal, tobs, 1e-10)


def test_bussi_langevin_trajectory_matches_jax_with_injected_noise():
    """The main path's methods; the port draws JAX's own noise, so the two
    trajectories must agree to roundoff."""
    jfinal, jobs, tfinal, tobs = _trajectories(
        (JMethodSpec(kind="bussi", group="molecular", kT=KT, tau=TAU),
         JMethodSpec(kind="langevin", group="cavity", kT=KT, gamma=GAMMA)),
        (MethodSpec(kind="bussi", group="molecular", kT=KT, tau=TAU),
         MethodSpec(kind="langevin", group="cavity", kT=KT, gamma=GAMMA)),
        20, lambda s: JaxNoise(s.key))
    _assert_traj(jfinal, jobs, tfinal, tobs, 1e-9)
    assert abs(tobs["bussi_reservoir_molecular"][-1]) > 0
    assert abs(tobs["langevin_reservoir_cavity"][-1]) > 0


@pytest.mark.parametrize("cavity", ["langevin", "brownian"])
def test_brownian_trajectory_matches_jax_with_injected_noise(cavity):
    """Brownian molecules (the overdamped move, the velocity resample and
    its tally) with a Langevin or Brownian photon, JAX's noise injected:
    20 steps agree to roundoff, reservoirs included. The friction rate is
    1/(1 fs), so each overdamped move is ~1e-3 bohr; at the production
    1/(5 ps) the moves reach ~1 bohr a step, the atoms overlap and the two
    packages' roundoff grows to O(1) within 20 steps."""
    gamma_b = PC.gamma_from_tau_ps(0.001)
    specs = []
    for mod in (JMethodSpec, MethodSpec):
        photon = (mod(kind="langevin", group="cavity", kT=KT, gamma=GAMMA)
                  if cavity == "langevin" else
                  mod(kind="brownian", group="cavity", kT=KT,
                      gamma=gamma_b))
        specs.append((mod(kind="brownian", group="molecular", kT=KT,
                          gamma=gamma_b), photon))
    jfinal, jobs, tfinal, tobs = _trajectories(
        specs[0], specs[1], 20, lambda s: JaxNoise(s.key))
    _assert_traj(jfinal, jobs, tfinal, tobs, 1e-9)
    assert abs(tobs["langevin_reservoir_molecular"][-1]) > 0


def test_extra_obs_columns_match_jax():
    """make_extra_obs columns (dipole (3,), rho(k) (nk,)) pack into the
    runner's one buffer and unpack into (n_steps, d) arrays equal to the
    JAX package's run_steps output (NVE, float64)."""
    from cavmd_tpu.observe import make_extra_obs as j_extra
    from cavmd_tpu_torch.observe import make_extra_obs as t_extra

    js, ts, jff, _ = build()
    wv = np.random.default_rng(0).normal(size=(7, 3))
    jm = j_resolve_methods(js, (JMethodSpec(kind="nve", group="all"),),
                           jff.l_typeid)
    jstate = j_init_state(js, jff, dt=DT, seed=3)
    jstep = j_make_step_fn(jff, jm, extra_obs=j_extra(dipole=True,
                                                      wavevectors=wv))
    _, jobs = jax.jit(lambda s: j_run_steps(jstep, s, 6))(jstate)
    tff = port_forcefield(jff, js)
    tm = resolve_methods(ts, (MethodSpec(kind="nve", group="all"),),
                         tff.l_typeid)
    tstep = make_step_fn(tff, tm, extra_obs=t_extra(dipole=True,
                                                    wavevectors=wv))
    _, tobs = run_steps(tstep, port_state(jstate, seed=3), 6)
    assert set(tobs) == set(jobs)
    for k, w in (("dipole", 3), ("rho_k_re", 7), ("rho_k_im", 7)):
        j = np.asarray(jobs[k])
        assert tobs[k].shape == j.shape == (6, w), k
        np.testing.assert_allclose(tobs[k], j, rtol=0,
                                   atol=1e-10 * np.abs(j).max(), err_msg=k)


def test_universe_energy_conservation_bussi_langevin():
    """test_integrate.py's flagship oracle on the port's own RNG: universe
    energy (system + reservoirs) conserved to < 2e-4 Ha over 1000 steps."""
    _, ts, _, kw = build()
    ff = ForceField.create(ts, **kw)
    methods = resolve_methods(ts, (
        MethodSpec(kind="bussi", group="molecular", kT=KT, tau=TAU),
        MethodSpec(kind="langevin", group="cavity", kT=KT, gamma=GAMMA),
    ), ff.l_typeid)
    state = init_state(ts, ff, dt=DT, seed=3)
    final, obs = run_steps(make_step_fn(ff, methods), state, 1000)
    U = universe_energy(obs)
    assert np.all(np.isfinite(U))
    assert abs(float(final.bussi_reservoir[0])) > 1e-8
    assert abs(float(final.langevin_reservoir[1])) > 1e-10
    assert np.abs(U - U[0]).max() < 2e-4


def test_generators_are_per_stream_and_reproducible():
    _, ts, _, kw = build()
    ff = ForceField.create(ts, **kw)
    methods = resolve_methods(ts, (
        MethodSpec(kind="bussi", group="molecular", kT=KT, tau=TAU),
        MethodSpec(kind="langevin", group="cavity", kT=KT, gamma=GAMMA),
    ), ff.l_typeid)
    step = make_step_fn(ff, methods)
    runs = [run_steps(step, init_state(ts, ff, dt=DT, seed=s), 5)[0]
            for s in (5, 5, 6)]
    np.testing.assert_array_equal(runs[0].velocity.numpy(),
                                  runs[1].velocity.numpy())
    assert not np.allclose(runs[0].velocity.numpy(),
                           runs[2].velocity.numpy())
    assert set(runs[0].generators) == {(STREAM_BUSSI, 0),
                                       (STREAM_LANGEVIN, 1)}


def test_simulation_thermalize_and_run():
    _, ts, _, kw = build()
    ff = ForceField.create(ts, **kw)
    sim = Simulation(ts, ff, (
        MethodSpec(kind="bussi", group="molecular", kT=KT, tau=TAU),
        MethodSpec(kind="langevin", group="cavity", kT=KT, gamma=GAMMA),
    ), dt=DT, seed=2, chunk_size=16)
    sim.thermalize(KT)
    v = sim.state.velocity
    m = sim.state.mass
    mol = sim.state.typeid != ff.l_typeid
    p_mol = torch.sum(m[mol, None] * v[mol], dim=0)
    assert float(p_mol.abs().max()) < 1e-12 * float(m.sum())
    assert float(v[~mol].abs().max()) > 0
    assert sim.run(n_steps=40) == 40
    assert sim.timestep == 40
    assert len(sim.last_obs["timestep"]) == 8
    assert sim.last_obs["timestep"][-1] == 40
    for k in OBS_KEYS:
        assert np.all(np.isfinite(sim.last_obs[k])), k


def test_unported_methods_raise():
    """The port's counterpart of tests/test_fused_integrator.py:139: K4/K5
    take no MTTK bath, so ``fuse_integrator=True`` on a float32 state
    raises ValueError, while ``None`` runs the unfused tail (the same
    steps as ``False``, bit for bit)."""
    _, ts, _, kw = build()
    ts = ts.astype(torch.float32)
    ff = ForceField.create(ts, **kw)
    methods = resolve_methods(ts, (
        MethodSpec(kind="mttk", group="molecular", kT=KT,
                   tau=PC.ps_to_atomic_units(0.1)),
        MethodSpec(kind="nve", group="cavity")), ff.l_typeid)
    state = init_state(ts, ff, dt=DT, seed=7)
    with pytest.raises(ValueError, match="fused integrator"):
        make_step_fn(ff, methods, fuse_integrator=True)(state)
    auto, _ = run_steps(make_step_fn(ff, methods), state, 3)
    off, _ = run_steps(make_step_fn(ff, methods, fuse_integrator=False),
                       state, 3)
    assert torch.equal(auto.position, off.position)
    assert torch.equal(auto.mttk_xi, off.mttk_xi)
    assert float(auto.mttk_xi[0]) != 0.0


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import cavmd_tpu_torch\n"
        "import cavmd_tpu_torch.interop, cavmd_tpu_torch.simulation\n"
        "import cavmd_tpu_torch.ops.pair_kernels\n"
        "import cavmd_tpu_torch.ops.pppm_kernels\n"
        "import cavmd_tpu_torch.parallel.replicas\n"
        "import cavmd_tpu_torch.io.checkpoint\n"
        "import cavmd_tpu_torch.drivers.advanced_run\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'cavmd_tpu'))\n"
        "assert not bad, bad\n"
        "assert not __import__('torch').backends.cuda.matmul.allow_tf32\n"
        "assert not __import__('torch').backends.cudnn.allow_tf32\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
