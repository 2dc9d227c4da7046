"""MTTK (Nose-Hoover) and Berendsen baths of cavmd_tpu_torch against the
JAX package (float64, CPU), and the Kolafa-Perram Ewald splitting
parameter:

- the bath functions against cavmd_tpu.integrate.thermostats, elementwise
  over a replica axis; ``mttk_thermalize``'s draw;
- 20-step trajectories with the bath on the molecules and Langevin on the
  photon (the JAX draws injected) against ``make_step_fn`` + ``run_steps``:
  dense mode, cell mode, and zcol mode against JAX cell mode (the JAX zcol
  pass runs in float32, ROADMAP.md Queue 3): positions, velocities,
  images, every observable and (xi, eta) to 1e-10 of their scale;
- a mid-run JAX MTTK state carried across by ``interop.state_from_numpy``;
- ``auto_kappa_error_estimate`` and ``ForceField.create(kappa_mode=
  'kolafa-perram')`` against JAX's on the reference scene, the triatomic
  scene and an uncharged scene, and the forces they give.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cavmd_tpu.integrate import ForceField as JForceField
from cavmd_tpu.integrate import MethodSpec as JMethodSpec
from cavmd_tpu.integrate import init_state as j_init_state
from cavmd_tpu.integrate import make_step_fn as j_make_step_fn
from cavmd_tpu.integrate import resolve_methods as j_resolve_methods
from cavmd_tpu.integrate import run_steps as j_run_steps
from cavmd_tpu.integrate import thermostats as jth
from cavmd_tpu.ops import ewald as jewald
from cavmd_tpu_torch.core import PhysicalConstants as PC
from cavmd_tpu_torch.integrate import (
    OBS_KEYS,
    ForceField,
    MethodSpec,
    make_step_fn,
    resolve_methods,
    run_steps,
)
from cavmd_tpu_torch.integrate import thermostats as tth
from cavmd_tpu_torch.integrate.rng import STREAM_MTTK, make_generator
from cavmd_tpu_torch.interop import state_from_numpy
from cavmd_tpu_torch.ops import ewald as tewald

from test_torch_cell_kernel import port_cell_forcefield
from test_torch_integrate import JaxNoise, build
from test_torch_neighbor import _cell_build
from test_torch_ops import port_forcefield, scene
from test_torch_cuda import TRI_BONDS, TRI_LJ
from test_torch_polyatomic import both as triatomic
from test_torch_zcol import _traj_build

KT = PC.kT_from_kelvin(100.0)
GAMMA = PC.gamma_from_tau_ps(5.0)
# a short bath time so that xi moves well within 20 steps
BATH_TAU = PC.ps_to_atomic_units(0.05)
TOL = 1e-10
STATE_KEYS = ("position", "image", "velocity", "mass", "charge", "typeid",
              "box_L", "forces", "dt", "time_au", "time_comp", "timestep",
              "bussi_reservoir", "bussi_instantaneous", "langevin_reservoir",
              "error_tolerance")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: its tensors are small, and the
    suite runs six workers on the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def specs(bath, mod):
    return (mod(kind=bath, group="molecular", kT=KT, tau=BATH_TAU),
            mod(kind="langevin", group="cavity", kT=KT, gamma=GAMMA))


def port_state(jstate, forcefield=None, seed=3):
    """The port state of a JAX state, its MTTK leaves included."""
    return state_from_numpy(
        **{k: np.asarray(getattr(jstate, k)) for k in STATE_KEYS},
        mttk_xi=np.asarray(jstate.mttk.xi),
        mttk_eta=np.asarray(jstate.mttk.eta), seed=seed,
        forcefield=forcefield, device="cpu")


def close(t, j, tol=TOL, what=""):
    j = np.asarray(j, np.float64)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=tol * max(np.abs(j).max(), 1e-300),
                               err_msg=what)


def assert_matches(tfinal, tobs, jfinal, jobs, tol=TOL):
    for name in ("position", "velocity"):
        close(getattr(tfinal, name), getattr(jfinal, name), tol, name)
    np.testing.assert_array_equal(tfinal.image.numpy(),
                                  np.asarray(jfinal.image))
    close(tfinal.mttk_xi, jfinal.mttk.xi, tol, "mttk xi")
    close(tfinal.mttk_eta, jfinal.mttk.eta, tol, "mttk eta")
    for k in OBS_KEYS + tuple(k for k in ("cell_overflow",) if k in jobs):
        close(tobs[k], jobs[k], tol, k)


# ----------------------------------------------------- the bath functions
def test_bath_functions_match_jax():
    """rescale, advance, energy and the Berendsen factor on (B,) inputs
    against jax.vmap of the JAX functions, to 1e-15 relative."""
    rng = np.random.default_rng(4)
    xi, eta = rng.normal(scale=1e-4, size=(2, 5))
    T = rng.uniform(50.0, 150.0, 5) * PC.KB_HARTREE_PER_K
    dt = rng.uniform(5.0, 20.0, 5)
    dof, tau = 300.0, BATH_TAU
    t = [torch.tensor(a) for a in (xi, eta, T, dt)]
    st = tth.MTTKState(t[0], t[1])
    jst = jth.MTTKState(jnp.asarray(xi), jnp.asarray(eta))
    pairs = [
        (tth.mttk_rescale_factor(st, t[3]),
         jax.vmap(jth.mttk_rescale_factor)(jst, jnp.asarray(dt))),
        (tth.mttk_energy(st, dof, KT, tau), jth.mttk_energy(jst, dof, KT,
                                                            tau)),
        (tth.berendsen_factor(t[2], KT, t[3], tau),
         jth.berendsen_factor(jnp.asarray(T), KT, jnp.asarray(dt), tau)),
    ]
    adv = tth.mttk_advance(st, t[2], KT, dof, t[3], tau)
    jadv = jth.mttk_advance(jst, jnp.asarray(T), KT, dof, jnp.asarray(dt),
                            tau)
    pairs += [(adv.xi, jadv.xi), (adv.eta, jadv.eta)]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-15, atol=0)


def test_mttk_thermalize_draws_from_its_stream():
    """xi ~ N(0, 1/(dof tau^2)) from the MTTK stream's generator, eta 0,
    of the batch shape; the same seed gives the same draw."""
    dof, tau = 30.0, BATH_TAU
    gen = make_generator(5, STREAM_MTTK, 0, "cpu")
    st = tth.mttk_thermalize(gen, dof, tau, batch=(20000,))
    assert st.xi.shape == st.eta.shape == (20000,)
    assert not st.eta.any()
    sigma = (1.0 / (dof * tau * tau)) ** 0.5
    assert float(st.xi.std()) == pytest.approx(sigma, rel=0.03)
    assert abs(float(st.xi.mean())) < 0.05 * sigma
    again = tth.mttk_thermalize(make_generator(5, STREAM_MTTK, 0, "cpu"),
                                dof, tau, batch=(20000,))
    assert torch.equal(again.xi, st.xi)
    assert tth.mttk_thermalize(gen, dof, tau).xi.shape == ()


# ------------------------------------------------- 20-step trajectories
def _dense():
    js, ts, jff, _ = build()
    return js, ts, jff, port_forcefield(jff, js), PC.fs_to_atomic_units(0.25)


def _cell():
    js, ts, jff = _cell_build()
    return js, ts, jff, port_cell_forcefield(jff, js), \
        PC.fs_to_atomic_units(0.25)


def _zcol():
    js, ts = _traj_build()
    kw = dict(coupling=1e-3, r_cut=11.95, pppm_mesh=(8, 8, 8),
              cell_skin=0.05)
    return (js, ts, JForceField.create(js, pair_mode="cell", **kw),
            ForceField.create(ts, pair_mode="zcol", **kw),
            PC.fs_to_atomic_units(0.5))


MODES = {"dense": _dense, "cell": _cell, "zcol": _zcol}


@pytest.mark.parametrize("bath", ["mttk", "berendsen"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_bath_trajectory_matches_jax(mode, bath):
    """20 steps of the bath on the molecules and Langevin on the photon,
    the JAX draws injected, to 1e-10 of each quantity's scale; in cell and
    zcol mode across the carried list (zcol against JAX cell mode)."""
    js, ts, jff, tff, dt = MODES[mode]()
    jm = j_resolve_methods(js, specs(bath, JMethodSpec), jff.l_typeid)
    jstate = j_init_state(js, jff, dt=dt, seed=3)
    jfinal, jobs = jax.jit(
        lambda s: j_run_steps(j_make_step_fn(jff, jm), s, 20))(jstate)
    tm = resolve_methods(ts, specs(bath, MethodSpec), tff.l_typeid)
    step = make_step_fn(tff, tm, noise=JaxNoise(jstate.key))
    start = port_state(jstate, tff if mode != "dense" else None)
    tfinal, tobs = run_steps(step, start, 20)
    assert_matches(tfinal, tobs, jfinal, jobs)
    if bath == "mttk":
        assert float(tfinal.mttk_xi[0]) != 0.0
        assert float(tfinal.mttk_xi[1]) == 0.0
    else:
        assert not tfinal.mttk_xi.any() and not tfinal.mttk_eta.any()


def test_mid_run_jax_mttk_state_carries_across():
    """JAX runs 10 MTTK steps; its state, (xi, eta) included, crosses
    through ``state_from_numpy``, and the port's next 10 steps follow
    JAX's to 1e-10."""
    js, ts, jff, tff, dt = _dense()
    jm = j_resolve_methods(js, specs("mttk", JMethodSpec), jff.l_typeid)
    run10 = jax.jit(lambda s: j_run_steps(j_make_step_fn(jff, jm), s, 10))
    jstate = j_init_state(js, jff, dt=dt, seed=3)
    jmid, _ = run10(jstate)
    jfinal, jobs = run10(jmid)
    assert float(jmid.mttk.xi[0]) != 0.0 and float(jmid.mttk.eta[0]) != 0.0
    start = port_state(jmid)
    assert start.step == 10
    close(start.mttk_xi, jmid.mttk.xi, 0.0, "xi crosses")
    step = make_step_fn(tff, resolve_methods(ts, specs("mttk", MethodSpec),
                                             tff.l_typeid),
                        noise=JaxNoise(jstate.key))
    tfinal, tobs = run_steps(step, start, 10)
    assert_matches(tfinal, tobs, jfinal, jobs)


# ---------------------------------------------------------- Kolafa-Perram
def _kappa_scenes():
    ref = scene(n_mol=250, box_L=46.0, seed=0, jitter=0.0)
    tri = triatomic()
    small = scene(n_mol=20, box_L=24.0, seed=0, jitter=0.0)
    uncharged = (small[0].replace(charge=jnp.zeros_like(small[0].charge)),
                 small[1].replace(charge=torch.zeros_like(small[1].charge)))
    return {"reference": (ref, {}),
            "triatomic": (tri, dict(enable_cavity=False, lj_params=TRI_LJ,
                                    bond_params=TRI_BONDS)),
            "uncharged": (uncharged, {})}


@pytest.fixture(scope="module")
def kappa_scenes():
    return _kappa_scenes()


@pytest.mark.parametrize("name", ["reference", "triatomic", "uncharged"])
def test_kolafa_perram_kappa_matches_jax(kappa_scenes, name):
    """The estimator and ForceField.create's kappa_mode against JAX's, to
    1e-12; an explicit kappa still wins; the uncharged scene falls back to
    the erfc kappa."""
    (js, ts), kw = kappa_scenes[name]
    for r_cut in (10.0, 15.0):
        want = jewald.auto_kappa_error_estimate(
            np.asarray(js.charge), np.asarray(js.box_L), r_cut)
        got = tewald.auto_kappa_error_estimate(
            ts.charge.numpy(), ts.box_L.numpy(), r_cut)
        assert got == pytest.approx(want, rel=1e-12, abs=0)
        assert tewald.real_space_rms_error(
            got, ts.charge.numpy(), ts.box_L.numpy(), r_cut) == \
            pytest.approx(jewald.real_space_rms_error(
                want, np.asarray(js.charge), np.asarray(js.box_L), r_cut),
                rel=1e-12)
    jff = JForceField.create(js, kappa_mode="kolafa-perram", **kw)
    tff = ForceField.create(ts, kappa_mode="kolafa-perram", **kw)
    assert tff.kappa_value == pytest.approx(float(jff.kappa), rel=1e-12)
    erfc = ForceField.create(ts, **kw).kappa_value
    if name == "uncharged":
        assert tff.kappa_value == erfc
    else:
        assert tff.kappa_value != pytest.approx(erfc, rel=1e-3)
    assert ForceField.create(ts, kappa=0.3, kappa_mode="kolafa-perram",
                             **kw).kappa_value == 0.3


def test_kolafa_perram_forces_match_jax():
    """ForceField.create(kappa_mode='kolafa-perram') on the small scene:
    forces and energies against JAX's to 1e-10."""
    js, ts = scene(n_mol=20, box_L=24.0, seed=0, jitter=0.05)
    kw = dict(coupling=1e-3, pppm_mesh=(16, 16, 16), r_cut=10.0,
              kappa_mode="kolafa-perram")
    jff, tff = JForceField.create(js, **kw), ForceField.create(ts, **kw)
    f_ref, e_ref = jax.jit(lambda p: jff.compute(
        p, js.image, js.box_L, js.charge, js.typeid, js.bond_group,
        js.bond_typeid))(js.position)
    with torch.no_grad():
        f, e = tff(ts.position, ts.image, ts.box_L, ts.charge, ts.typeid)
    close(f, f_ref, TOL, "forces")
    for k in ("lj", "ewald_short", "ewald_long", "harmonic",
              "cavity_coupling"):
        assert float(e[k]) == pytest.approx(float(e_ref[k]), rel=TOL), k
    with pytest.raises(ValueError, match="kappa_mode"):
        ForceField.create(ts, kappa_mode="hoomd")
