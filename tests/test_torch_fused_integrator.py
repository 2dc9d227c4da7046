"""The fused integrator tail (K4/K5) of cavmd_tpu_torch against the JAX
package's Pallas kernels (interpret mode) and against the port's own
unfused step, float32 on the CPU (the wrappers run their plain twins on
CPU tensors). Scenes follow tests/test_fused_integrator.py: 30 molecules,
8^3 mesh, r_cut 8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cavmd_tpu.core import PhysicalConstants as PC
from cavmd_tpu.core import add_cavity_particle as j_add
from cavmd_tpu.core import make_diatomic_system as j_make
from cavmd_tpu.integrate import ForceField as JForceField
from cavmd_tpu.integrate import MethodSpec as JMethodSpec
from cavmd_tpu.integrate import init_state as j_init_state
from cavmd_tpu.integrate import make_step_fn as j_make_step_fn
from cavmd_tpu.integrate import resolve_methods as j_resolve_methods
from cavmd_tpu.integrate import run_steps as j_run_steps
from cavmd_tpu.integrate.integrator import group_mask as j_group_mask
from cavmd_tpu.ops import fused_integrator as jfi
from cavmd_tpu_torch.integrate import (
    MethodSpec,
    make_step_fn,
    resolve_methods,
    run_steps,
)
from cavmd_tpu_torch.ops import fused_integrator as tfi

from test_torch_integrate import JaxNoise, port_state
from test_torch_ops import port_forcefield

KT = PC.kT_from_kelvin(100.0)
TAU = PC.ps_to_atomic_units(0.1)
GAMMA = PC.gamma_from_tau_ps(0.1)


def _specs(mod, molecular="bussi", langevin=True):
    if molecular == "bussi":
        specs = [mod(kind="bussi", group="molecular", kT=KT, tau=TAU)]
    else:
        specs = [mod(kind="brownian", group="molecular", kT=KT, gamma=GAMMA)]
    if langevin:
        specs.append(mod(kind="langevin", group="cavity", kT=KT,
                         gamma=GAMMA))
    else:
        specs.append(mod(kind="nve", group="cavity"))
    return tuple(specs)


def _build(n_mol=30, box_L=25.0, **spec_kw):
    """tests/test_fused_integrator.py:_build in both packages, f32."""
    js = j_add(j_make(n_mol, box_L=box_L, temperature_K=100.0, seed=0,
                      dtype=np.float64),
               coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1)
    js = js.astype(jnp.float32)
    jff = JForceField.create(js, coupling=1e-3, freq_cm1=2000.0,
                             pppm_mesh=(8, 8, 8), r_cut=8.0)
    jm = j_resolve_methods(js, _specs(JMethodSpec, **spec_kw), jff.l_typeid)
    jstate = j_init_state(js, jff, dt=PC.fs_to_atomic_units(0.5), seed=7)
    tff = port_forcefield(jff, js, dtype=torch.float32)
    tm = resolve_methods(_port_snapshot(js), _specs(MethodSpec, **spec_kw),
                         tff.l_typeid)
    tstate = port_state_f32(jstate)
    return jff, jm, jstate, tff, tm, tstate


def _port_snapshot(js):
    from cavmd_tpu_torch.core import Snapshot

    return Snapshot.create(
        np.asarray(js.position), np.asarray(js.box_L),
        typeid=np.asarray(js.typeid), types=js.types, device="cpu")


def port_state_f32(jstate):
    s = port_state(jstate, seed=7)
    return s.replace(**{k: getattr(s, k).to(torch.float32) for k in (
        "position", "velocity", "mass", "charge", "box_L", "forces", "dt",
        "time_au", "time_comp", "bussi_reservoir", "bussi_instantaneous",
        "langevin_reservoir", "error_tolerance")})


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _kernel_inputs(jstate, jm, seed=3):
    """Seeded inputs for the two kernels, with a few particles pushed
    across each box face so that the rewrap and image update run."""
    rng = np.random.default_rng(seed)
    pos = np.asarray(jstate.position).copy()
    vel = np.asarray(jstate.velocity).copy()
    L = np.asarray(jstate.box_L)
    n = pos.shape[0]
    dt = np.float32(PC.fs_to_atomic_units(0.5))
    for k, (row, d, sgn) in enumerate([(0, 0, 1), (5, 1, -1), (9, 2, 1),
                                       (14, 0, -1)]):
        pos[row, d] = sgn * (0.5 * L[d] - 1e-4 * (k + 1))
        vel[row, d] = sgn * 5e-3  # dt * v ~ 0.1 bohr: crosses the face
    forces = rng.normal(scale=1e-3, size=(n, 3)).astype(np.float32)
    image = rng.integers(-2, 3, size=(n, 3)).astype(np.int32)
    r1, r_gamma = np.float32(rng.normal()), np.float32(
        2.0 * rng.gamma((jm[0].dof - 1) / 2))
    noise3 = rng.normal(size=3).astype(np.float32)
    return dict(pos=pos.astype(np.float32), vel=vel.astype(np.float32),
                image=image, forces=forces, dt=dt, r1=r1, r_gamma=r_gamma,
                noise3=noise3)


def test_plain_twins_match_pallas_kernels():
    """(a) the K4/K5 plain twins against pre_force_apply/post_force_apply
    of the JAX package (Pallas, interpret), float32, same inputs. The
    element-wise results to rtol 1e-6 / atol 1e-7, images exactly, the
    reductions (reservoir deltas, KEs) to rtol 1e-5: their sums run in
    another order."""
    jff, jm, jstate, tff, tm, _ = _build()
    x = _kernel_inputs(jstate, jm)
    n = x["pos"].shape[0]
    jplan = jfi.FusedIntegratorPlan(jff, jm, n, jnp.float32)
    tplan = tfi.FusedIntegratorPlan(tff, tm, n, torch.float32)
    mass = np.asarray(jstate.mass)
    mol = np.asarray(j_group_mask(jstate.typeid, jff.l_typeid, "molecular"))
    box = np.asarray(jstate.box_L)
    c = np.float32(np.exp(-x["dt"] / np.float32(TAU)))
    j_out = jfi.pre_force_apply(
        jplan, x["pos"], x["image"], x["vel"], x["forces"], mass, mol, box,
        x["dt"], c, KT, x["r1"], x["r_gamma"], interpret=True)
    t = torch.as_tensor
    t_out = tfi.pre_force_apply(
        tplan, t(x["pos"]), t(x["image"]), t(x["vel"]), t(x["forces"]),
        t(mass), t(mol), t(box), t(x["dt"]), t(c), KT, t(x["r1"]),
        t(x["r_gamma"]))
    assert np.any(np.asarray(j_out[1]) != x["image"])  # faces crossed
    np.testing.assert_array_equal(_np(t_out[1]), np.asarray(j_out[1]))
    for k in (0, 2):
        np.testing.assert_allclose(_np(t_out[k]), np.asarray(j_out[k]),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(t_out[3]), np.asarray(j_out[3]),
                               rtol=1e-5)

    v1 = np.asarray(j_out[2])
    c_ou = np.float32(np.exp(-np.float32(GAMMA) * x["dt"]))
    p = tplan.photon
    sig = np.float32(np.sqrt((1.0 - c_ou * c_ou) * np.float32(KT) / mass[p]))
    j_post = jfi.post_force_apply(
        jplan, v1, x["forces"], mass, mol, x["dt"], c_ou, sig,
        tuple(jnp.asarray(x["noise3"])), interpret=True)
    t_post = tfi.post_force_apply(
        tplan, t(v1), t(x["forces"]), t(mass), t(mol), t(x["dt"]), t(c_ou),
        t(sig), t(x["noise3"]).reshape(1, 3))
    np.testing.assert_allclose(_np(t_post[0]), np.asarray(j_post[0]),
                               rtol=1e-6, atol=1e-7)
    for k in (1, 2, 3):
        np.testing.assert_allclose(_np(t_post[k]), np.asarray(j_post[k]),
                                   rtol=1e-5)
    assert abs(float(t_post[3])) > 0


def _jax_fused(jff, jm, jstate, n_steps):
    step = j_make_step_fn(jff, jm, fuse_integrator=True)
    if n_steps == 1:
        return jax.jit(step)(jstate)
    return jax.jit(lambda s: j_run_steps(step, s, n_steps))(jstate)


@pytest.mark.parametrize("n_steps", [1, 8])
def test_fused_step_matches_jax_fused_step(n_steps):
    """(b) the port's fused step on the CPU, with the JAX package's noise
    injected, against make_step_fn(..., fuse_integrator=True) in JAX, at
    the JAX test's own tolerances: one step (test_fused_integrator.py:
    91-102) and 8 steps (:65-80)."""
    jff, jm, jstate, tff, tm, tstate = _build()
    step = make_step_fn(tff, tm, fuse_integrator=True,
                        noise=JaxNoise(jstate.key, jnp.float32))
    if n_steps == 1:
        j_fin, j_obs = _jax_fused(jff, jm, jstate, 1)
        t_fin, t_obs = step(tstate)
        np.testing.assert_allclose(_np(t_fin.position),
                                   np.asarray(j_fin.position),
                                   rtol=1e-6, atol=1e-7)
        for k in ("bussi_reservoir", "langevin_reservoir"):
            np.testing.assert_allclose(_np(getattr(t_fin, k)),
                                       np.asarray(getattr(j_fin, k)),
                                       rtol=1e-4, atol=1e-10)
        assert t_fin.step == int(j_fin.timestep) == 1
        return
    j_fin, j_obs = _jax_fused(jff, jm, jstate, n_steps)
    t_fin, t_obs = run_steps(step, tstate, n_steps)
    np.testing.assert_allclose(_np(t_fin.position),
                               np.asarray(j_fin.position),
                               rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(_np(t_fin.velocity),
                               np.asarray(j_fin.velocity),
                               rtol=3e-4, atol=1e-6)
    np.testing.assert_array_equal(_np(t_fin.image), np.asarray(j_fin.image))
    for k in j_obs:
        np.testing.assert_allclose(np.asarray(t_obs[k], np.float64),
                                   np.asarray(j_obs[k], np.float64),
                                   rtol=2e-3, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("langevin", [True, False])
def test_fused_step_matches_unfused_step(langevin):
    """(c) the port's fused step against its own unfused step, one step,
    float32, the same generator draws, to the single-step bounds of
    test_fused_integrator.py:91-102; and (d) the Bussi-only pattern
    (cavity NVE) fuses too, velocities to :113-116's bound."""
    _, _, _, tff, tm, tstate = _build(langevin=langevin)
    fin = {}
    for fuse in (True, False):
        state = tstate.replace(generators={})
        fin[fuse], _ = make_step_fn(tff, tm, fuse_integrator=fuse)(state)
    np.testing.assert_allclose(_np(fin[True].position),
                               _np(fin[False].position),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(fin[True].velocity),
                               _np(fin[False].velocity),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(_np(fin[True].image),
                                  _np(fin[False].image))
    for k in ("bussi_reservoir", "langevin_reservoir"):
        np.testing.assert_allclose(_np(getattr(fin[True], k)),
                                   _np(getattr(fin[False], k)),
                                   rtol=1e-4, atol=1e-10)


def test_bussi_only_pattern_matches_jax_fused():
    """(d) Bussi on the molecules with an NVE photon: the port's fused step
    against the JAX package's fused step, injected noise, velocities to
    the bound of test_fused_integrator.py:113-116."""
    jff, jm, jstate, tff, tm, tstate = _build(langevin=False)
    j_fin, _ = _jax_fused(jff, jm, jstate, 1)
    step = make_step_fn(tff, tm, fuse_integrator=True,
                        noise=JaxNoise(jstate.key, jnp.float32))
    t_fin, _ = step(tstate)
    np.testing.assert_allclose(_np(t_fin.velocity),
                               np.asarray(j_fin.velocity),
                               rtol=1e-5, atol=1e-7)


def test_unsupported_pattern_true_raises_none_runs_unfused():
    """(e) Brownian molecules (a pattern neither package fuses):
    fuse_integrator=True raises with the JAX text in both packages; None
    runs the unfused step; on CPU tensors None never fuses, even for the
    supported pattern (it gives the unfused step's bits)."""
    jff, jm, jstate, tff, tm, tstate = _build(molecular="brownian")
    with pytest.raises(ValueError, match="fused integrator") as j_err:
        jax.jit(j_make_step_fn(jff, jm, fuse_integrator=True))(jstate)
    with pytest.raises(ValueError, match="fused integrator") as t_err:
        make_step_fn(tff, tm, fuse_integrator=True)(tstate)
    assert str(t_err.value) == str(j_err.value)
    s_auto, _ = make_step_fn(tff, tm)(tstate.replace(generators={}))
    s_off, _ = make_step_fn(tff, tm, fuse_integrator=False)(
        tstate.replace(generators={}))
    np.testing.assert_array_equal(_np(s_auto.position), _np(s_off.position))

    _, _, _, tff, tm, tstate = _build()
    s_auto, _ = make_step_fn(tff, tm)(tstate.replace(generators={}))
    s_off, _ = make_step_fn(tff, tm, fuse_integrator=False)(
        tstate.replace(generators={}))
    np.testing.assert_array_equal(_np(s_auto.velocity), _np(s_off.velocity))


def test_true_on_float64_runs_unfused():
    """The fused step is float32-only in both packages: True on a float64
    state runs the unfused step (the JAX step's dtype test, integrator.py
    :414-415), giving its bits."""
    js = j_add(j_make(10, box_L=25.0, temperature_K=100.0, seed=0,
                      dtype=np.float64),
               coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1)
    jff = JForceField.create(js, coupling=1e-3, freq_cm1=2000.0,
                             pppm_mesh=(8, 8, 8), r_cut=8.0)
    jm = j_resolve_methods(js, _specs(JMethodSpec), jff.l_typeid)
    jstate = j_init_state(js, jff, dt=PC.fs_to_atomic_units(0.5), seed=7)
    tff = port_forcefield(jff, js, dtype=torch.float64)
    tm = resolve_methods(_port_snapshot(js), _specs(MethodSpec),
                         tff.l_typeid)
    fin = {}
    for fuse in (True, False):
        state = port_state(jstate, seed=7)
        assert state.position.dtype == torch.float64
        fin[fuse], _ = make_step_fn(tff, tm, fuse_integrator=fuse)(state)
    np.testing.assert_array_equal(_np(fin[True].velocity),
                                  _np(fin[False].velocity))


def test_wrappers_reject_devices_without_a_kernel():
    """A tensor on neither the CPU nor a CUDA device gets no twin."""
    _, _, _, tff, tm, tstate = _build()
    plan = tfi.FusedIntegratorPlan(tff, tm, tstate.position.shape[0],
                                   torch.float32)
    meta = tstate.position.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfi.pre_force_apply(plan, meta, meta, meta, meta, meta, meta, meta,
                            meta, meta, KT, meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tfi.post_force_apply(plan, meta, meta, meta, meta, meta, meta, meta,
                             meta)
