"""Replica batching of cavmd_tpu_torch against cavmd_tpu.parallel.replicas
(float64, CPU): each batched op against ``jax.vmap`` of the JAX op, the
batched step against JAX's ``run_replica_steps`` and against B one-replica
runs of the port with the same draws, ``init_replica_states`` and its
guards, ``split_replica_obs``, and the ``--vmap-replicas`` CLI with its
overflow retry.

The scene is the replica example's (``examples/03_replicas_vmap.py``: 50
O2/N2 + photon in a 30-bohr box), on a 16^3 mesh with r_cut 12, with
B = 3 replicas whose positions carry their own seeded jitter. The JAX
references run under one ``jax.jit`` each and are shared in module
fixtures."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cavmd_tpu.core import PhysicalConstants as PC
from cavmd_tpu.integrate import ForceField as JForceField
from cavmd_tpu.integrate import MethodSpec as JMethodSpec
from cavmd_tpu.integrate import make_step_fn as j_make_step_fn
from cavmd_tpu.integrate import resolve_methods as j_resolve_methods
from cavmd_tpu.integrate.adaptive import compute_optimal_dt as j_opt_dt
from cavmd_tpu.integrate.adaptive import make_adaptive_step as j_adaptive
from cavmd_tpu.integrate.rng import STREAM_BUSSI, STREAM_LANGEVIN, stream_key
from cavmd_tpu.integrate.thermostats import bussi_noise as j_bussi_noise
from cavmd_tpu.observe import CavityModeTracker as JCavityModeTracker
from cavmd_tpu.observe import EnergyTracker as JEnergyTracker
from cavmd_tpu.ops import bonds as jbonds
from cavmd_tpu.ops import cavity as jcavity
from cavmd_tpu.ops import ewald as jewald
from cavmd_tpu.ops import lj as jlj
from cavmd_tpu.ops import pppm as jpppm
from cavmd_tpu.parallel import init_replica_states as j_init_replicas
from cavmd_tpu.parallel import run_replica_steps as j_run_replica_steps
from cavmd_tpu_torch.drivers import advanced_run as t_cli
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
from cavmd_tpu_torch.integrate.adaptive import (
    compute_optimal_dt,
    make_adaptive_step,
)
from cavmd_tpu_torch.integrate.integrator import thermal_velocities
from cavmd_tpu_torch.interop import state_from_numpy
from cavmd_tpu_torch.io import open_gsd
from cavmd_tpu_torch.observe import make_extra_obs
from cavmd_tpu_torch.ops import bonds as tbonds
from cavmd_tpu_torch.ops import cavity as tcavity
from cavmd_tpu_torch.ops import ewald as tewald
from cavmd_tpu_torch.ops import fused_integrator as tfi
from cavmd_tpu_torch.ops import pair_kernels as tpk
from cavmd_tpu_torch.ops import pppm as tpppm
from cavmd_tpu_torch.parallel import (
    init_replica_states,
    make_replica_step,
    run_replica_steps,
    split_replica_obs,
)
from cavmd_tpu_torch.parallel.replicas import PER_REPLICA

from test_torch_ops import port_forcefield, scene

B = 3
DT = PC.fs_to_atomic_units(0.25)
KT = PC.kT_from_kelvin(100.0)
TAU = PC.ps_to_atomic_units(5.0)
GAMMA = PC.gamma_from_tau_ps(5.0)
FF_KW = dict(coupling=1e-3, freq_cm1=2000.0, pppm_mesh=(16, 16, 16),
             r_cut=12.0)
TOL_OP = 1e-10    # each op against jax.vmap of the JAX op
TOL_TRAJ = 1e-9   # 20 steps against JAX, of each quantity's scale
TOL_SELF = 1e-12  # the batch against one-replica port runs


def _t(x, dtype=torch.float64):
    return torch.tensor(np.asarray(x), dtype=dtype)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: its tensors are small, and the
    suite runs six workers on the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def world():
    """The scene in both packages, the port ForceField from the JAX one's
    leaves, and B jittered copies of the positions."""
    js, ts = scene(n_mol=50, box_L=30.0, seed=0, jitter=0.0)
    jff = JForceField.create(js, **FF_KW)
    tff = port_forcefield(jff, js)
    rng = np.random.default_rng(21)
    pos = np.asarray(js.position)[None] + rng.normal(
        scale=0.05, size=(B,) + tuple(js.position.shape))
    snaps = [js.replace(position=jnp.asarray(p)) for p in pos]
    return dict(js=js, ts=ts, jff=jff, tff=tff, pos=pos, snaps=snaps)


def _methods(kind):
    if kind == "port":
        return (MethodSpec(kind="bussi", group="molecular", kT=KT, tau=TAU),
                MethodSpec(kind="langevin", group="cavity", kT=KT,
                           gamma=GAMMA))
    return (JMethodSpec(kind="bussi", group="molecular", kT=KT, tau=TAU),
            JMethodSpec(kind="langevin", group="cavity", kT=KT, gamma=GAMMA))


def _close(t, j, tol, what=""):
    j = np.asarray(j, dtype=np.float64)
    t = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
    scale = max(float(np.abs(j).max()), 1e-300)
    np.testing.assert_allclose(np.asarray(t, np.float64), j, rtol=0,
                               atol=tol * scale, err_msg=what)


# ------------------------------------------------------------ 1. the ops
@pytest.fixture(scope="module")
def jax_ops(world):
    """Every op of the dense force pass, ``jax.vmap``ped over the replica
    axis of the positions, under one jit."""
    js, jff = world["js"], world["jff"]
    box, q = js.box_L, js.charge
    nb = js.n_bonds
    qq = q[:, None] * q[None, :]

    def ops(P, I):
        bonds = jax.vmap(lambda p: jbonds.harmonic_bond_force_strided(
            p, box, nb, jff.bond_k[js.bond_typeid],
            jff.bond_r0[js.bond_typeid]))(P)
        pair = jax.vmap(lambda p: jlj.fused_pair_force(
            p, box, jff.lj_pair, qq, jff.coulomb_active, jff.kappa,
            jff.coulomb_rcut))(P)
        pppm = jpppm.pppm_force_and_energy_batched(
            P, q, box, jff.pppm, jff.pppm_order, jff.pppm_mesh)
        excl = jax.vmap(lambda p: jewald.ewald_exclusion_correction_strided(
            p, box, q, jff.kappa, nb))(P)
        cav = jax.vmap(lambda p, i: jcavity.cavity_force(
            p, i, box, q, js.typeid, jff.l_typeid, jff.cavity))(P, I)
        whole = jax.vmap(lambda p, i: jff.compute(
            p, i, box, q, js.typeid, js.bond_group, js.bond_typeid))(P, I)
        return dict(bonds=bonds, pair=pair, pppm=pppm, excl=excl, cav=cav,
                    whole=whole)

    image = np.zeros(world["pos"].shape, np.int32)
    image[1, :5, 0] = 1  # some unwrapped rows for the dipole
    out = jax.jit(ops)(jnp.asarray(world["pos"]), jnp.asarray(image))
    return out, image


def test_batched_ops_match_jax_vmap(world, jax_ops):
    ref, image = jax_ops
    ts, tff = world["ts"], world["tff"]
    P, I = _t(world["pos"]), torch.tensor(image)
    box, q, tid = ts.box_L, ts.charge, ts.typeid
    nb = ts.n_bonds

    f, e = tbonds.harmonic_bond_force_strided(P, box, nb, tff.bond_k_per,
                                              tff.bond_r0_per)
    assert e.shape == (B,)
    _close(f, ref["bonds"][0], TOL_OP, "bonds F")
    _close(e, ref["bonds"][1], TOL_OP, "bonds E")

    f, elj, eew = tpk.dense_pair_force(
        P, box, tid, tff.lj_eps, tff.lj_sig2, tff.lj_rcut2, tff.lj_vshift, q,
        tff.lj_active, tff.coulomb_active, tff.kappa_value,
        tff.coulomb_rcut ** 2)
    assert f.shape == (B, ts.N, 3) and elj.shape == eew.shape == (B,)
    for got, want, what in zip((f, elj, eew), ref["pair"], ("F", "LJ", "EW")):
        _close(got, want, TOL_OP, f"pair {what}")

    f, e = tpppm.pppm_force_and_energy(P, q, box, tff.pppm, tff.pppm_order,
                                       tff.pppm_mesh)
    assert e.shape == (B,) and not f.requires_grad
    _close(f, ref["pppm"][0], TOL_OP, "pppm F")
    _close(e, ref["pppm"][1], TOL_OP, "pppm E")

    f, e = tewald.ewald_exclusion_correction_strided(P, box, q, tff.kappa, nb)
    _close(f, ref["excl"][0], TOL_OP, "exclusion F")
    _close(e, ref["excl"][1], TOL_OP, "exclusion E")

    f, e = tcavity.cavity_force(P, I, box, q, tid, tff.l_typeid, tff.cavity)
    _close(f, ref["cav"][0], TOL_OP, "cavity F")
    for k in ("harmonic", "coupling", "dipole_self"):
        assert e[k].shape == (B,)
        _close(e[k], ref["cav"][1][k], TOL_OP, f"cavity {k}")

    f, e = tff(P, I, box, q, tid)
    _close(f, ref["whole"][0], TOL_OP, "ForceField F")
    for k, v in ref["whole"][1].items():
        assert e[k].shape == (B,), k
        _close(e[k], v, TOL_OP, f"ForceField {k}")
    # a replica of the batch is the one-replica call
    f1, e1 = tff(P[1], I[1], box, q, tid)
    _close(f[1], f1.numpy(), TOL_SELF, "replica 1 F")


def test_batched_fused_tail_twins_match_one_replica_calls(world):
    """K4's and K5's plain twins on a batch: each replica's outputs are
    those of the one-replica call on its rows."""
    ts, tff = world["ts"], world["tff"]
    methods = resolve_methods(ts, _methods("port"), tff.l_typeid)
    plan = tfi.FusedIntegratorPlan(tff, methods, ts.N, torch.float64)
    rng = np.random.default_rng(5)
    P = _t(world["pos"])
    V = _t(rng.normal(scale=1e-4, size=P.shape))
    F, _ = tff(P, torch.zeros(P.shape, dtype=torch.int32), ts.box_L,
               ts.charge, ts.typeid)
    img = torch.zeros(P.shape, dtype=torch.int32)
    mol = ts.typeid != tff.l_typeid
    dt, r1, rg = (_t(rng.uniform(0.5, 1.5, B) * DT), _t(rng.normal(size=B)),
                  _t(rng.uniform(250.0, 350.0, B)))
    c = torch.exp(-dt / TAU)
    c_ou = torch.exp(-GAMMA * dt)
    sig = torch.sqrt((1 - c_ou * c_ou) * KT / ts.mass[plan.photon])
    xi = _t(rng.normal(size=(B, 1, 3)))
    pre = tfi.pre_force_apply(plan, P, img, V, F, ts.mass, mol, ts.box_L, dt,
                              c, KT, r1, rg)
    post = tfi.post_force_apply(plan, V, F, ts.mass, mol, dt, c_ou, sig, xi)
    assert pre[3].shape == post[1].shape == post[3].shape == (B,)
    for r in range(B):
        one = tfi.pre_force_apply(plan, P[r], img[r], V[r], F[r], ts.mass,
                                  mol, ts.box_L, dt[r], c[r], KT, r1[r],
                                  rg[r])
        for got, want in zip(pre, one):
            np.testing.assert_allclose(got[r].numpy(), want.numpy(),
                                       rtol=TOL_SELF, atol=0)
        one = tfi.post_force_apply(plan, V[r], F[r], ts.mass, mol, dt[r],
                                   c_ou[r], sig[r], xi[r])
        for got, want in zip(post, one):
            np.testing.assert_allclose(got[r].numpy(), want.numpy(),
                                       rtol=TOL_SELF, atol=0)


# ------------------------------------------- 2-3. the batched trajectory
@functools.lru_cache(maxsize=None)
def _j_draws(kind, i, dof=0.0, shape=()):
    """JAX's draws of one (stream, method) at one step for every replica
    key (the draws ``jax.vmap`` of the JAX step makes), jitted once."""
    if kind == "bussi":
        def one(key, step):
            return j_bussi_noise(stream_key(key, STREAM_BUSSI, step, i), dof,
                                 jnp.float64)
    else:
        def one(key, step):
            return jax.random.normal(stream_key(key, STREAM_LANGEVIN, step,
                                                i), shape, dtype=jnp.float64)
    return jax.jit(jax.vmap(one, in_axes=(0, None)))


class ReplicaJaxNoise:
    """Hands each replica the JAX package's own per-replica draws (each
    replica's key), stacked on the replica axis; with ``replica`` the rows
    of that replica alone, for a one-replica run."""

    def __init__(self, keys, replica=None):
        self.keys = keys
        self.replica = replica

    def _t(self, x, state):
        x = np.asarray(x)
        x = x if self.replica is None else x[self.replica]
        return torch.tensor(x, dtype=state.position.dtype)

    def bussi(self, state, i, m):
        r1, rg = _j_draws("bussi", i, float(m.dof))(self.keys, state.step)
        return self._t(r1, state), self._t(rg, state)

    def langevin(self, state, i, m, shape):
        per = tuple(shape[len(state.batch_shape):])
        return self._t(_j_draws("langevin", i, shape=per)(self.keys,
                                                          state.step), state)


def _port_batch(jstate, dtype=torch.float64):
    names = ("position", "image", "velocity", "mass", "charge", "typeid",
             "box_L", "forces", "dt", "time_au", "time_comp", "timestep",
             "bussi_reservoir", "bussi_instantaneous", "langevin_reservoir",
             "error_tolerance")
    return state_from_numpy(**{k: np.asarray(getattr(jstate, k))
                               for k in names}, seed=3, dtype=dtype,
                            device="cpu")


ADAPTIVE = dict(error_tolerance=1.0, time_constant_ps=0.002, period=5)


@pytest.fixture(scope="module")
def jax_traj(world):
    """JAX's 20 batched steps (Bussi + Langevin) from the B jittered
    snapshots, fixed dt and adaptive (each replica bootstrapped from its
    own forces, as the JAX driver does)."""
    jff = world["jff"]
    jm = j_resolve_methods(world["js"], _methods("jax"), jff.l_typeid)
    out = {}
    for adaptive in (False, True):
        jstate = j_init_replicas(world["snaps"], jff, dt=DT, seed=3,
                                 error_tolerance=1.0 if adaptive else 0.0)
        step = j_make_step_fn(jff, jm)
        if adaptive:
            jstate = jstate.replace(dt=jax.vmap(
                lambda f, m: j_opt_dt(f, m, 1e-3))(jstate.forces,
                                                   jstate.mass))
            step = j_adaptive(step, **ADAPTIVE)
        final, obs = jax.jit(lambda s: j_run_replica_steps(step, s, 20))(
            jstate)
        out[adaptive] = (jstate, final, obs)
    return out


def _port_step(world, noise, adaptive, fuse=None):
    tff = world["tff"]
    tm = resolve_methods(world["ts"], _methods("port"), tff.l_typeid)
    step = make_step_fn(tff, tm, noise=noise, fuse_integrator=fuse)
    return make_adaptive_step(step, **ADAPTIVE) if adaptive else step


@pytest.mark.parametrize("adaptive", [False, True])
def test_batched_trajectory_matches_jax_run_replica_steps(world, jax_traj,
                                                          adaptive):
    """20 batched Bussi + Langevin steps with JAX's per-replica draws:
    positions, velocities, images and every observable column to 1e-9 of
    scale; with adaptive dt each replica's dt and tolerance too."""
    jstate, jfinal, jobs = jax_traj[adaptive]
    start = _port_batch(jstate)
    if adaptive:
        start = start.replace(dt=compute_optimal_dt(start.forces, start.mass,
                                                    1e-3))
        _close(start.dt, jstate.dt, 1e-12, "bootstrap dt")
    step = _port_step(world, ReplicaJaxNoise(jstate.key), adaptive)
    final, obs = run_replica_steps(step, start, 20)
    for k in ("position", "velocity"):
        _close(getattr(final, k), getattr(jfinal, k), TOL_TRAJ, k)
    np.testing.assert_array_equal(final.image.numpy(),
                                  np.asarray(jfinal.image))
    keys = OBS_KEYS + (("error_tolerance",) if adaptive else ())
    for k in keys:
        assert obs[k].shape == (20, B), k
        _close(obs[k], jobs[k], TOL_TRAJ, k)
    np.testing.assert_array_equal(
        obs["timestep"], np.broadcast_to(np.arange(1, 21)[:, None], (20, B)))
    if adaptive:  # each replica on its own clock
        assert len(np.unique(obs["dt"][-1])) == B


@pytest.mark.parametrize("dtype,fuse,tol", [
    (torch.float64, False, TOL_SELF), (torch.float32, True, 1e-5)])
def test_batch_matches_one_replica_runs(world, jax_traj, dtype, fuse, tol):
    """The batch against B one-replica runs of the port with the same
    draws: 1e-12 of scale in float64 (the unfused step); in float32 the
    fused tail's plain twins, whose sums over a batch may round apart from
    one replica's, to 1e-5."""
    jstate = jax_traj[False][0]
    start = _port_batch(jstate, dtype)
    final, obs = run_steps(_port_step(world, ReplicaJaxNoise(jstate.key),
                                      False, fuse), start, 20)
    for r in range(B):
        one = start.replace(**{k: getattr(start, k)[r] for k in PER_REPLICA})
        fr, obs_r = run_steps(_port_step(
            world, ReplicaJaxNoise(jstate.key, replica=r), False, fuse),
            one, 20)
        _close(final.position[r], fr.position.numpy(), tol, f"{r} position")
        _close(final.velocity[r], fr.velocity.numpy(), tol, f"{r} velocity")
        assert torch.equal(final.image[r], fr.image)
        for k in OBS_KEYS:
            _close(obs[k][:, r], obs_r[k], tol, f"{r} {k}")


BATH_TAU = PC.ps_to_atomic_units(0.05)


def _bath_methods(bath, mod):
    return (mod(kind=bath, group="molecular", kT=KT, tau=BATH_TAU),
            mod(kind="langevin", group="cavity", kT=KT, gamma=GAMMA))


@pytest.fixture(scope="module")
def jax_bath_traj(world):
    """JAX's batch (``run_replica_steps``, jax.vmap of the step) with
    MTTK or Berendsen on the molecules and Langevin on the photon, from
    the B jittered snapshots: 10 steps, then 10 more."""
    jff = world["jff"]
    out = {}
    for bath in ("mttk", "berendsen"):
        jm = j_resolve_methods(world["js"], _bath_methods(bath, JMethodSpec),
                               jff.l_typeid)
        step = j_make_step_fn(jff, jm)
        run10 = jax.jit(lambda s: j_run_replica_steps(step, s, 10))
        jstate = j_init_replicas(world["snaps"], jff, dt=DT, seed=3)
        mid, _ = run10(jstate)
        final, obs = run10(mid)
        out[bath] = (jstate, mid, final, obs)
    return out


def _bath_batch(jstate):
    return _port_batch(jstate).replace(
        mttk_xi=_t(jstate.mttk.xi), mttk_eta=_t(jstate.mttk.eta))


@pytest.mark.parametrize("bath", ["mttk", "berendsen"])
def test_bath_batch_matches_jax_and_one_replica_runs(world, jax_bath_traj,
                                                     bath):
    """A B = 3 batch with MTTK or Berendsen (each replica's own KE, T and
    factor): 20 steps from JAX's start against B one-replica port runs
    with the same draws to 1e-12 of scale, and against JAX's
    ``run_replica_steps`` to 1e-9; from JAX's batch after 10 steps, (B, 2)
    (xi, eta) carried across by ``state_from_numpy``, 10 more steps
    against JAX's to 1e-9."""
    jstate, jmid, jfinal, jobs = jax_bath_traj[bath]
    tff = world["tff"]
    tm = resolve_methods(world["ts"], _bath_methods(bath, MethodSpec),
                         tff.l_typeid)
    start = _bath_batch(jstate)
    assert start.mttk_xi.shape == (B, 2)
    final, obs = run_replica_steps(
        make_step_fn(tff, tm, noise=ReplicaJaxNoise(jstate.key)), start, 20)
    for k in ("position", "velocity"):
        _close(getattr(final, k), getattr(jfinal, k), TOL_TRAJ, k)
    _close(final.mttk_xi, jfinal.mttk.xi, TOL_TRAJ, "xi")
    _close(final.mttk_eta, jfinal.mttk.eta, TOL_TRAJ, "eta")
    for k in OBS_KEYS:
        _close(obs[k][10:], jobs[k], TOL_TRAJ, k)
    for r in range(B):
        one = start.replace(**{k: getattr(start, k)[r] for k in PER_REPLICA})
        fr, obs_r = run_steps(make_step_fn(
            tff, tm, noise=ReplicaJaxNoise(jstate.key, replica=r)), one, 20)
        for k in ("position", "velocity", "mttk_xi", "mttk_eta"):
            _close(getattr(final, k)[r], getattr(fr, k).numpy(), TOL_SELF,
                   f"{r} {k}")
        for k in OBS_KEYS:
            _close(obs[k][:, r], obs_r[k], TOL_SELF, f"{r} {k}")
    mid = _bath_batch(jmid)
    if bath == "mttk":
        assert (mid.mttk_xi[:, 0] != 0).all()
        assert len(torch.unique(final.mttk_xi[:, 0])) == B
    fin2, obs2 = run_replica_steps(
        make_step_fn(tff, tm, noise=ReplicaJaxNoise(jstate.key)), mid, 10)
    for k in ("position", "velocity"):
        _close(getattr(fin2, k), getattr(jfinal, k), TOL_TRAJ, k)
    _close(fin2.mttk_xi, jfinal.mttk.xi, TOL_TRAJ, "xi after the carry")
    for k in OBS_KEYS:
        _close(obs2[k], jobs[k], TOL_TRAJ, k)


# ------------------------------------------------ 4. init_replica_states
def test_init_replica_states_matches_jax(world):
    jff, tff, ts = world["jff"], world["tff"], world["ts"]
    jstate = j_init_replicas(world["snaps"], jff, dt=DT, seed=3)
    tsnaps = [ts.replace(position=_t(p)) for p in world["pos"]]
    state = init_replica_states(tsnaps, tff, dt=DT, seed=3)
    assert state.batch_shape == (B,) and state.mass.shape == (ts.N,)
    for k in ("position", "velocity", "forces", "dt", "time_au",
              "bussi_reservoir", "langevin_reservoir", "error_tolerance"):
        _close(getattr(state, k), getattr(jstate, k), TOL_OP, k)
    np.testing.assert_array_equal(state.image.numpy(),
                                  np.asarray(jstate.image))
    np.testing.assert_array_equal(state.timestep.numpy(), np.zeros(B))

    # with kT: replica r is the port's one-replica thermalization at seed + r
    state = init_replica_states(ts, tff, n_replicas=B, dt=DT, seed=3, kT=KT)
    for r in range(B):
        v = thermal_velocities(ts.mass, ts.typeid, tff.l_typeid, KT, 3 + r)
        assert torch.equal(state.velocity[r], v)
    assert not torch.equal(state.velocity[0], state.velocity[1])


def test_init_replica_states_guards(world):
    ts, tff = world["ts"], world["tff"]
    other_box = ts.replace(box_L=ts.box_L * 1.01)
    with pytest.raises(ValueError, match="box"):
        init_replica_states([ts, other_box], tff, dt=DT)
    charge = ts.charge.clone()
    charge[0], charge[1] = charge[1], charge[0]
    with pytest.raises(ValueError, match="topology"):
        init_replica_states([ts, ts.replace(charge=charge)], tff, dt=DT)
    shorter = ts.replace(position=ts.position[:-1])
    with pytest.raises(ValueError, match="topology"):
        init_replica_states([ts, shorter], tff, dt=DT)
    # a cell-mode force field passes the guards: the batch carries its
    # list, and the step and the forces take it
    cell_ff = tff.__class__.create(ts, pair_mode="cell", r_cut=12.0,
                                   pppm_mesh=(16, 16, 16))
    batch = init_replica_states(ts, cell_ff, n_replicas=2, dt=DT)
    assert batch.cell_list.bucket_idx.shape[0] == 2
    tm = resolve_methods(ts, _methods("port"), cell_ff.l_typeid)
    step = make_step_fn(cell_ff, tm)
    assert make_replica_step(step) is step
    f, e = cell_ff(batch.position, batch.image, ts.box_L, ts.charge,
                   ts.typeid)
    assert f.shape == batch.position.shape and e["lj"].shape == (2,)


# ----------------------------------------- 5. the port's own draws, split
def test_replicas_decorrelate_and_split(world):
    """From one start with the port's own streams the replicas part ways
    (one draw call a stream and step gives each replica its own rows), the
    universe energy holds, and ``split_replica_obs`` gives B dicts of the
    one-replica shapes, vector observables included."""
    ts, tff = world["ts"], world["tff"]
    tm = resolve_methods(ts, _methods("port"), tff.l_typeid)
    extra = make_extra_obs(dipole=True, wavevectors=np.eye(3) * 0.5)
    state = init_replica_states(ts, tff, n_replicas=B, dt=DT, seed=11)
    assert torch.equal(state.position[0], state.position[1])
    final, obs = run_replica_steps(make_step_fn(tff, tm, extra_obs=extra),
                                   state, 10)
    assert not torch.equal(final.position[0], final.position[1])
    assert not torch.equal(final.position[1], final.position[2])
    assert obs["dipole"].shape == (10, B, 3)
    assert obs["rho_k_re"].shape == (10, B, 3)
    U = universe_energy(obs)
    assert np.abs(U - U[0]).max() < 1e-5
    per = split_replica_obs(obs, B)
    assert len(per) == B
    one_state = init_state(ts, tff, dt=DT, seed=11)
    _, one = run_steps(make_step_fn(tff, tm, extra_obs=extra), one_state, 10)
    for o in per:
        assert set(o) == set(one)
        for k in one:
            assert o[k].shape == one[k].shape, k
    np.testing.assert_array_equal(per[2]["dipole"], obs["dipole"][:, 2])


# ------------------------------------------------------------- 6. the CLI
def test_vmap_replicas_cli(tmp_path, monkeypatch):
    """``--vmap-replicas --replicas 1-3`` on the CPU: exit 0, each replica's
    files with the JAX package's headers, its GSD read back, its rows up
    to --runtime, and its universe energy held."""
    monkeypatch.chdir(tmp_path)
    rc = t_cli.main(["--device", "CPU", "--vmap-replicas", "--replicas",
                     "1-3", "--n-molecules", "10", "--runtime", "0.004",
                     "--enable-fkt", "--energy-output-period-ps", "0.0002",
                     "--fkt-output-period-ps", "0.0002",
                     "--gsd-output-period-ps", "0.002", "--seed", "2"])
    assert rc == 0
    out = tmp_path / "cavity_coupling_1eneg03"
    ref = tmp_path / "jax_headers"
    ref.mkdir()
    monkeypatch.chdir(ref)
    for r in (1, 2, 3):
        JEnergyTracker(output_prefix=f"prod-{r}", output_period_steps=2,
                       n_molecular_dof=60)
        JCavityModeTracker(output_prefix=f"prod-{r}", output_period_steps=2)
        for suffix in ("energy_tracker", "cavity_mode"):
            name = f"prod-{r}_{suffix}.txt"
            want = (ref / name).read_text().splitlines()
            got = (out / name).read_text().splitlines()
            assert got[:len(want)] == want, name
        rows = np.loadtxt(out / f"prod-{r}_energy_tracker.txt",
                          comments=("#", "time"), ndmin=2)
        assert rows.shape[0] >= 3 and rows.shape[1] == 20
        assert rows[-1, 0] <= 0.004 + 1e-4
        assert np.abs(rows[:, 18] - rows[0, 18]).max() < 1e-4
        ref0 = (out / f"prod-{r}_ref0.txt").read_text().splitlines()
        assert ref0[0] == "# Density_correlation field autocorrelation"
        dip = (out / f"prod-{r}_dipole_autocorr_0.txt").read_text()
        assert dip.splitlines()[:2] == ["# Dipole autocorrelation data",
                                        "# Reference number: 0"]
        with open_gsd(str(out / f"prod-{r}.gsd")) as t:
            assert len(t) >= 3
            frame = t.read_frame(len(t) - 1, device="cpu")
            assert frame.N == 21 and bool(torch.isfinite(frame.position)
                                          .all())


@pytest.mark.parametrize("flags", [
    ["--shard-replicas", "2", "--shard-atoms", "2", "--replicas", "1-2"],
    ["--vmap-replicas", "--shard-atoms", "4", "--n-molecules", "10000"],
    ["--vmap-replicas", "--shard-atoms", "2"]])
def test_vmap_cli_refusals_exit_2(tmp_path, monkeypatch, capsys, flags):
    """A batch over slabs, sharded over ranks or not (in cell mode, past
    the dense limit, and at the default size), runs one process a slab:
    without a process group of the right size it exits 2 before any work,
    naming torch.distributed.run and ROADMAP.md (the JAX driver's
    one-process GSPMD mesh is not ported). It runs on ranks in
    tests/test_torch_batched_slabs.py."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert t_cli.main(["--device", "CPU"] + flags) == 2
    err = capsys.readouterr().err
    assert flags[0] in err and "ROADMAP.md" in err
    assert "torch.distributed.run" in err
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("n_molecules", ["2048", "10000"])
def test_vmap_replicas_past_the_dense_limit_is_not_refused(n_molecules):
    """A batch past the dense limit (2048 molecules and the photon:
    N = 4097; N = 20,001) runs in cell mode: ``unported_flags`` refuses
    nothing."""
    args = t_cli.build_parser().parse_args(
        ["--device", "CPU", "--vmap-replicas", "--replicas", "1-8",
         "--n-molecules", n_molecules])
    assert t_cli.unported_flags(args) == []


def test_vmap_replicas_cell_overflow_recovery(tmp_path, monkeypatch,
                                              caplog):
    """The port's counterpart of tests/test_driver.py's
    test_vmap_replicas_cell_overflow_recovery: cell mode with cap 2 and
    r_cut 7, 24 molecules, replicas 1-2. The batch overflows, the chunk
    loop re-plans the capacity (2 -> 6 -> 12) and retries; the run exits 0
    with finite frames and no overflow left in the energy rows."""
    real_create = ForceField.create

    def crippled_create(snapshot, **kw):
        if kw.get("enable_cavity", True):
            kw.setdefault("pair_mode", "cell")
            kw.setdefault("cell_cap", 2)
            kw.setdefault("r_cut", 7.0)
        return real_create(snapshot, **kw)

    monkeypatch.setattr(ForceField, "create", staticmethod(crippled_create))
    monkeypatch.chdir(tmp_path)
    with caplog.at_level("WARNING"):
        rc = t_cli.main(["--device", "CPU", "--vmap-replicas", "--replicas",
                         "1-2", "--runtime", "0.002", "--n-molecules", "24",
                         "--energy-output-period-ps", "0.0005",
                         "--gsd-output-period-ps", "0.001"])
    assert rc == 0
    caps = [int(m.split("cap=")[1].split(",")[0]) for m in caplog.messages
            if "re-planned with cap=" in m]
    assert caps[:2] == [6, 12]
    out = tmp_path / "cavity_coupling_1eneg03"
    for r in (1, 2):
        with open_gsd(str(out / f"prod-{r}.gsd")) as t:
            assert len(t) >= 2
            frame = t.read_frame(len(t) - 1, device="cpu")
            assert frame.N == 49
            assert bool(torch.isfinite(frame.position).all())
        rows = np.loadtxt(out / f"prod-{r}_energy_tracker.txt",
                          comments=("#", "time"), ndmin=2)
        assert rows.shape[0] >= 2 and np.isfinite(rows).all()
