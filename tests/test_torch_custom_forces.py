"""User custom forces (``ForceField.create(custom_forces=...)``, the
``hoomd.md.force.Custom`` counterpart) in cavmd_tpu_torch against the JAX
package's (``cavmd_tpu/integrate/forcefield.py:351-354``), float64 on the
CPU.

The same callables are written twice, in ``jax.numpy`` and in ``torch``: a
harmonic trap on the positions, a uniform external field on the charges
(``F_i = q_i E``, ``U = -sum_i q_i E . (r_i + image_i L)``, which reads all
five arguments) and an anharmonic well whose forces come from
``jax.grad`` / ``torch.func.grad``. The scene is
tests/test_torch_zcol.py's 40 O2/N2 diatomics + photon in a 36-bohr box
(3 x 3 columns at r_cut 11.95); the port's zcol mode is held against JAX's
cell mode, whose f64 pair pass runs in f64 (ROADMAP.md Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cavmd_tpu.core import PhysicalConstants as PC
from cavmd_tpu.core.snapshot import Snapshot as JSnapshot
from cavmd_tpu.integrate import ForceField as JForceField
from cavmd_tpu.integrate import MethodSpec as JMethodSpec
from cavmd_tpu.integrate import init_state as j_init_state
from cavmd_tpu.integrate import make_step_fn as j_make_step_fn
from cavmd_tpu.integrate import resolve_methods as j_resolve_methods
from cavmd_tpu.integrate import run_steps as j_run_steps
from cavmd_tpu.integrate import universe_energy as j_universe_energy
from cavmd_tpu.integrate.rng import master_key
from cavmd_tpu.observe import EnergyTracker as JEnergyTracker
from cavmd_tpu.parallel import init_replica_states as j_init_replicas
from cavmd_tpu.parallel import make_replica_step as j_make_replica_step
from cavmd_tpu_torch import Simulation
from cavmd_tpu_torch.core import Snapshot
from cavmd_tpu_torch.core import make_diatomic_system as t_make
from cavmd_tpu_torch.integrate import (
    OBS_KEYS,
    ForceField,
    MethodSpec,
    init_state,
    make_step_fn,
    potential_energy,
    resolve_methods,
    run_steps,
    universe_energy,
)
from cavmd_tpu_torch.interop import state_from_numpy
from cavmd_tpu_torch.observe import EnergyTracker
from cavmd_tpu_torch.parallel import domain as td
from cavmd_tpu_torch.parallel import (
    run_replica_steps,
    split_replica_obs,
)
from cavmd_tpu_torch.parallel.replicas import PER_REPLICA

from test_torch_integrate import JaxNoise
from test_torch_ops import scene
from test_torch_replicas import ReplicaJaxNoise

KT = PC.kT_from_kelvin(100.0)
TAU = PC.ps_to_atomic_units(5.0)
GAMMA = PC.gamma_from_tau_ps(5.0)
DT = PC.fs_to_atomic_units(0.5)
RC, SKIN = 11.95, 0.05
FF_KW = dict(coupling=1e-3, r_cut=RC, pppm_mesh=(8, 8, 8), cell_skin=SKIN)
K_TRAP = 2e-5
FIELD = (2e-3, -1e-3, 5e-4)
A_WELL = 1e-8
L_TYPEID = 2  # the photon's typeid in the O2/N2 scene (types O, N, L)
STATE_KEYS = ("position", "image", "velocity", "mass", "charge", "typeid",
              "box_L", "forces", "dt", "time_au", "time_comp", "timestep",
              "bussi_reservoir", "bussi_instantaneous", "langevin_reservoir")
B = 4


# ------------------------------------------------- the callables, twice
def j_trap(position, image, box_L, charge, typeid):
    return -K_TRAP * position, 0.5 * K_TRAP * jnp.sum(position**2)


def t_trap(position, image, box_L, charge, typeid):
    return -K_TRAP * position, 0.5 * K_TRAP * torch.sum(position**2)


def j_field(position, image, box_L, charge, typeid):
    w = jnp.where(typeid != L_TYPEID, charge, 0.0)
    E = jnp.asarray(FIELD, position.dtype)
    unwrapped = position + image * box_L
    f = w[:, None] * E
    return f, -jnp.sum(f * unwrapped)


def t_field(position, image, box_L, charge, typeid):
    w = torch.where(typeid != L_TYPEID, charge, 0.0)
    E = torch.tensor(FIELD, dtype=position.dtype)
    unwrapped = position + image * box_L
    f = w[:, None] * E
    return f, -torch.sum(f * unwrapped)


def _j_well(position):
    r2 = jnp.sum(position**2, axis=-1)
    return A_WELL * jnp.sum(r2 * r2)


def _t_well(position):
    r2 = torch.sum(position**2, dim=-1)
    return A_WELL * torch.sum(r2 * r2)


def j_well(position, image, box_L, charge, typeid):
    return -jax.grad(_j_well)(position), _j_well(position)


def t_well(position, image, box_L, charge, typeid):
    return -torch.func.grad(_t_well)(position), _t_well(position)


J_CUSTOM = (j_trap, j_field, j_well)
T_CUSTOM = (t_trap, t_field, t_well)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: its tensors are small, and the
    suite runs six workers on the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(t, j, tol, what=""):
    j = np.asarray(j, dtype=np.float64)
    t = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
    scale = max(float(np.abs(j).max()), 1e-300)
    np.testing.assert_allclose(np.asarray(t, np.float64), j, rtol=0,
                               atol=tol * scale, err_msg=what)


@pytest.fixture(scope="module")
def world():
    """The scene in both packages, the photon with a thermal velocity."""
    js, ts = scene(n_mol=40, box_L=36.0, seed=11, jitter=0.0)
    v = np.asarray(js.velocity).copy()
    v[-1] = np.random.default_rng(13).normal(0.0, np.sqrt(KT), size=3)
    js = js.replace(velocity=jnp.asarray(v))
    ts = ts.replace(velocity=torch.as_tensor(v))
    assert js.types.index("L") == L_TYPEID
    return js, ts


def _forcefields(world, mode, j_custom=J_CUSTOM, t_custom=T_CUSTOM):
    """(JAX ForceField, port ForceField): the port's ``mode`` against JAX's
    same mode, zcol against JAX's cell mode."""
    js, ts = world
    jmode = "cell" if mode == "zcol" else mode
    jff = JForceField.create(js, pair_mode=jmode, custom_forces=j_custom,
                             **FF_KW)
    tff = ForceField.create(ts, pair_mode=mode, custom_forces=t_custom,
                            **FF_KW)
    return jff, tff


@pytest.mark.parametrize("mode", ["dense", "cell", "zcol"])
def test_forces_and_energies_match_jax(world, mode):
    """Forces and every energy key, the three ``custom_<i>`` among them,
    against JAX's ``ForceField.compute`` to 1e-10, from positions off the
    lattice and with image flags set."""
    js, ts = world
    jff, tff = _forcefields(world, mode)
    rng = np.random.default_rng(4)
    pos = np.asarray(js.position) + rng.normal(scale=0.05, size=(js.N, 3))
    image = rng.integers(-1, 2, size=(js.N, 3)).astype(np.int32)
    f_j, e_j = jax.jit(jff.compute)(
        jnp.asarray(pos), jnp.asarray(image), js.box_L, js.charge, js.typeid,
        js.bond_group, js.bond_typeid)
    f_t, e_t = tff(torch.as_tensor(pos), torch.as_tensor(image), ts.box_L,
                   ts.charge, ts.typeid)
    _close(f_t, f_j, 1e-10, "forces")
    assert {f"custom_{i}" for i in range(3)} <= set(e_t)
    assert set(e_t) == set(e_j)
    for k, v in e_j.items():
        if k == "cell_overflow":
            assert float(e_t[k]) == float(v) == 0.0
            continue
        assert abs(float(e_t[k]) - float(v)) <= 1e-10 * max(abs(float(v)),
                                                            1e-12), k
    # each callable's energy is the one it returns on its own
    for i, fn in enumerate(T_CUSTOM):
        _, e = fn(torch.as_tensor(pos), torch.as_tensor(image), ts.box_L,
                  ts.charge, ts.typeid)
        assert float(e_t[f"custom_{i}"]) == float(e)
    assert abs(float(potential_energy(e_t))
               - float(sum(v for k, v in e_j.items()
                           if k != "cell_overflow"))) <= 1e-10 * abs(
        float(potential_energy(e_t)))


def test_func_grad_callable_equals_its_jax_grad_twin(world):
    """A callable whose forces come from ``torch.func.grad`` equals its
    ``jax.grad`` twin (forces and energy), also under ``torch.no_grad()``,
    where the steps run."""
    js, ts = world
    pos = np.asarray(js.position) * 1.3
    f_j, e_j = j_well(jnp.asarray(pos), js.image, js.box_L, js.charge,
                      js.typeid)
    with torch.no_grad():
        f_t, e_t = t_well(torch.as_tensor(pos), ts.image, ts.box_L,
                          ts.charge, ts.typeid)
    assert float(e_j) > 0 and np.abs(np.asarray(f_j)).max() > 0
    _close(f_t, f_j, 1e-12, "forces")
    assert float(e_t) == pytest.approx(float(e_j), rel=1e-12)


def _jax_run(jff, js, jspec, n, seed=3):
    jm = j_resolve_methods(js, jspec, jff.l_typeid)
    jstate = j_init_state(js, jff, dt=DT, seed=seed)
    jfinal, jobs = jax.jit(
        lambda s: j_run_steps(j_make_step_fn(jff, jm), s, n, unroll=1))(
            jstate)
    return jstate, jfinal, jobs


def _port_state(jstate, tff, seed=3):
    return state_from_numpy(**{k: np.asarray(getattr(jstate, k))
                               for k in STATE_KEYS},
                            seed=seed, forcefield=tff, device="cpu")


def _assert_traj(jfinal, jobs, tfinal, tobs, tol, keys):
    for name in ("position", "velocity"):
        _close(getattr(tfinal, name), getattr(jfinal, name), tol, name)
    np.testing.assert_array_equal(tfinal.image.numpy(),
                                  np.asarray(jfinal.image))
    for k in keys:
        j = np.asarray(jobs[k], dtype=np.float64)
        np.testing.assert_allclose(tobs[k], j, rtol=0,
                                   atol=tol * max(np.abs(j).max(), 1e-12),
                                   err_msg=k)


SPECS = {
    "nve": (("nve", "all", {}),),
    "bussi_langevin": (("bussi", "molecular", dict(kT=KT, tau=TAU)),
                       ("langevin", "cavity", dict(kT=KT, gamma=GAMMA))),
}


@pytest.mark.parametrize("mode,methods", [("dense", "nve"),
                                          ("zcol", "bussi_langevin")])
def test_trajectory_matches_jax(world, mode, methods):
    """20 f64 steps with the three callables against JAX's ``run_steps``:
    NVE in dense mode, and Bussi + Langevin with JAX's draws injected in
    zcol mode, against JAX's cell mode, across a rebuild of the column
    list (the batch test below holds dense Bussi + Langevin): positions,
    velocities, images and every observable, the ``custom_<i>`` columns
    and the universe energy included, to 1e-10 of their scale."""
    js, ts = world
    jff, tff = _forcefields(world, mode)
    spec = SPECS[methods]
    jstate, jfinal, jobs = _jax_run(
        jff, js, tuple(JMethodSpec(kind=k, group=g, **kw)
                       for k, g, kw in spec), 20)
    tm = resolve_methods(ts, tuple(MethodSpec(kind=k, group=g, **kw)
                                   for k, g, kw in spec), tff.l_typeid)
    noise = JaxNoise(jstate.key) if methods != "nve" else None
    tstate = _port_state(jstate, tff)
    tfinal, tobs = run_steps(make_step_fn(tff, tm, noise=noise), tstate, 20)
    custom = tuple(f"custom_{i}" for i in range(3))
    _assert_traj(jfinal, jobs, tfinal, tobs, 1e-10, OBS_KEYS + custom)
    U = np.asarray(j_universe_energy(jobs))
    np.testing.assert_allclose(universe_energy(tobs), U, rtol=0,
                               atol=1e-10 * np.abs(U).max())
    if mode == "zcol":
        assert not torch.equal(tfinal.cell_anchor, tstate.position), \
            "the column list was never rebuilt"


def test_fused_tail_takes_the_custom_forces(world):
    """float32 on the plain twins of K4/K5 (``fuse_integrator=True``)
    against the unfused float32 tail, the same JAX draws injected into
    both, 20 steps: the custom forces reach K5 in the summed forces (1e-5
    of scale; the two tails differ in reduction order only)."""
    _, ts = world
    ts32 = ts.astype(torch.float32)
    tff = ForceField.create(ts32, pair_mode="dense", custom_forces=T_CUSTOM,
                            **FF_KW)
    tm = resolve_methods(ts32, tuple(
        MethodSpec(kind=k, group=g, **kw)
        for k, g, kw in SPECS["bussi_langevin"]), tff.l_typeid)
    key = master_key(3)
    runs = []
    for fuse in (True, False):
        start = init_state(ts32, tff, dt=DT, seed=3)
        runs.append(run_steps(make_step_fn(
            tff, tm, fuse_integrator=fuse,
            noise=JaxNoise(key, jnp.float32)), start, 20))
    (ffin, fobs), (ufin, uobs) = runs
    _close(ffin.position, ufin.position.numpy(), 1e-5, "position")
    _close(ffin.velocity, ufin.velocity.numpy(), 1e-5, "velocity")
    for k in ("custom_0", "custom_1", "custom_2", "kinetic_molecular"):
        _close(fobs[k], uobs[k], 1e-5, k)
    assert np.all(fobs["custom_0"] > 0)


def test_universe_energy_is_conserved_on_the_jax_hook_protocol():
    """tests/test_forces.py:165 on the port: 8 diatomics, no cavity and
    no Coulomb, the trap; the energy audit holds ``custom_0`` and NVE
    conserves KE + PE, and so ``universe_energy``, to 5e-6 Ha over 300
    steps."""
    snap = t_make(8, box_L=18.0, temperature_K=50.0, seed=71, device="cpu")

    def harmonic_trap(position, image, box_L, charge, typeid):
        k = 1e-4
        return -k * position, 0.5 * k * torch.sum(position**2)

    ff = ForceField.create(snap, enable_cavity=False, enable_coulomb=False,
                           custom_forces=(harmonic_trap,))
    _, e = ff(snap.position, snap.image, snap.box_L, snap.charge,
              snap.typeid)
    assert "custom_0" in e and float(e["custom_0"]) > 0
    methods = resolve_methods(snap, (MethodSpec(kind="nve", group="all"),),
                              -1)
    state = init_state(snap, ff, dt=PC.fs_to_atomic_units(0.25), seed=1)
    _, obs = run_steps(make_step_fn(ff, methods), state, 300)
    E = potential_energy(obs) + obs["kinetic_molecular"] + obs[
        "kinetic_cavity"]
    assert np.abs(E - E[0]).max() < 5e-6
    U = universe_energy(obs)
    assert np.abs(U - U[0]).max() < 5e-6
    # the trap's energy moves: it is part of what is conserved
    assert np.ptp(obs["custom_0"]) > 10 * np.abs(U - U[0]).max()


# ------------------------------------------------------------- Brownian
BROWN_N, BROWN_K = 64, 0.2
BROWN_GAMMA, BROWN_DT = 0.5, 0.05


def _brownian_scene():
    """tests/test_integrate.py:357's scene in both packages."""
    rng = np.random.default_rng(0)
    kw = dict(position=rng.normal(size=(BROWN_N, 3)) * 0.5,
              box_L=np.array([200.0, 200.0, 200.0]),
              velocity=np.zeros((BROWN_N, 3)),
              image=np.zeros((BROWN_N, 3), np.int32), mass=np.ones(BROWN_N),
              charge=np.zeros(BROWN_N), diameter=np.ones(BROWN_N),
              typeid=np.zeros(BROWN_N, np.int32), types=("O",))
    js = JSnapshot.create(**kw)
    ts = Snapshot.create(**kw, device="cpu")
    ff_kw = dict(enable_cavity=False, enable_coulomb=False, enable_lj=False,
                 enable_bonds=False,
                 lj_params={("O", "O"): dict(epsilon=0.0, sigma=1.0)},
                 pppm_mesh=(8, 8, 8))

    def jtrap(position, image, box_L, charge, typeid):
        return -BROWN_K * position, 0.5 * BROWN_K * jnp.sum(position**2)

    def ttrap(position, image, box_L, charge, typeid):
        return -BROWN_K * position, 0.5 * BROWN_K * torch.sum(position**2)

    jff = JForceField.create(js, custom_forces=(jtrap,), **ff_kw)
    tff = ForceField.create(ts, custom_forces=(ttrap,), **ff_kw)
    return js, ts, jff, tff


def test_brownian_trap_matches_jax_step_for_step():
    """Brownian dynamics in the trap, 40 steps against JAX's with JAX's
    draws injected: positions, velocities and every observable to 1e-10
    of scale."""
    js, ts, jff, tff = _brownian_scene()
    kT = PC.kT_from_kelvin(100.0)
    jm = j_resolve_methods(js, (JMethodSpec(kind="brownian", group="all",
                                            kT=kT, gamma=BROWN_GAMMA),),
                           jff.l_typeid)
    jstate = j_init_state(js, jff, dt=BROWN_DT, seed=3)
    jfinal, jobs = jax.jit(
        lambda s: j_run_steps(j_make_step_fn(jff, jm), s, 40, unroll=1))(
            jstate)
    tm = resolve_methods(ts, (MethodSpec(kind="brownian", group="all", kT=kT,
                                         gamma=BROWN_GAMMA),), tff.l_typeid)
    tstate = state_from_numpy(**{k: np.asarray(getattr(jstate, k))
                                 for k in STATE_KEYS}, seed=3, device="cpu")
    tfinal, tobs = run_steps(make_step_fn(tff, tm,
                                          noise=JaxNoise(jstate.key)),
                             tstate, 40)
    _assert_traj(jfinal, jobs, tfinal, tobs, 1e-10, OBS_KEYS + ("custom_0",))


# the port's own stationary check of tests/test_integrate.py:357, cut from
# 2000 burn-in steps and 200 samples 50 steps apart to 1000 and 60 (the
# port's eager step on the CPU takes ~0.5 ms, and the whole check must
# stay near 15 s): var(x) within 12% of kT/k, var(v) within 5% of kT
BROWN_BURN, BROWN_SAMPLES, BROWN_EVERY = 1000, 60, 50


def test_brownian_trap_samples_the_canonical_variance():
    _, ts, _, tff = _brownian_scene()
    kT = PC.kT_from_kelvin(100.0)
    tm = resolve_methods(ts, (MethodSpec(kind="brownian", group="all", kT=kT,
                                         gamma=BROWN_GAMMA),), tff.l_typeid)
    step = make_step_fn(tff, tm)
    state = init_state(ts, tff, dt=BROWN_DT, seed=3)
    state, _ = run_steps(step, state, BROWN_BURN)
    pos, vel = [], []
    for _ in range(BROWN_SAMPLES):
        state, _ = run_steps(step, state, BROWN_EVERY)
        pos.append(state.position.numpy().copy())
        vel.append(state.velocity.numpy().copy())
    # Euler-Maruyama's stationary bias is 1/(1 - theta/2), theta = k dt /
    # (m gamma) = 0.02: ~+1%; 60 x 64 x 3 samples of one relax time apart
    # leave ~2.3% of sampling noise a sigma
    assert np.stack(pos).var() == pytest.approx(kT / BROWN_K, rel=0.12)
    assert np.stack(vel).var() == pytest.approx(kT, rel=0.05)


# ---------------------------------------------------------- the batch
@pytest.fixture(scope="module")
def batch_world(world):
    """JAX's batch of B jittered replicas with the trap and the field,
    20 Bussi + Langevin steps through ``run_replica_steps``."""
    js, ts = world
    jff, tff = _forcefields(world, "dense", J_CUSTOM[:2], T_CUSTOM[:2])
    rng = np.random.default_rng(21)
    pos = np.asarray(js.position)[None] + rng.normal(
        scale=0.05, size=(B,) + tuple(js.position.shape))
    image = np.zeros(pos.shape, np.int32)
    image[1, :5, 0] = 1  # unwrapped rows for the field's energy
    snaps = [js.replace(position=jnp.asarray(p), image=jnp.asarray(i))
             for p, i in zip(pos, image)]
    spec = SPECS["bussi_langevin"]
    jm = j_resolve_methods(js, tuple(JMethodSpec(kind=k, group=g, **kw)
                                     for k, g, kw in spec), jff.l_typeid)
    jstate = j_init_replicas(snaps, jff, dt=DT, seed=3)
    # run_replica_steps is run_steps over make_replica_step (jax.vmap of
    # the step); run here with unroll 1, which compiles 4x less
    jfinal, jobs = jax.jit(lambda s: j_run_steps(
        j_make_replica_step(j_make_step_fn(jff, jm)), s, 20, unroll=1))(
        jstate)
    tm = resolve_methods(ts, tuple(MethodSpec(kind=k, group=g, **kw)
                                   for k, g, kw in spec), tff.l_typeid)
    start = state_from_numpy(**{k: np.asarray(getattr(jstate, k))
                                for k in STATE_KEYS}, seed=3, device="cpu")
    return dict(jff=jff, tff=tff, tm=tm, jstate=jstate, jfinal=jfinal,
                jobs=jobs, start=start)


def test_batch_matches_jax_and_one_replica_runs(batch_world):
    """A batch of 4 replicas: each callable sees one replica's arrays
    through ``torch.func.vmap`` (the trap's full ``torch.sum`` would add
    all 4 replicas' energies if it were handed (B, N, 3)). Against JAX's
    ``run_replica_steps`` (``jax.vmap``, JAX's per-replica draws) to 1e-9
    of scale, and against 4 one-replica port runs to 1e-12."""
    w = batch_world
    tff, tm, start = w["tff"], w["tm"], w["start"]
    keys = w["jstate"].key
    final, obs = run_replica_steps(
        make_step_fn(tff, tm, noise=ReplicaJaxNoise(keys)), start, 20)
    custom = ("custom_0", "custom_1")
    assert obs["custom_0"].shape == (20, B)
    assert all(o["custom_1"].shape == (20,)
               for o in split_replica_obs(obs, B))
    _assert_traj(w["jfinal"], w["jobs"], final, obs, 1e-9,
                 OBS_KEYS + custom)
    for r in range(B):
        one = start.replace(**{k: getattr(start, k)[r] for k in PER_REPLICA})
        fr, obs_r = run_steps(make_step_fn(
            tff, tm, noise=ReplicaJaxNoise(keys, replica=r)), one, 20)
        _close(final.position[r], fr.position.numpy(), 1e-12, f"{r} position")
        _close(final.velocity[r], fr.velocity.numpy(), 1e-12, f"{r} velocity")
        for k in OBS_KEYS + custom:
            _close(obs[k][:, r], obs_r[k], 1e-12, f"{r} {k}")


def test_batch_refuses_a_callable_vmap_cannot_take(world):
    """A callable that reads a value back (``.item()``) cannot run under
    ``torch.func.vmap``: the batch raises ValueError naming it, with no
    silent loop over replicas; one replica runs it."""
    js, ts = world

    def readback_trap(position, image, box_L, charge, typeid):
        k = K_TRAP * float(torch.sum(position**2).item() > -1.0)
        return -k * position, 0.5 * k * torch.sum(position**2)

    ff = ForceField.create(ts, custom_forces=(readback_trap,), **FF_KW)
    args = (ts.image, ts.box_L, ts.charge, ts.typeid)
    f, e = ff(ts.position, *args)
    assert float(e["custom_0"]) > 0
    P = ts.position[None].repeat(2, 1, 1)
    with pytest.raises(ValueError, match="readback_trap"):
        ff(P, ts.image[None].repeat(2, 1, 1), *args[1:])


# ------------------------------------------------- retry, refusals
class TrapModule(torch.nn.Module):
    """A callable with a tensor of its own."""

    def __init__(self):
        super().__init__()
        self.register_buffer("k", torch.tensor(K_TRAP, dtype=torch.float64))

    def forward(self, position, image, box_L, charge, typeid):
        return -self.k * position, 0.5 * self.k * torch.sum(position**2)


def test_overflow_retry_keeps_the_callables(world):
    """A cell-mode run whose bucket capacity overflows re-plans and reruns
    its chunk; the re-planned ForceField holds the very same callables
    (not deep copies), and the retried run equals one that never
    overflowed."""
    _, ts = world
    trap = TrapModule()
    tm = resolve_methods(ts, (MethodSpec(kind="nve", group="all"),), 2)
    sims = []
    for cap in (3, None):
        ff = ForceField.create(ts, pair_mode="cell", custom_forces=(trap,),
                               cell_cap=cap, **FF_KW)
        grown = ff.with_cell_capacity(64)
        assert grown.custom_forces[0] is trap
        sim = Simulation(ts, ff, tm, dt=DT, seed=3, chunk_size=10)
        sim.run(n_steps=10)
        sims.append(sim)
    retried, clean = sims
    assert retried.ff.cell_cfg.cap > 3
    assert retried.ff.custom_forces[0] is trap
    assert not retried.last_obs["cell_overflow"].any()
    np.testing.assert_allclose(retried.state.position.numpy(),
                               clean.state.position.numpy(), rtol=0,
                               atol=1e-12 * 18.0)
    np.testing.assert_allclose(retried.last_obs["custom_0"],
                               clean.last_obs["custom_0"], rtol=1e-12)


def test_slab_path_refuses_custom_forces():
    """``plan_domain`` raises ValueError, as the JAX plan does
    (``cavmd_tpu/parallel/domain.py:285``). ``Simulation(shard_atoms=1)``
    then runs unsharded, as the JAX facade treats 1, bit for bit the
    unsharded run; ``shard_atoms=2`` falls back to atom sharding by rows
    (the JAX facade's GSPMD fallback) and, on two thread ranks, matches
    the unsharded run to 1e-10 (60 diatomics + photon in a 24-bohr box,
    ghost-padded to 122 rows), custom energy included."""
    from cavmd_tpu_torch.core import add_cavity_particle as t_add
    from cavmd_tpu_torch.parallel import pad_snapshot_to
    from thread_ranks import run_threads

    snap = t_add(t_make(550, box_L=65.0, temperature_K=100.0, seed=0,
                        device="cpu"),
                 coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1)
    kw = dict(coupling=1e-3, r_cut=8.0, pair_mode="cell",
              pppm_mesh=(16, 16, 16))
    plain = ForceField.create(snap, **kw)
    assert td.plan_domain(snap, plain, 1).S == 1
    ff = ForceField.create(snap, custom_forces=(t_trap,), **kw)
    with pytest.raises(ValueError, match="custom forces"):
        td.plan_domain(snap, ff, 1)
    tm = resolve_methods(snap, (MethodSpec(kind="nve", group="all"),),
                         ff.l_typeid)
    runs = []
    for shards in (0, 1):
        sim = Simulation(snap, ff, tm, dt=DT, shard_atoms=shards)
        assert sim._domain_plan is None and sim.ff.row_comm is None
        sim.run(n_steps=1)
        runs.append(sim.state.position)
    assert torch.equal(runs[0], runs[1])

    small, _ = pad_snapshot_to(t_add(
        t_make(60, box_L=24.0, temperature_K=100.0, seed=5, device="cpu"),
        coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=6), 2)
    sff = ForceField.create(small, custom_forces=(t_trap,), **kw)
    ref = Simulation(small, sff, tm, dt=DT)
    ref.run(n_steps=2)

    def rank(comm):
        sim = Simulation(small, sff, tm, dt=DT, shard_atoms=2, comm=comm)
        assert sim.ff.row_comm is comm and sim._domain_plan is None
        sim.run(n_steps=2)
        return sim.state.position, sim.last_obs["custom_0"]

    for pos, e_custom in run_threads(2, rank):
        np.testing.assert_allclose(pos.numpy(), ref.state.position.numpy(),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(e_custom, ref.last_obs["custom_0"],
                                   rtol=1e-10)
    assert not torch.equal(ref.state.position, small.position)


# ---------------------------------------------------------- the tracker
def _rows(path):
    """The data rows of an energy tracker file (after its header)."""
    with open(path) as f:
        return np.array([[float(x) for x in line.split()] for line in f
                         if line[0].isdigit()])


def test_tracker_counts_the_custom_energies(world, tmp_path):
    """The port's EnergyTracker adds the ``custom_<i>`` energies to the
    potential and universe columns, so its universe column is
    ``universe_energy``; JAX's tracker leaves them out
    (``cavmd_tpu/observe/trackers.py:107-114``), so its column is off by
    exactly their sum (ROADMAP.md Queue 3). Without custom forces the two
    files are equal byte for byte."""
    _, ts = world
    tff = ForceField.create(ts, custom_forces=T_CUSTOM[:2], **FF_KW)
    tm = resolve_methods(ts, tuple(MethodSpec(kind=k, group=g, **kw)
                                   for k, g, kw in SPECS["bussi_langevin"]),
                         tff.l_typeid)
    _, obs = run_steps(make_step_fn(tff, tm), init_state(ts, tff, dt=DT,
                                                         seed=3), 12)
    custom = obs["custom_0"] + obs["custom_1"]
    assert np.abs(custom).min() > 1e-3  # well above the files' 1e-6
    files = {}
    for name, cls in (("jax", JEnergyTracker), ("port", EnergyTracker)):
        for tag, o in (("custom", obs), ("plain", {
                k: v for k, v in obs.items() if not k.startswith("custom_")})):
            prefix = str(tmp_path / f"{name}_{tag}")
            cls(output_prefix=prefix, output_period_steps=1).consume(o)
            files[name, tag] = f"{prefix}_energy_tracker.txt"
    jax_rows = _rows(files["jax", "custom"])
    port_rows = _rows(files["port", "custom"])
    # columns: 13 total_potential_energy, 14 system, 18 universe
    U = universe_energy(obs)
    np.testing.assert_allclose(port_rows[:, 18], U, rtol=0, atol=6e-7)
    np.testing.assert_allclose(jax_rows[:, 18] + custom, U, rtol=0,
                               atol=6e-7)
    np.testing.assert_allclose(port_rows[:, 13] - jax_rows[:, 13], custom,
                               rtol=0, atol=1.1e-6)
    assert np.ptp(port_rows[:, 18]) < np.ptp(jax_rows[:, 18])
    with open(files["jax", "plain"]) as a, open(files["port", "plain"]) as b:
        assert a.read() == b.read()
