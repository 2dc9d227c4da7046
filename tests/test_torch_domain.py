"""The slab domain pipeline (cavmd_tpu_torch/parallel/domain.py) against
the JAX package's (cavmd_tpu/parallel/domain.py) on the scene of
tests/test_domain.py:36 (550 O2/N2 diatomics + photon, 65-bohr box,
r_cut 8, PPPM 16^3), in float64 on the CPU:

- the plan's fields, rejections and the nb_cap clamp equal the JAX plan's;
- one rebuild's integer tables equal JAX ``_rebuild_one``'s exactly;
- the S = 1 runner matches the JAX S = 1 runner to 1e-10 over two rebuild
  chunks, with the JAX draws injected;
- the tile pass's plain twin matches the JAX XLA tile path on the extended
  grid (f64) and ``fused_cell_cols_slab_pallas`` in interpret mode (f32);
- adaptive dt with the dipole and rho(k) observables matches the unsharded
  port (tests/test_domain.py:250);
- MTTK and Berendsen baths at S = 1 match the unsharded port to 1e-10;
- at S = 1 a bonded pair across the periodic x face stays excluded (the
  JAX S = 1 runner counts it: ROADMAP.md Queue 3).

Several ranks over gloo: tests/test_torch_domain_dist.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cavmd_tpu.core import add_cavity_particle as j_add
from cavmd_tpu.core import make_diatomic_system as j_make
from cavmd_tpu.integrate import ForceField as JForceField
from cavmd_tpu.integrate import MethodSpec as JMethodSpec
from cavmd_tpu.integrate import init_state as j_init_state
from cavmd_tpu.integrate import make_step_fn as j_make_step_fn
from cavmd_tpu.integrate import resolve_methods as j_resolve_methods
from cavmd_tpu.integrate import run_steps as j_run_steps
from cavmd_tpu.ops import neighbor as jn
from cavmd_tpu.parallel import domain as jd
from cavmd_tpu_torch import Simulation
from cavmd_tpu_torch.core import PhysicalConstants as PC
from cavmd_tpu_torch.core import add_cavity_particle as t_add
from cavmd_tpu_torch.core import make_diatomic_system as t_make
from cavmd_tpu_torch.integrate import (
    MethodSpec,
    init_state,
    make_adaptive_step,
    make_step_fn,
    resolve_methods,
    run_steps,
)
from cavmd_tpu_torch.interop import state_from_numpy
from cavmd_tpu_torch.observe import generate_fibonacci_sphere, make_extra_obs
from cavmd_tpu_torch.ops import cell_kernels as ck
from cavmd_tpu_torch.parallel import Communicator
from cavmd_tpu_torch.parallel import domain as td

from test_torch_cell_kernel import port_cell_forcefield
from test_torch_integrate import JaxNoise

KT = PC.kT_from_kelvin(100.0)
TAU = PC.ps_to_atomic_units(5.0)
GAMMA = PC.gamma_from_tau_ps(5.0)
DT = PC.fs_to_atomic_units(0.5)
BATH_TAU = PC.ps_to_atomic_units(0.05)
STATE_KEYS = ("position", "image", "velocity", "mass", "charge", "typeid",
              "box_L", "forces", "dt", "time_au", "time_comp", "timestep",
              "bussi_reservoir", "bussi_instantaneous", "langevin_reservoir",
              "error_tolerance")
INT_TABLES = ("perm", "inv_slot", "buckets", "slot_of", "send_first",
              "send_last", "halo_src", "excl", "sing_partner")


def build(dtype=np.float64, shift_x=0.0):
    """tests/test_domain.py:_build in both packages (the same bits), the x
    coordinates shifted by ``shift_x`` and wrapped (32.5 bohr puts 62
    molecules across the periodic x face). Returns (js, ts, jff, tff,
    jmethods, tmethods, jstate, tstate); the port state carries no cell
    list (the slab path bins each chunk)."""
    js = j_add(j_make(550, box_L=65.0, temperature_K=100.0, seed=0,
                      dtype=np.float64),
               coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1)
    ts = t_add(t_make(550, box_L=65.0, temperature_K=100.0, seed=0,
                      device="cpu"),
               coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1)
    if shift_x:
        p = np.asarray(js.position).copy()
        L = np.asarray(js.box_L)
        p[:, 0] += shift_x
        img = np.floor((p + 0.5 * L) / L)
        p -= img * L
        image = np.asarray(js.image) + img.astype(np.int32)
        js = js.replace(position=jnp.asarray(p), image=jnp.asarray(image))
        ts = ts.replace(position=torch.as_tensor(p),
                        image=torch.as_tensor(image))
    jdt = jnp.float32 if dtype == np.float32 else jnp.float64
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    js, ts = js.astype(jdt), ts.astype(tdt)
    jff = JForceField.create(js, coupling=1e-3, freq_cm1=2000.0, r_cut=8.0,
                             pair_mode="cell", pppm_mesh=(16, 16, 16),
                             dtype=jdt)
    tff = port_cell_forcefield(jff, js, tdt)
    jspec = (JMethodSpec(kind="bussi", group="molecular", kT=KT, tau=TAU),
             JMethodSpec(kind="langevin", group="cavity", kT=KT,
                         gamma=GAMMA))
    tspec = (MethodSpec(kind="bussi", group="molecular", kT=KT, tau=TAU),
             MethodSpec(kind="langevin", group="cavity", kT=KT, gamma=GAMMA))
    jm = j_resolve_methods(js, jspec, jff.l_typeid)
    tm = resolve_methods(ts, tspec, tff.l_typeid)
    jstate = j_init_state(js, jff, dt=DT, seed=7)
    tstate = state_from_numpy(
        **{k: np.asarray(getattr(jstate, k)) for k in STATE_KEYS},
        seed=7, dtype=tdt, device="cpu")
    return js, ts, jff, tff, jm, tm, jstate, tstate


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: its tensors are small, and the
    suite runs six workers on the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scene():
    return build()


def _same_plan(tp, jp):
    for field in jp._fields:
        a, b = getattr(jp, field), getattr(tp, field)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=field)
        else:
            assert b == a, field
    assert (tp.C_ext, tp.H, tp.Mtot) == (jp.C_ext, jp.H, jp.Mtot)


@pytest.mark.parametrize("S", [1, 2, 4])
def test_plan_matches_jax(scene, S):
    """Every field of the plan, and of the plan grown for a retry."""
    js, ts, jff, tff = scene[:4]
    jp, tp = jd.plan_domain(js, jff, S), td.plan_domain(ts, tff, S)
    _same_plan(tp, jp)
    _same_plan(tp.grow_cap(), jp.grow_cap())


def test_plan_rejections_and_nb_cap_clamp(scene):
    """tests/test_domain.py:435 and :452 on the port."""
    js, ts, jff, tff = scene[:4]
    small = t_add(t_make(40, box_L=25.0, temperature_K=100.0, seed=0,
                         device="cpu"),
                  coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1)
    from cavmd_tpu_torch.integrate import ForceField

    dense = ForceField.create(small, coupling=1e-3, r_cut=10.0,
                              pppm_mesh=(16, 16, 16))
    with pytest.raises(ValueError, match="pair_mode"):
        td.plan_domain(small, dense, 2)
    cell = ForceField.create(small, coupling=1e-3, r_cut=10.0,
                             pair_mode="cell", pppm_mesh=(16, 16, 16))
    with pytest.raises(ValueError, match="box too small"):
        td.plan_domain(small, cell, 8)
    plan = td.plan_domain(ts, tff, 1)
    assert plan.nb_cap == plan.n_mol
    grown = plan.grow_cap()
    assert grown.nb_cap == plan.n_mol and grown.cap > plan.cap


def _j_rebuild(jff, plan, jstate):
    return jax.jit(lambda p: jd._rebuild_one(
        p, plan, jstate.box_L, jff.bond_k_per, jff.bond_r0_per,
        jff.pair_inert, jstate.charge))(jstate.position)


@pytest.mark.parametrize("S", [1, 2, 4])
def test_rebuild_tables_equal_jax(scene, S):
    """One rebuild: every integer table equal, the float tables to
    round-off, both overflow flags clear."""
    js, ts, jff, tff, _, _, jstate, tstate = scene
    jdat = _j_rebuild(jff, jd.plan_domain(js, jff, S), jstate)
    tdat = td._rebuild_one(tstate.position, td.plan_domain(ts, tff, S),
                           tstate.box_L, tff.bond_k_per, tff.bond_r0_per,
                           tff.pair_inert, tstate.charge)
    for name in INT_TABLES:
        got = getattr(tdat, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jdat, name)),
                                      err_msg=name)
    for name in ("binned", "valid", "slab_overflow", "bucket_overflow"):
        np.testing.assert_array_equal(getattr(tdat, name).numpy(),
                                      np.asarray(getattr(jdat, name)),
                                      err_msg=name)
    assert not bool(tdat.slab_overflow) and not bool(tdat.bucket_overflow)
    for name in ("centers", "bond_k", "bond_r0", "sing_k", "sing_r0",
                 "sing_qq"):
        np.testing.assert_allclose(getattr(tdat, name).numpy(),
                                   np.asarray(getattr(jdat, name)),
                                   rtol=1e-14, atol=1e-14, err_msg=name)
    # pair keys: identity but for halo copies of the slab's own residents
    key = tdat.pair_key.numpy()
    plan = td.plan_domain(ts, tff, S)
    ident = np.arange(plan.Mtot)[None].repeat(S, 0)
    if S > 1:
        np.testing.assert_array_equal(key, ident)
    else:
        halo = key[0, plan.Mrow:]
        src = tdat.halo_src.numpy()[0].reshape(-1)
        occupied = src < plan.n0
        inv = tdat.inv_slot.numpy()
        np.testing.assert_array_equal(halo[occupied], inv[src[occupied]])


def _obs_close(tobs, jobs, tol):
    for k in jobs:
        want = np.asarray(jobs[k], np.float64)
        np.testing.assert_allclose(np.asarray(tobs[k], np.float64), want,
                                   rtol=0,
                                   atol=tol * max(np.abs(want).max(), 1e-12),
                                   err_msg=k)


def test_s1_runner_matches_jax_runner(scene):
    """The port's S = 1 runner against the JAX S = 1 runner: 10 steps at a
    cadence of 5 (two rebuilds), Bussi + Langevin with the JAX draws
    injected: positions and velocities to 1e-10 of their scale, every
    observable to 1e-9 of its own."""
    js, ts, jff, tff, jm, tm, jstate, tstate = scene
    jrun = jd.make_domain_runner(jff, jm, jd.plan_domain(js, jff, 1),
                                 rebuild_every=5)
    jfin, jobs = jrun(jstate, 10)
    trun = td.make_domain_runner(tff, tm, td.plan_domain(ts, tff, 1),
                                 rebuild_every=5, noise=JaxNoise(jstate.key))
    tfin, tobs = trun(tstate, 10)
    for name in ("position", "velocity"):
        j = np.asarray(getattr(jfin, name))
        np.testing.assert_allclose(getattr(tfin, name).numpy(), j, rtol=0,
                                   atol=1e-10 * np.abs(j).max(),
                                   err_msg=name)
    np.testing.assert_array_equal(tfin.image.numpy(), np.asarray(jfin.image))
    assert tfin.step == 10 and int(tfin.timestep) == 10
    _obs_close(tobs, jobs, 1e-9)
    assert not tobs["cell_overflow"].any()


@pytest.mark.parametrize("bath", ["mttk", "berendsen"])
def test_s1_runner_with_baths_matches_unsharded(scene, bath):
    """MTTK or Berendsen on the molecules (tau 0.05 ps) and Langevin on the
    photon: the S = 1 runner, 10 steps at a cadence of 5 (the group KE
    sums of both halves on the slab path), against the unsharded step,
    the port's own draws on both: positions, velocities, (xi, eta) and
    every observable to 1e-10 of their scale."""
    _, ts, _, tff, _, _, _, tstate = scene
    tm = resolve_methods(ts, (
        MethodSpec(kind=bath, group="molecular", kT=KT, tau=BATH_TAU),
        MethodSpec(kind="langevin", group="cavity", kT=KT, gamma=GAMMA)),
        tff.l_typeid)
    ref, robs = run_steps(make_step_fn(tff, tm),
                          tstate.replace(generators={}), 10)
    run = td.make_domain_runner(tff, tm, td.plan_domain(ts, tff, 1),
                                rebuild_every=5)
    fin, obs = run(tstate.replace(generators={}), 10)
    for name in ("position", "velocity", "mttk_xi", "mttk_eta"):
        want = getattr(ref, name).numpy()
        np.testing.assert_allclose(getattr(fin, name).numpy(), want, rtol=0,
                                   atol=1e-10 * max(np.abs(want).max(),
                                                    1e-300), err_msg=name)
    if bath == "mttk":
        assert float(fin.mttk_xi[0]) != 0.0
    _obs_close(obs, {k: v for k, v in robs.items() if k != "timestep"},
               1e-10)
    assert not obs["cell_overflow"].any()


def test_twin_matches_jax_xla_tile_path_f64(scene):
    """The tile pass on rank 0's extended grid at S = 2 (halo layers from
    rank 1; S = 1 runs in the whole-runner comparison above): the port's
    twin (through cell_pair_force_slab) against the JAX XLA tile path on
    the JAX tables (what the JAX step runs off the TPU), forces to 1e-10
    max|F|, energies to 1e-10."""
    js, ts, jff, tff, _, _, jstate, tstate = scene
    tplan, jplan = td.plan_domain(ts, tff, 2), jd.plan_domain(js, jff, 2)
    args, cells, key = td.tile_pass_inputs(tff, tplan, tstate)
    f, e_lj, e_ew = ck.cell_pair_force_slab(*args, cells, key)

    jdat = _j_rebuild(jff, jplan, jstate)
    _, sd, _ = jd._scatter_in(jstate, jdat, jplan, jff, None)
    C, Mtot = jplan.C_ext, jplan.Mtot
    clist = jn.CellList(
        bucket_idx=sd.buckets[:C], overflow=jnp.zeros((), bool),
        neighbor_cells=jnp.asarray(jd._ext_neighbor_table(jplan)),
        slot_of=sd.slot[:Mtot])
    cfg = jn.CellListConfig((jplan.cxl + 2,) + jplan.ncells[1:], jplan.cap,
                            jplan.r_cut, 0.0)
    kern = jn.make_fused_cell_kernel(
        jff.lj_eps, jff.lj_sigma, jff.lj_rcut, jff.kappa, jff.n_types,
        uniform_rcut=jff.uniform_rcut)
    f_ref, (elj_ref, eew_ref) = jn.cell_pair_force(
        jnp.asarray(args[0].numpy()), jstate.box_L, clist, cfg, kern,
        features=sd.feat[:Mtot + 1], exclusions=sd.excl[:Mtot + 1])
    f_ref = np.asarray(f_ref)
    np.testing.assert_allclose(f.numpy(), f_ref, rtol=0,
                               atol=1e-10 * np.abs(f_ref).max())
    assert float(e_lj) == pytest.approx(float(elj_ref), rel=1e-10)
    assert float(e_ew) == pytest.approx(float(eew_ref), rel=1e-10)


def test_twin_matches_pallas_slab_kernel_f32():
    """The twin against fused_cell_cols_slab_pallas (K7) in interpret mode
    in f32 at S = 1, with the bounds of tests/test_torch_cell_kernel.py:
    forces to 2e-5 max|F|, LJ to 1e-5, Ewald (A&S erfc in the Pallas
    body) to 1e-3."""
    js, ts, jff, tff, _, _, jstate, tstate = build(np.float32)
    tplan, jplan = td.plan_domain(ts, tff, 1), jd.plan_domain(js, jff, 1)
    args, cells, key = td.tile_pass_inputs(tff, tplan, tstate)
    f, e_lj, e_ew = ck.cell_pair_force_slab(*args, cells, key)
    assert f.dtype == torch.float32

    jdat = _j_rebuild(jff, jplan, jstate)
    pack = jff.cell_pallas_pack
    _, sd, _ = jd._scatter_in(jstate, jdat, jplan, jff, pack)
    C, Mtot = jplan.C_ext, jplan.Mtot
    clist = jn.CellList(
        bucket_idx=sd.buckets[:C], overflow=jnp.zeros((), bool),
        neighbor_cells=jnp.asarray(jd._ext_neighbor_table(jplan)),
        slot_of=sd.slot[:Mtot])
    cfg = jn.CellListConfig((jplan.cxl + 2,) + jplan.ncells[1:], jplan.cap,
                            jplan.r_cut, 0.0)
    from cavmd_tpu.ops.pallas_kernels import fused_cell_cols_slab_pallas

    f_ref, elj_ref, eew_ref = fused_cell_cols_slab_pallas(
        jnp.asarray(args[0].numpy()), jstate.box_L, clist, cfg,
        pack._replace(static_rows=sd.pack_rows[:Mtot + 1]), jff.kappa,
        interpret=True,
        mean_occ=(jplan.n_atoms / jplan.S) / jplan.C_own)
    f_ref = np.asarray(f_ref)[:jplan.Mrow]
    np.testing.assert_allclose(f.numpy()[:tplan.Mrow], f_ref, rtol=0,
                               atol=2e-5 * np.abs(f_ref).max())
    assert float(e_lj) == pytest.approx(float(elj_ref), rel=1e-5)
    assert float(e_ew) == pytest.approx(float(eew_ref), rel=1e-3, abs=1e-9)


def test_adaptive_and_observables_match_unsharded(scene):
    """tests/test_domain.py:250 on the port: adaptive dt (period 2) with
    the dipole and rho(k) observables inside the S = 1 domain step
    against the unsharded adaptive step, 12 steps at a cadence of 5, the
    port's own draws (same generators): positions to 1e-10, dt to 1e-12,
    every observable to 1e-8; dt really moved."""
    _, ts, _, tff, _, tm, _, tstate = scene
    wv = generate_fibonacci_sphere(12) * 1.2
    adaptive = dict(error_tolerance=5e-6, initial_fraction=1e-3,
                    time_constant_ps=50.0, period=2)
    start = tstate.replace(error_tolerance=torch.tensor(5e-9,
                                                        dtype=torch.float64))
    step = make_adaptive_step(
        make_step_fn(tff, tm, extra_obs=make_extra_obs(dipole=True,
                                                       wavevectors=wv)),
        **adaptive)
    ref, robs = run_steps(step, start.replace(generators={}), 12)
    run = td.make_domain_runner(tff, tm, td.plan_domain(ts, tff, 1),
                                rebuild_every=5, adaptive=adaptive,
                                obs_spec=(True, wv))
    fin, obs = run(start.replace(generators={}), 12)
    np.testing.assert_allclose(fin.position.numpy(), ref.position.numpy(),
                               rtol=0, atol=1e-10 * 65.0)
    np.testing.assert_allclose(float(fin.dt), float(ref.dt), rtol=1e-12)
    for k in robs:
        np.testing.assert_allclose(obs[k], robs[k], rtol=1e-8, atol=1e-12,
                                   err_msg=k)
    assert abs(float(fin.dt) - DT) > 1e-6 * DT


def test_simulation_on_one_slab_matches_unsharded(scene):
    """Simulation(shard_atoms=1) runs the slab pipeline in this process
    (no process group) and follows the unsharded Simulation: 12 steps in
    chunks of 6 (a rebuild at each chunk's start), thermalised, same
    seed."""
    _, ts, _, tff, _, tm, _, _ = scene
    sims = []
    for shard in (0, 1):
        sim = Simulation(ts, tff, tm, dt=DT, seed=3, chunk_size=6,
                         shard_atoms=shard)
        sim.thermalize(KT)
        sim.run(n_steps=12)
        sims.append(sim)
    ref, dom = sims
    assert ref._domain_plan is None and dom._domain_plan.S == 1
    np.testing.assert_allclose(dom.state.position.numpy(),
                               ref.state.position.numpy(), rtol=0,
                               atol=1e-10 * 65.0)
    _obs_close(dom.last_obs, {k: v for k, v in ref.last_obs.items()
                              if k != "timestep"}, 1e-9)
    np.testing.assert_array_equal(dom.last_obs["timestep"],
                                  ref.last_obs["timestep"])


def test_padded_scene_keeps_the_slab_path(scene):
    """Ghost rows past the molecules are pair-inert, as the photon is: the
    slab plan takes a ghost-padded scene as the JAX plan does (1101 ->
    1104 rows; every field equal at S = 1 and 2), and
    Simulation(shard_atoms=1) on it runs the slab pipeline and follows the
    unsharded padded run with the dipole and rho(k) observables (the
    ghosts hold no slot; their rho(k) is added once a call): 12 steps in
    chunks of 6, positions to 1e-10, every observable to 1e-9; the ghost
    rows stay where they were."""
    from cavmd_tpu.parallel import pad_snapshot_to as j_pad
    from cavmd_tpu_torch.integrate import ForceField
    from cavmd_tpu_torch.parallel import pad_snapshot_to

    js, ts, _, _, _, tm = scene[:6]
    jp, _ = j_pad(js, 8)
    tp, pad = pad_snapshot_to(ts, 8)
    assert pad == 3
    kw = dict(coupling=1e-3, freq_cm1=2000.0, r_cut=8.0, pair_mode="cell",
              pppm_mesh=(16, 16, 16))
    jff = JForceField.create(jp, dtype=jnp.float64, **kw)
    tff = ForceField.create(tp, **kw)
    for S in (1, 2):
        _same_plan(td.plan_domain(tp, tff, S), jd.plan_domain(jp, jff, S))
    methods = resolve_methods(tp, tm, tff.l_typeid)
    extra = make_extra_obs(dipole=True,
                           wavevectors=generate_fibonacci_sphere(8) * 1.2)
    sims = []
    for shard in (0, 1):
        sim = Simulation(tp, tff, methods, dt=DT, seed=3, chunk_size=6,
                         shard_atoms=shard, extra_obs=extra)
        sim.thermalize(KT)
        sim.run(n_steps=12)
        sims.append(sim)
    ref, dom = sims
    assert ref._domain_plan is None and dom._domain_plan.n0 == tp.N
    np.testing.assert_allclose(dom.state.position.numpy(),
                               ref.state.position.numpy(), rtol=0,
                               atol=1e-10 * 65.0)
    assert "rho_k_re" in dom.last_obs
    _obs_close(dom.last_obs, {k: v for k, v in ref.last_obs.items()
                              if k != "timestep"}, 1e-9)
    assert torch.equal(dom.state.position[ts.N:], tp.position[ts.N:])


def test_s1_excludes_bonded_pairs_across_the_x_face():
    """At S = 1 the halo layers are copies of the slab's own edge layers.
    With 62 molecules across the periodic x face, the port's S = 1 runner
    matches the unsharded port to 1e-10 (the pair key maps a halo copy to
    its resident, so the bonded pair stays excluded), while the JAX S = 1
    runner compares raw ids and counts each such pair through its copy:
    its LJ energy is off by orders of magnitude (ROADMAP.md Queue 3)."""
    js, ts, jff, tff, jm, tm, jstate, tstate = build(shift_x=32.5)
    pos = tstate.position.numpy()
    dx = pos[1:1100:2, 0] - pos[0:1100:2, 0]
    assert (np.abs(dx) > 32.5).sum() == 62
    ref, robs = run_steps(make_step_fn(tff, tm), tstate, 4)
    run = td.make_domain_runner(tff, tm, td.plan_domain(ts, tff, 1),
                                rebuild_every=2)
    fin, obs = run(tstate.replace(generators={}), 4)
    np.testing.assert_allclose(fin.position.numpy(), ref.position.numpy(),
                               rtol=0, atol=1e-10 * 65.0)
    np.testing.assert_allclose(obs["lj"], robs["lj"], rtol=1e-10)

    jrun = jd.make_domain_runner(jff, jm, jd.plan_domain(js, jff, 1),
                                 rebuild_every=2)
    _, jobs = jrun(jstate, 1)
    jref = jax.jit(lambda s: j_run_steps(j_make_step_fn(jff, jm), s, 1))(
        jstate)[1]
    assert float(jobs["lj"][0]) > 100 * float(jref["lj"][0])


class _TwoRanksNoGroup(Communicator):
    """Rank 0 of 2 with no process group: for facade tests that run no
    collective but the start forces' broadcast (the identity here)."""

    def __init__(self):
        super().__init__(0, 2)

    def broadcast(self, t):
        return t


def test_domain_retry_moves_only_the_lever_that_fired(scene):
    """tests/test_domain.py:206's recovery rule on the Simulation facade:
    a capacity overflow grows the plan and keeps the cadence; a coverage
    violation halves the cadence and keeps the plan. The slab Simulation
    drops the carried cell list of init_state (its runner bins each
    chunk)."""
    _, ts, _, tff, _, tm, _, _ = scene
    sim = Simulation(ts, tff, tm, dt=DT, shard_atoms=2,
                     comm=_TwoRanksNoGroup())
    plan = sim._domain_plan
    assert plan.S == 2 and sim.state.cell_list is None
    assert init_state(ts, tff, dt=DT).cell_list is not None
    assert sim._grow_cell_capacity(domain_capacity_overflow=True) > plan.cap
    assert sim._domain_rebuild_every == 20
    grown = sim._domain_plan
    assert sim._grow_cell_capacity() == grown.cap
    assert sim._domain_plan == grown and sim._domain_rebuild_every == 10


def _row_runs(snap, ff, methods, S, n_steps, extra_obs=None):
    """``Simulation(shard_atoms=S)`` on S thread ranks (the route the
    JAX facade takes to GSPMD: here atom sharding by rows) and the
    unsharded run, ``n_steps`` steps each from seed 3: (per-rank final
    positions, routes, the unsharded final positions)."""
    from thread_ranks import run_threads

    def run(comm):
        sim = Simulation(snap, ff, methods, dt=DT, seed=3, shard_atoms=S,
                         comm=comm, extra_obs=extra_obs)
        sim.run(n_steps=n_steps)
        return (sim.state.position,
                (sim._domain_plan is None, sim.ff.row_comm is comm))

    ranks = run_threads(S, run)
    ref = Simulation(snap, ff, methods, dt=DT, seed=3, extra_obs=extra_obs)
    ref.run(n_steps=n_steps)
    return ranks, ref.state.position


def test_unsupported_configurations_raise(scene):
    """What the JAX Simulation sends to GSPMD sharding runs on atom
    sharding by rows here, and matches the unsharded run to 1e-10: dense
    mode, an opaque ``extra_obs``, and a box too narrow for the slabs (60
    diatomics in a 24-bohr box: 2 cells an axis at r_cut 8). As in the JAX
    facade, a row split of an N that S does not divide raises ValueError
    (pad the snapshot first). Methods the JAX slab path refuses raise
    ValueError in the slab step, and its MTTK and Berendsen baths
    build."""
    from cavmd_tpu_torch.integrate import ForceField
    from cavmd_tpu_torch.parallel import pad_snapshot_to

    _, ts, _, tff, _, tm, _, _ = scene
    narrow = t_add(t_make(60, box_L=24.0, temperature_K=100.0, seed=5,
                          device="cpu"),
                   coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0,
                   seed=6)
    kw = dict(coupling=1e-3, r_cut=8.0, pppm_mesh=(16, 16, 16))
    for snap, S, mode, extra in ((ts, 2, "dense", None),
                                 (ts, 2, "cell", lambda state: {}),
                                 (narrow, 2, "cell", None)):
        with pytest.raises(ValueError, match="pad the snapshot first"):
            Simulation(snap, ForceField.create(snap, pair_mode=mode, **kw),
                       tm, dt=DT, shard_atoms=S, comm=Communicator(0, S),
                       extra_obs=extra)
        padded, _ = pad_snapshot_to(snap, S)
        ff = ForceField.create(padded, pair_mode=mode, **kw)
        methods = resolve_methods(padded, tm, ff.l_typeid)
        ranks, ref = _row_runs(padded, ff, methods, S, 2, extra)
        for pos, route in ranks:
            assert route == (True, True), (S, mode)
            np.testing.assert_allclose(pos.numpy(), ref.numpy(), rtol=0,
                                       atol=1e-10)
        assert not torch.equal(ref, padded.position)
    for bath in ("mttk", "berendsen"):  # the JAX slab path's baths
        assert callable(td.make_domain_step(
            tff, resolve_methods(ts, (MethodSpec(kind=bath, group="all",
                                                 kT=KT, tau=TAU),), 0),
            td.plan_domain(ts, tff, 1), Communicator()))
    with pytest.raises(ValueError, match="brownian"):
        td.make_domain_step(
            tff, resolve_methods(ts, (MethodSpec(kind="brownian",
                                                 group="molecular", kT=KT,
                                                 gamma=GAMMA),), 0),
            td.plan_domain(ts, tff, 1), Communicator())
    with pytest.raises(ValueError, match="2 ranks"):
        td.make_domain_runner(tff, tm, td.plan_domain(ts, tff, 1),
                              Communicator(0, 2))
