"""The generic (polyatomic) topology paths of cavmd_tpu_torch against the
JAX package, on the OCO triatomic liquid of tests/test_polyatomic.py
(bonds [[3m, 3m+1], [3m, 3m+2]], not the consecutive-pair pattern, so the
scatter bonds, the scatter Ewald exclusion correction, the dense exclusion
mask and degree-2 exclusion rows run), in float64 on the CPU:

- the generic paths are selected (no strided bonds, 2 exclusion columns);
- the dense ForceField's forces and energies match JAX's to 1e-10;
- cell mode matches the port's dense mode and JAX's cell mode to 1e-10;
- the bond and exclusion paths agree op by op with JAX's;
- the slab runner at S = 1 matches JAX's unsharded run to 1e-10 (JAX's
  draws injected);
- a 2000-step NVE run conserves the total energy, as the JAX test holds.
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
from cavmd_tpu.ops import bonds as jbonds
from cavmd_tpu.ops import ewald as jewald
from cavmd_tpu_torch.core.snapshot import Snapshot
from cavmd_tpu_torch.integrate import (
    ForceField,
    MethodSpec,
    init_state,
    make_step_fn,
    potential_energy,
    resolve_methods,
    run_steps,
)
from cavmd_tpu_torch.interop import state_from_numpy
from cavmd_tpu_torch.ops import bonds as tbonds
from cavmd_tpu_torch.ops import ewald as tewald
from cavmd_tpu_torch.ops import lj as tlj
from cavmd_tpu_torch.ops import neighbor as tn
from cavmd_tpu_torch.parallel import domain as td

from test_torch_cuda import TRI_BONDS, TRI_LJ, triatomic_arrays
from test_torch_integrate import JaxNoise

R0, KB = TRI_BONDS["C-O"]["r0"], TRI_BONDS["C-O"]["k"]
FF_KW = dict(enable_cavity=False, lj_params=TRI_LJ, bond_params=TRI_BONDS)
KT = PC.kT_from_kelvin(100.0)
TOL = 1e-10


def both(n_mol=27, box_L=36.0, seed=0, velocity_K=None):
    """The scene in both packages (the same bits), with Maxwell velocities
    at ``velocity_K`` when given."""
    a = triatomic_arrays(n_mol, box_L, seed)
    if velocity_K is not None:
        rng = np.random.default_rng(seed + 7)
        a["velocity"] = rng.normal(size=a["position"].shape) * np.sqrt(
            PC.kT_from_kelvin(velocity_K) / a["mass"])[:, None]
    js = JSnapshot.create(a.pop("position"), dtype=jnp.float64, **{
        k: a[k] for k in a})
    ts = Snapshot.create(np.asarray(js.position), dtype=torch.float64,
                         device="cpu", **{k: a[k] for k in a})
    return js, ts


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: its tensors are small, and the
    suite runs six workers on the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tri():
    js, ts = both()
    kw = dict(FF_KW, r_cut=12.0, pppm_mesh=(16, 16, 16))
    return dict(js=js, ts=ts, kw=kw, jff=JForceField.create(js, **kw),
                tff=ForceField.create(ts, **kw),
                jcell=JForceField.create(js, pair_mode="cell", **kw),
                tcell=ForceField.create(ts, pair_mode="cell", **kw))


def _j_compute(jff, js):
    return jax.jit(lambda p: jff.compute(
        p, js.image, js.box_L, js.charge, js.typeid, js.bond_group,
        js.bond_typeid))(js.position)


def _t_compute(tff, ts):
    clist = (tff.build_cells(ts.position, ts.box_L)
             if tff.pair_mode != "dense" else None)
    with torch.no_grad():
        return tff(ts.position, ts.image, ts.box_L, ts.charge, ts.typeid,
                   clist=clist)


def _close_forces(f, e, f_ref, e_ref, keys, tol=TOL):
    f_ref = np.asarray(f_ref)
    np.testing.assert_allclose(f.numpy(), f_ref, rtol=0,
                               atol=tol * np.abs(f_ref).max())
    for k in keys:
        want = float(e_ref[k])
        np.testing.assert_allclose(float(e[k]), want, rtol=tol,
                                   atol=1e-14, err_msg=k)


def test_generic_paths_selected(tri):
    ts, tff, tcell = tri["ts"], tri["tff"], tri["tcell"]
    assert not tff.bonds_strided and not tcell.bonds_strided
    assert tcell.cell_exclusions.shape == (ts.N + 1, 2)
    table = tcell.cell_exclusions.numpy()
    # each carbon's row holds both its oxygens; each oxygen its carbon
    np.testing.assert_array_equal(table[0:3], [[1, 2], [0, ts.N],
                                               [0, ts.N]])
    np.testing.assert_array_equal(
        table, tn.exclusion_table(ts.N, ts.bond_group.numpy()))
    assert np.asarray(tri["jcell"].cell_exclusions).shape[1] == 2


def test_dense_forces_match_jax(tri):
    """Forces and every energy term of the dense ForceField (K1's twin
    with the (N, N) exclusion mask, scatter bonds and exclusion
    correction) to 1e-10; the same kappa."""
    assert tri["tff"].kappa_value == pytest.approx(float(tri["jff"].kappa),
                                                   rel=1e-15)
    f_ref, e_ref = _j_compute(tri["jff"], tri["js"])
    f, e = _t_compute(tri["tff"], tri["ts"])
    _close_forces(f, e, f_ref, e_ref, ("harmonic", "lj", "ewald_short",
                                       "ewald_long"))
    assert float(e["harmonic"]) > 0 and float(e["lj"]) != 0


def test_cell_mode_matches_dense_and_jax(tri):
    """The cell tile twin with degree-2 exclusion rows: against the port's
    dense mode and JAX's cell mode, to 1e-10; no overflow."""
    f_d, e_d = _t_compute(tri["tff"], tri["ts"])
    f_c, e_c = _t_compute(tri["tcell"], tri["ts"])
    assert not bool(e_c["cell_overflow"])
    keys = ("harmonic", "lj", "ewald_short", "ewald_long")
    _close_forces(f_c, e_c, f_d.numpy(), {k: e_d[k] for k in keys}, keys)
    f_j, e_j = _j_compute(tri["jcell"], tri["js"])
    _close_forces(f_c, e_c, f_j, e_j, keys)


def test_bond_paths_agree(tri):
    """Op by op on the shared-centre topology: the scatter bonds against
    JAX's scatter and incidence paths, the scatter Ewald exclusion
    correction against JAX's, and the dense exclusion mask against the
    bond table (both directions, nothing else)."""
    js, ts = tri["js"], tri["ts"]
    k1 = np.asarray([KB])
    r1 = np.asarray([R0])
    f, e = tbonds.harmonic_bond_force(
        ts.position, ts.box_L, ts.bond_group, ts.bond_typeid,
        torch.tensor(k1), torch.tensor(r1))
    f_sc, e_sc = jbonds.harmonic_bond_force(
        js.position, js.box_L, js.bond_group, js.bond_typeid,
        jnp.asarray(k1), jnp.asarray(r1))
    gi, gj = jbonds.bond_incidence(js.N, js.bond_group, jnp.float64)
    f_in, e_in = jbonds.harmonic_bond_force_incidence(
        js.position, js.box_L, gi, gj, jnp.full((js.n_bonds,), KB),
        jnp.full((js.n_bonds,), R0))
    for f_ref, e_ref in ((f_sc, e_sc), (f_in, e_in)):
        np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=0,
                                   atol=1e-12)
        assert float(e) == pytest.approx(float(e_ref), rel=1e-12)

    kappa = float(tri["jff"].kappa)
    fc, ec = tewald.ewald_exclusion_correction(
        ts.position, ts.box_L, ts.charge, kappa, ts.bond_group)
    fc_ref, ec_ref = jewald.ewald_exclusion_correction(
        js.position, js.box_L, js.charge, kappa, js.bond_group)
    fc_ref = np.asarray(fc_ref)
    np.testing.assert_allclose(fc.numpy(), fc_ref, rtol=0,
                               atol=1e-12 * np.abs(fc_ref).max())
    assert float(ec) == pytest.approx(float(ec_ref), rel=1e-12)

    mask = tlj.bond_exclusion_mask(ts.N, ts.bond_group.numpy())
    want = np.zeros((ts.N, ts.N), bool)
    bg = ts.bond_group.numpy()
    want[bg[:, 0], bg[:, 1]] = want[bg[:, 1], bg[:, 0]] = True
    np.testing.assert_array_equal(np.asarray(mask), want)


@pytest.fixture(scope="module")
def slab_scene():
    """tests/test_polyatomic.py:test_domain_matches_unsharded_polyatomic's
    scene: 216 OCO in a 72-bohr box, r_cut 8, cell mode, Bussi 100 K
    (tau 1 ps) on the molecules, thermal velocities."""
    js, ts = both(n_mol=216, box_L=72.0, seed=3, velocity_K=100.0)
    kw = dict(FF_KW, r_cut=8.0, pppm_mesh=(16, 16, 16), pair_mode="cell")
    jff, tff = JForceField.create(js, **kw), ForceField.create(ts, **kw)
    tau = PC.ps_to_atomic_units(1.0)
    jm = j_resolve_methods(js, (JMethodSpec(kind="bussi", group="molecular",
                                            kT=KT, tau=tau),), jff.l_typeid)
    tm = resolve_methods(ts, (MethodSpec(kind="bussi", group="molecular",
                                         kT=KT, tau=tau),), tff.l_typeid)
    jstate = j_init_state(js, jff, dt=PC.fs_to_atomic_units(0.5), seed=5)
    jfin, jobs = jax.jit(lambda s: j_run_steps(j_make_step_fn(jff, jm), s,
                                               10))(jstate)
    tstate = state_from_numpy(
        **{k: np.asarray(getattr(jstate, k)) for k in (
            "position", "image", "velocity", "mass", "charge", "typeid",
            "box_L", "forces", "dt", "time_au", "time_comp", "timestep",
            "bussi_reservoir", "bussi_instantaneous", "langevin_reservoir")},
        seed=5, device="cpu")
    return dict(ts=ts, tff=tff, tm=tm, jstate=jstate, jfin=jfin, jobs=jobs,
                tstate=tstate)


def test_slab_s1_matches_jax_unsharded(slab_scene):
    """The port's slab runner at S = 1 (3-atom intact slots with two
    bonds each and degree-2 exclusion rows, rebuilt every 4 steps) against
    JAX's unsharded run, 10 Bussi steps with JAX's draws injected:
    positions, velocities and the energy terms to 1e-10."""
    s = slab_scene
    plan = td.plan_domain(s["ts"], s["tff"], 1)
    assert (plan.apm, plan.nbm, plan.B) == (3, 2, 2)
    run = td.make_domain_runner(s["tff"], s["tm"], plan, rebuild_every=4,
                                noise=JaxNoise(s["jstate"].key))
    fin, obs = run(s["tstate"], 10)
    assert not obs["cell_overflow"].any()
    for name in ("position", "velocity"):
        j = np.asarray(getattr(s["jfin"], name))
        np.testing.assert_allclose(getattr(fin, name).numpy(), j, rtol=0,
                                   atol=TOL * np.abs(j).max(), err_msg=name)
    for k in ("harmonic", "lj", "ewald_short", "ewald_long",
              "kinetic_molecular", "bussi_reservoir_molecular"):
        want = np.asarray(s["jobs"][k])
        np.testing.assert_allclose(obs[k], want, rtol=0,
                                   atol=TOL * np.abs(want).max(), err_msg=k)


def test_slab_s1_matches_port_unsharded(slab_scene):
    """The same 10 steps through the port's unsharded step (cell mode,
    carried list) and through its S = 1 runner, the port's own
    generators on both: to 1e-10."""
    s = slab_scene
    ref, robs = run_steps(make_step_fn(s["tff"], s["tm"]),
                          init_state(s["ts"], s["tff"],
                                     dt=PC.fs_to_atomic_units(0.5), seed=5),
                          10)
    run = td.make_domain_runner(s["tff"], s["tm"],
                                td.plan_domain(s["ts"], s["tff"], 1),
                                rebuild_every=4)
    fin, obs = run(s["tstate"].replace(generators={}), 10)
    np.testing.assert_allclose(fin.position.numpy(), ref.position.numpy(),
                               rtol=0, atol=TOL * 72.0)
    for k in ("harmonic", "lj", "ewald_short", "ewald_long"):
        np.testing.assert_allclose(obs[k], robs[k], rtol=TOL, err_msg=k)


def test_nve_energy_conservation(tri):
    """tests/test_polyatomic.py:test_nve_energy_conservation on the port:
    2000 f64 NVE steps of 0.125 fs from 60 K velocities change the total
    energy by less than 1e-4 Ha (wrong forces on the generic paths miss
    it by orders of magnitude)."""
    _, ts = both(velocity_K=60.0)
    ff = tri["tff"]
    methods = resolve_methods(ts, (MethodSpec(kind="nve", group="all"),),
                              ff.l_typeid)
    state = init_state(ts, ff, dt=PC.fs_to_atomic_units(0.125), seed=3)
    _, obs = run_steps(make_step_fn(ff, methods), state, 2000)
    total = potential_energy(obs) + obs["kinetic_molecular"]
    assert np.all(np.isfinite(total))
    assert abs(total[-1] - total[0]) < 1e-4
    assert np.abs(total - total[0]).max() > 0
