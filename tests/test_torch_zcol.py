"""The z-sorted column mode of cavmd_tpu_torch (pair_mode='zcol') against
the JAX package: the column plan, window plan and list build equal
cavmd_tpu.ops.neighbor's bit for bit; the zcol twin (ops/zcol_kernels.py)
against the XLA tile path in float64 (at build and drifted positions) and
against the TPU kernel fused_zsort_cols_pallas (K9) in interpret mode in
float32, window flag included; a float64 trajectory against JAX cell mode;
the window-overflow retry; build_large_n; and the size of the JAX zcol
pass's float32 downcast.

Scenes (diatomics + photon at the reference density unless stated, r_cut
12 bohr): 60 molecules in a 40-bohr box (3 x 3 columns, one-block hulls;
tests/test_pallas.py:238), 500 molecules (4 x 4 columns, NB = 9, hulls of
up to 5 blocks) and 2000 molecules in a 92-bohr box (7 x 7 columns, cap
256, hulls of two runs across the z seam).
"""

from functools import partial

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
from cavmd_tpu.ops import neighbor as jn
from cavmd_tpu.ops import pallas_kernels as jpk
from cavmd_tpu_torch import Simulation
from cavmd_tpu_torch.core import PhysicalConstants as PC
from cavmd_tpu_torch.core.system import reference_box_for
from cavmd_tpu_torch.integrate import (
    OBS_KEYS,
    ForceField,
    MethodSpec,
    make_step_fn,
    resolve_methods,
    run_steps,
)
from cavmd_tpu_torch.interop import state_from_numpy
from cavmd_tpu_torch.ops import neighbor as tn
from cavmd_tpu_torch.ops import zcol_kernels as zk

from test_torch_integrate import JaxNoise
from test_torch_ops import assert_energy, assert_forces, scene

R_CUT = 12.0
# (n_mol, box_L, seed)
SCENES = {"60": (60, 40.0, 3), "500": (500, reference_box_for(500), 3),
          "2000": (2000, reference_box_for(2000), 3)}
KT = PC.kT_from_kelvin(100.0)
TAU = PC.ps_to_atomic_units(5.0)
GAMMA = PC.gamma_from_tau_ps(5.0)
SPEC = (("bussi", "molecular", dict(kT=KT, tau=TAU)),
        ("langevin", "cavity", dict(kT=KT, gamma=GAMMA)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: its tensors are small, and the
    suite runs six workers on the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _scene(name, dtype=torch.float64):
    n_mol, box_L, seed = SCENES[name]
    js, ts = scene(n_mol=n_mol, box_L=box_L, seed=seed, jitter=0.0)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    return js.astype(jdt), ts.astype(dtype)


def _jax_build_zcol(cfg):
    """JAX's build_zcol_list under one jit: the eager call compiles each of
    its ~200 operations on first use, several seconds a scene."""
    return jax.jit(lambda p, b: jn.build_zcol_list(p, b, cfg))


def _pair_args(ff, position, box_L, clist, ts):
    return (position, box_L, clist, ff.cell_cfg, ts.typeid, ts.charge,
            ff.lj_eps, ff.lj_sig2, ff.lj_rcut2, ff.lj_vshift,
            ff.cell_exclusions, ff.kappa_value, ff.zcol_W)


def _hull(ff, position, box_L, clist):
    pos_loc = zk.zcol_local_positions(position, box_L, clist)
    return zk.zcol_hull(pos_loc, box_L, clist, ff.cell_cfg, ff.zcol_W)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_plans_and_build_equal_jax(name, dtype):
    """plan_zcolumns, plan_zcol_window and the xy neighbour table equal the
    JAX package's; build_zcol_list's bucket_idx, slot_of and halo_idx are
    bit-equal to JAX's and local_anchor matches to 1e-12, in the working
    dtype."""
    js, ts = _scene(name, dtype)
    cfg = tn.plan_zcolumns(ts.box_L.double().numpy(), R_CUT, skin=0.5,
                           n=ts.N)
    assert cfg == jn.plan_zcolumns(np.asarray(js.box_L, np.float64), R_CUT,
                                   skin=0.5, n=js.N)
    cx, cy, _ = cfg.ncells
    assert cfg.cap % 128 == 0 and min(cx, cy) >= 3
    assert zk.plan_zcol_window(ts.N, cx * cy, (cx, cy)) == \
        jpk.plan_zcol_window(js.N, cx * cy, (cx, cy))
    table = tn.xy_neighbor_table(cx, cy)
    np.testing.assert_array_equal(table, jpk._xy_neighbor_table(cx, cy))
    tl = tn.build_zcol_list(ts.position, ts.box_L, cfg,
                            torch.as_tensor(table))
    # float32 stays eager: under jit XLA fuses local_anchor's arithmetic
    # and rounds it 1 ulp away from the op-by-op result the port follows
    build = (partial(jn.build_zcol_list, cfg=cfg) if dtype == torch.float32
             else _jax_build_zcol(cfg))
    jl = build(js.position, js.box_L)
    for k in ("bucket_idx", "slot_of", "halo_idx"):
        np.testing.assert_array_equal(getattr(tl, k).numpy(),
                                      np.asarray(getattr(jl, k)), err_msg=k)
    assert not bool(tl.overflow) and not bool(jl.overflow)
    np.testing.assert_allclose(tl.local_anchor.numpy(),
                               np.asarray(jl.local_anchor), rtol=0,
                               atol=1e-12)
    assert torch.equal(tl.anchor, ts.position)
    halo = tl.halo_idx.numpy()
    for row in halo:  # real slots first, every column's particles once
        real = row[row < ts.N]
        assert (row[:len(real)] == real).all() and len(set(real)) == len(real)


@pytest.fixture(scope="module")
def drift_scene():
    """The 2000-molecule scene, its port zcol ForceField and column list,
    and the JAX XLA bucket-tile reference (fresh build_cell_list, then
    cell_pair_force with make_fused_cell_kernel) under one jit, shared by
    the four drift trials."""
    js, ts = _scene("2000")
    tff = ForceField.create(ts, coupling=1e-3, pair_mode="zcol", r_cut=R_CUT,
                            pppm_mesh=(8, 8, 8))
    jff = JForceField.create(js, coupling=1e-3, pair_mode="cell",
                             r_cut=R_CUT, pppm_mesh=(8, 8, 8))
    jcfg = jn.CellListConfig(*jff.cell_cfg)
    kern = jn.make_fused_cell_kernel(jff.lj_eps, jff.lj_sigma, jff.lj_rcut,
                                     jff.kappa, jff.n_types,
                                     uniform_rcut=jff.uniform_rcut)

    @jax.jit
    def reference(pos):
        jl = jn.build_cell_list(pos, js.box_L, jcfg, jff.cell_neighbors)
        return jn.cell_pair_force(
            pos, js.box_L, jl, jcfg, kern, features=jff.cell_features,
            exclusions=jff.cell_exclusions, cell_block=jff.cell_block)

    return js, ts, tff, tff.build_cells(ts.position, ts.box_L), reference


@pytest.mark.parametrize("trial", [0, 1, 2, 3])
def test_twin_matches_xla_tile_path_f64(trial, drift_scene):
    """On the 2000-molecule scene, against cell_pair_force with
    make_fused_cell_kernel on a fresh bucket list, to 1e-10 (forces of
    max|F|, energies relative): at the build positions (trial 0) and after
    a total drift of trial/3 x 0.49 skin from them, re-wrapped, with the
    column list still the one built at the start
    (tests/test_pallas.py:256-294). The scene holds i-blocks with a
    second hull run and i-blocks with none, and the window prunes."""
    js, ts, tff, zlist, reference = drift_scene
    cfg = tff.cell_cfg
    assert cfg.ncells == (7, 7, 1) and cfg.cap == 256
    direction = np.random.default_rng(0).uniform(-1, 1, size=(ts.N, 3))
    direction *= 0.49 * cfg.skin / np.abs(direction).max()
    box = np.asarray(js.box_L)
    pos = np.asarray(js.position) + direction * (trial / 3.0)
    pos = pos - box * np.round(pos / box)
    position = torch.as_tensor(pos)

    hull, flag, W = _hull(tff, position, ts.box_L, zlist)
    nb = 9 * cfg.cap // 128
    h = hull.numpy()
    assert not bool(flag) and W == tff.zcol_W
    assert (h[..., 2] < nb).any(), "no i-block with a second run"
    assert (h[..., 1] == 0).any(), "no i-block past its column"
    real_blocks = -(-(zlist.halo_idx < ts.N).sum(1).numpy() // 128)
    assert (h[..., 3] < real_blocks[:, None])[h[..., 1] > 0].any(), \
        "the window never prunes"

    f_ref, (elj_ref, eew_ref) = reference(jnp.asarray(pos))
    f, e_lj, e_ew, win = zk.zcol_pair_force(
        *_pair_args(tff, position, ts.box_L, zlist, ts))
    assert not bool(win)
    assert_forces(f, f_ref)
    assert_energy(e_lj, elj_ref)
    assert_energy(e_ew, eew_ref)


@pytest.mark.parametrize("name", ["60", "500"])
def test_twin_matches_pallas_zcol_kernel_f32(name):
    """Against fused_zsort_cols_pallas in interpret mode, float32, on the
    same column list: forces to 2e-5 of max|F| and energies with
    tests/test_pallas.py:280's bounds (the Pallas body uses the A&S erfc,
    1.5e-7 absolute, so Ewald gets 1e-3 relative). On the 500-molecule
    scene the window is forced below the largest hull, and both flag the
    overflow and drop the same blocks; its LJ energy (-1.4e-2 Ha) is a sum
    of ~1e5 float32 terms of both signs, which the two kernels and a
    float64 evaluation of the same pairs give 1.1e-5 to 3.5e-5 apart, so
    it is held to 1e-4 relative there."""
    js, ts = _scene(name, torch.float32)
    jff = JForceField.create(js, coupling=1e-3, pair_mode="zcol",
                             r_cut=R_CUT, pppm_mesh=(8, 8, 8),
                             dtype=jnp.float32)
    tff = ForceField.create(ts, coupling=1e-3, pair_mode="zcol", r_cut=R_CUT,
                            pppm_mesh=(8, 8, 8))
    assert tff.cell_cfg == jn.CellListConfig(*jff.cell_cfg)
    assert tff.zcol_W == jff.zcol_W
    cfg = tff.cell_cfg
    tl = tff.build_cells(ts.position, ts.box_L)
    jl = _jax_build_zcol(cfg)(js.position, js.box_L)
    hull, _, _ = _hull(tff, ts.position, ts.box_L, tl)
    most = int(hull[..., 3].max())
    if name == "500":
        tff.zcol_W = most - 2
        assert tff.zcol_W >= 1
    f_ref, elj_ref, eew_ref, win_ref = jax.jit(
        lambda p, b, cl: jpk.fused_zsort_cols_pallas(
            p, b, cl, cfg, jff.cell_pallas_pack, jff.kappa, interpret=True,
            W=tff.zcol_W))(js.position, js.box_L, jl)
    f, e_lj, e_ew, win = zk.zcol_pair_force(
        *_pair_args(tff, ts.position, ts.box_L, tl, ts))
    assert f.dtype == torch.float32
    assert bool(win) == bool(win_ref) == (name == "500")
    assert_forces(f, f_ref, rtol=2e-5)
    lj_rel = 1e-5 if name == "60" else 1e-4
    assert float(e_lj) == pytest.approx(float(elj_ref), rel=lj_rel)
    assert float(e_ew) == pytest.approx(float(eew_ref), rel=1e-3, abs=1e-9)


def _traj_build():
    """tests/test_torch_neighbor.py's 40-diatomic scene in a 36-bohr box,
    the photon with a thermal velocity, r_cut 11.95: 3 x 3 columns with a
    0.05-bohr skin, so the column list is rebuilt within 20 steps."""
    js, ts = scene(n_mol=40, box_L=36.0, seed=11, jitter=0.0)
    v = np.asarray(js.velocity).copy()
    v[-1] = np.random.default_rng(13).normal(0.0, np.sqrt(KT), size=3)
    return (js.replace(velocity=jnp.asarray(v)),
            ts.replace(velocity=torch.as_tensor(v)))


def test_trajectory_matches_jax_cell_mode_f64():
    """20 f64 Bussi + Langevin steps of the port in zcol mode, with the JAX
    package's draws injected, against the JAX package's run_steps in cell
    mode: positions, velocities, images and every observable to 1e-10 of
    their scale; the carried column list is rebuilt along the way
    (tests/test_pallas.py:297, made stricter)."""
    js, ts = _traj_build()
    rc, skin = 11.95, 0.05
    jff = JForceField.create(js, coupling=1e-3, pair_mode="cell", r_cut=rc,
                             pppm_mesh=(8, 8, 8), cell_skin=skin)
    tff = ForceField.create(ts, coupling=1e-3, pair_mode="zcol", r_cut=rc,
                            pppm_mesh=(8, 8, 8), cell_skin=skin)
    assert tff.cell_cfg.ncells == (3, 3, 1)
    assert tff.cell_cfg.skin == pytest.approx(0.05)
    dt = PC.fs_to_atomic_units(0.5)
    jspec = tuple(JMethodSpec(kind=k, group=g, **kw) for k, g, kw in SPEC)
    jm = j_resolve_methods(js, jspec, jff.l_typeid)
    jstate = j_init_state(js, jff, dt=dt, seed=3)
    jfinal, jobs = jax.jit(
        lambda s: j_run_steps(j_make_step_fn(jff, jm), s, 20))(jstate)

    tstate = state_from_numpy(
        **{k: np.asarray(getattr(jstate, k)) for k in (
            "position", "image", "velocity", "mass", "charge", "typeid",
            "box_L", "forces", "dt", "time_au", "time_comp", "timestep",
            "bussi_reservoir", "bussi_instantaneous", "langevin_reservoir")},
        seed=3, forcefield=tff, device="cpu")
    assert tstate.cell_list.halo_idx is not None
    tspec = tuple(MethodSpec(kind=k, group=g, **kw) for k, g, kw in SPEC)
    step = make_step_fn(tff, resolve_methods(ts, tspec, tff.l_typeid),
                        noise=JaxNoise(jstate.key))
    tfinal, tobs = run_steps(step, tstate, 20)

    assert not torch.equal(tfinal.cell_anchor, tstate.position), \
        "the column list was never rebuilt"
    assert torch.equal(tfinal.cell_list.anchor, tfinal.cell_anchor)
    for name in ("position", "velocity"):
        j = np.asarray(getattr(jfinal, name))
        np.testing.assert_allclose(getattr(tfinal, name).numpy(), j, rtol=0,
                                   atol=1e-10 * np.abs(j).max())
    np.testing.assert_array_equal(tfinal.image.numpy(),
                                  np.asarray(jfinal.image))
    for k in OBS_KEYS + ("cell_overflow",):
        j = np.asarray(jobs[k], dtype=np.float64)
        np.testing.assert_allclose(tobs[k], j, rtol=0,
                                   atol=1e-10 * max(np.abs(j).max(), 1e-12),
                                   err_msg=k)


class _Keep:
    def __init__(self):
        self.chunks = []

    def consume(self, obs):
        self.chunks.append(obs)


def test_window_overflow_retry_matches_the_planned_window():
    """A zcol Simulation on the 500-molecule scene started at W = 1 flags
    the window overflow, grows cap and W (1 -> 3 -> 5, the largest hull
    has 5 blocks) and reruns the chunk from its start; positions,
    velocities, forces, every observable and the generator states equal a
    run planned with the default window, to 1e-12."""
    _, ts = _scene("500")
    spec = tuple(MethodSpec(kind=k, group=g, **kw) for k, g, kw in SPEC)
    runs = []
    for window in (1, None):
        ff = ForceField.create(ts, coupling=1e-3, pair_mode="zcol",
                               r_cut=R_CUT, pppm_mesh=(8, 8, 8))
        planned = ff.zcol_W
        if window is not None:
            ff.zcol_W = window
        sim = Simulation(ts, ff, spec, dt=PC.fs_to_atomic_units(0.25),
                         seed=4, chunk_size=3)
        keep = _Keep()
        sim.trackers.append(keep)
        sim.run(n_steps=6)
        runs.append((sim, keep.chunks))
    (small, obs_s), (large, obs_l) = runs
    assert small.ff.zcol_W == 5 and small.ff.cell_cfg.cap == 512
    assert large.ff.zcol_W == planned and large.ff.cell_cfg.cap == 128
    for name in ("position", "velocity", "forces"):
        np.testing.assert_allclose(getattr(small.state, name).numpy(),
                                   getattr(large.state, name).numpy(),
                                   rtol=0, atol=1e-12)
    assert len(obs_s) == len(obs_l) == 2
    for a, b in zip(obs_s, obs_l):
        assert not a["cell_overflow"].any() and not b["cell_overflow"].any()
        for k in OBS_KEYS:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-12,
                                       err_msg=k)
    gens_s, gens_l = small.state.generators, large.state.generators
    assert set(gens_s) == set(gens_l)
    for key in gens_s:
        assert torch.equal(gens_s[key].get_state(), gens_l[key].get_state())


def test_build_large_n_zcol():
    """build_large_n(100, pair_mode='zcol'): the box (33.9 bohr) has 2
    columns of r_cut + skin per axis, and the port refuses it as the JAX
    package does. At 300 molecules (N = 601, 3 x 3 columns) it builds and
    steps: 20 f32 steps with no overflow, the universe energy within the
    f32 band of tests/test_torch_neighbor.py's build_large_n test."""
    from cavmd_tpu.drivers.workloads import build_large_n as j_build_large_n
    from cavmd_tpu_torch.drivers.workloads import build_large_n
    from cavmd_tpu_torch.integrate import universe_energy

    for build in (j_build_large_n,
                  lambda *a, **kw: build_large_n(*a, device="cpu", **kw)):
        with pytest.raises(ValueError, match="columns per xy axis"):
            build(100, pair_mode="zcol")
    sim, snap, ff = build_large_n(300, pair_mode="zcol", device="cpu")
    assert snap.N == 601 and ff.pair_mode == "zcol"
    assert ff.cell_cfg.ncells == (3, 3, 1) and ff.cell_neighbors is None
    assert sim.state.cell_list.halo_idx is not None
    assert sim.run(n_steps=20) == 20
    obs = sim.last_obs
    assert not obs["cell_overflow"].any()
    assert sim.state.position.dtype == torch.float32
    eu = universe_energy(obs)
    assert eu.shape == (20,) and np.ptp(eu) < 5e-3


def test_jax_zcol_f64_runs_its_pair_pass_in_f32():
    """The JAX package's zcol mode casts positions to float32 for its pair
    pass (pallas_kernels.py:1405, 1418) even in a float64 run: on the
    60-molecule scene its forces differ from its own float64 cell mode by
    about 1e-7 of max|F| (this test holds the size between 1e-9 and 1e-5),
    while the port's zcol mode in float64 matches JAX cell mode to 1e-10
    (ROADMAP.md, Queue 3)."""
    js, ts = _scene("60")
    args = (js.position, js.image, js.box_L, js.charge, js.typeid,
            js.bond_group, js.bond_typeid)
    forces = {}
    for mode in ("cell", "zcol"):
        jff = JForceField.create(js, coupling=1e-3, pair_mode=mode,
                                 r_cut=R_CUT, pppm_mesh=(8, 8, 8))
        forces[mode] = np.asarray(jax.jit(jff.compute)(*args)[0])
    scale = np.abs(forces["cell"]).max()
    size = np.abs(forces["zcol"] - forces["cell"]).max() / scale
    assert 1e-9 < size < 1e-5, size
    tff = ForceField.create(ts, coupling=1e-3, pair_mode="zcol", r_cut=R_CUT,
                            pppm_mesh=(8, 8, 8))
    f, _ = tff(ts.position, ts.image, ts.box_L, ts.charge, ts.typeid)
    assert_forces(f, forces["cell"])
