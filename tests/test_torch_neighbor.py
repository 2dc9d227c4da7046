"""Cell lists of cavmd_tpu_torch against cavmd_tpu.ops.neighbor: the host
tables and the bucket build equal the JAX package's exactly; cell-mode
trajectories against run_steps (float64); the carried list against a
rebuild every step; the Simulation's overflow retry; build_large_n."""

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
from cavmd_tpu_torch import Simulation
from cavmd_tpu_torch.core import PhysicalConstants as PC
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
from cavmd_tpu_torch.ops import neighbor as tn

from test_torch_cell_kernel import GRIDS, port_cell_forcefield
from test_torch_integrate import JaxNoise
from test_torch_ops import scene

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


def _same_list(tl, jl):
    np.testing.assert_array_equal(tl.bucket_idx.numpy(),
                                  np.asarray(jl.bucket_idx))
    np.testing.assert_array_equal(tl.slot_of.numpy(), np.asarray(jl.slot_of))
    assert bool(tl.overflow) == bool(jl.overflow)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_host_tables_and_build_equal_jax(grid, dtype):
    """plan_cells, neighbor_cell_table (deduplicated on the 2^3 grid),
    exclusion_table and build_cell_list equal the JAX package's bit for
    bit; the binning runs in the working dtype."""
    n_mol, box_L, seed, r_cut = GRIDS[grid]
    js, ts = scene(n_mol=n_mol, box_L=box_L, seed=seed, jitter=0.05)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    for skin, cap in ((0.0, 11), (0.5, None)):
        cfg = tn.plan_cells(ts.box_L.numpy(), r_cut, skin=skin, n=ts.N,
                            cap=cap)
        assert cfg == jn.plan_cells(np.asarray(js.box_L), r_cut, skin=skin,
                                    n=js.N, cap=cap)
    table = tn.neighbor_cell_table(cfg.ncells)
    np.testing.assert_array_equal(table, jn.neighbor_cell_table(cfg.ncells))
    C = cfg.total_cells
    if min(cfg.ncells) < 3:
        assert (table == C).any()  # repeats point at the empty cell
    for row in table:
        real = row[row < C]
        assert len(np.unique(real)) == len(real)
    np.testing.assert_array_equal(
        tn.exclusion_table(ts.N, ts.bond_group),
        jn.exclusion_table(js.N, js.bond_group))
    tl = tn.build_cell_list(ts.position.to(dtype), ts.box_L.to(dtype), cfg,
                            torch.as_tensor(table))
    jl = jn.build_cell_list(js.position.astype(jdt), js.box_L.astype(jdt),
                            cfg, table)
    _same_list(tl, jl)
    assert not bool(tl.overflow)
    ids = tl.bucket_idx.numpy().ravel()
    assert sorted(ids[ids < ts.N]) == list(range(ts.N))


def test_overflow_build_equals_jax():
    """50 particles crammed into one cell of cap 8: the flag is set, slot
    cap - 1 holds the cell's last particle as in the JAX package, and
    every displaced particle maps to the dump slot."""
    pos = np.random.default_rng(0).uniform(-1, 1, (50, 3))
    box = np.full(3, 40.0)
    cfg = tn.plan_cells(box, 10.0, skin=0.0, cap=8)
    table = tn.neighbor_cell_table(cfg.ncells)
    tl = tn.build_cell_list(torch.as_tensor(pos), torch.as_tensor(box), cfg,
                            torch.as_tensor(table))
    _same_list(tl, jn.build_cell_list(jnp.asarray(pos), jnp.asarray(box),
                                      cfg, table))
    assert bool(tl.overflow)
    flat = tl.bucket_idx.numpy().ravel()
    slot_of = tl.slot_of.numpy()
    owners = slot_of != flat.size
    assert (flat[slot_of[owners]] == np.nonzero(owners)[0]).all()
    assert owners.sum() == (flat < 50).sum()


def _cell_build(r_cut=10.0, skin=0.5, seed=11):
    """tests/test_neighbor.py:179's scene in both packages (40 diatomics
    + photon, 36-bohr box, 3^3 cells), the photon with a thermal
    velocity."""
    js, ts = scene(n_mol=40, box_L=36.0, seed=seed, jitter=0.0)
    v = np.asarray(js.velocity).copy()
    v[-1] = np.random.default_rng(seed + 2).normal(0.0, np.sqrt(KT), size=3)
    js = js.replace(velocity=jnp.asarray(v))
    ts = ts.replace(velocity=torch.as_tensor(v))
    jff = JForceField.create(js, coupling=1e-3, pair_mode="cell", r_cut=r_cut,
                             pppm_mesh=(8, 8, 8), cell_skin=skin)
    return js, ts, jff


@pytest.mark.parametrize("methods,tol", [("nve", 1e-10),
                                         ("bussi_langevin", 1e-9)])
def test_cell_trajectory_matches_jax(methods, tol):
    """20 f64 steps with the carried cell list against the JAX package's
    run_steps: NVE to 1e-10 of the scale; Bussi + Langevin with the JAX
    draws injected to 1e-9, as tests/test_torch_integrate.py holds the
    dense path."""
    js, ts, jff = _cell_build()
    if methods == "nve":
        jspec = (JMethodSpec(kind="nve", group="all"),)
        tspec = (MethodSpec(kind="nve", group="all"),)
    else:
        jspec = (JMethodSpec(kind="bussi", group="molecular", kT=KT, tau=TAU),
                 JMethodSpec(kind="langevin", group="cavity", kT=KT,
                             gamma=GAMMA))
        tspec = (MethodSpec(kind="bussi", group="molecular", kT=KT, tau=TAU),
                 MethodSpec(kind="langevin", group="cavity", kT=KT,
                            gamma=GAMMA))
    jm = j_resolve_methods(js, jspec, jff.l_typeid)
    jstate = j_init_state(js, jff, dt=DT, seed=3)
    assert jstate.cell_list is not None
    jfinal, jobs = jax.jit(
        lambda s: j_run_steps(j_make_step_fn(jff, jm), s, 20))(jstate)

    tff = port_cell_forcefield(jff, js)
    tstate = state_from_numpy(
        **{k: np.asarray(getattr(jstate, k)) for k in (
            "position", "image", "velocity", "mass", "charge", "typeid",
            "box_L", "forces", "dt", "time_au", "time_comp", "timestep",
            "bussi_reservoir", "bussi_instantaneous", "langevin_reservoir")},
        seed=3, forcefield=tff, device="cpu")
    _same_list(tstate.cell_list, jstate.cell_list)
    noise = None if methods == "nve" else JaxNoise(jstate.key)
    step = make_step_fn(tff, resolve_methods(ts, tspec, tff.l_typeid),
                        noise=noise)
    tfinal, tobs = run_steps(step, tstate, 20)

    for name in ("position", "velocity"):
        j = np.asarray(getattr(jfinal, name))
        np.testing.assert_allclose(getattr(tfinal, name).numpy(), j, rtol=0,
                                   atol=tol * np.abs(j).max())
    np.testing.assert_array_equal(tfinal.image.numpy(),
                                  np.asarray(jfinal.image))
    _same_list(tfinal.cell_list, jfinal.cell_list)
    for k in OBS_KEYS + ("cell_overflow",):
        j = np.asarray(jobs[k], dtype=np.float64)
        np.testing.assert_allclose(tobs[k], j, rtol=0,
                                   atol=tol * max(np.abs(j).max(), 1e-12),
                                   err_msg=k)


def test_carried_list_matches_rebuild_every_step():
    """The skin changes when the buckets are rebuilt, never which pairs
    interact (tests/test_neighbor.py:179): 60 Bussi + Langevin steps with
    a 0.1-bohr skin, which rebuilds along the way, against skin 0
    (rebuilt every step), same seed, to 1e-12."""
    _, ts, _ = _cell_build()
    finals = []
    for skin in (0.0, 0.1):
        ff = ForceField.create(ts, coupling=1e-3, pair_mode="cell",
                               r_cut=11.9, pppm_mesh=(8, 8, 8),
                               cell_skin=skin)
        methods = resolve_methods(ts, (
            MethodSpec(kind="bussi", group="molecular", kT=KT, tau=TAU),
            MethodSpec(kind="langevin", group="cavity", kT=KT, gamma=GAMMA),
        ), ff.l_typeid)
        state = init_state(ts, ff, dt=PC.fs_to_atomic_units(0.5), seed=5)
        assert (state.cell_list is not None) == (skin > 0)
        final, obs = run_steps(make_step_fn(ff, methods), state, 60)
        assert not obs["cell_overflow"].any()
        finals.append(final)
    assert not torch.equal(finals[1].cell_anchor, ts.position), \
        "the carried list was never rebuilt"
    np.testing.assert_allclose(finals[1].position.numpy(),
                               finals[0].position.numpy(), rtol=0,
                               atol=1e-12)


class _Keep:
    """A tracker that keeps every chunk's observables."""

    def __init__(self):
        self.chunks = []

    def consume(self, obs):
        self.chunks.append(obs)


def test_overflow_retry_matches_a_run_that_never_overflowed():
    """Simulation.run with a bucket cap of 2 overflows, grows the cap
    (2 -> 6 -> 12) and runs the chunk again from its start, random streams
    restored: positions, velocities, every observable and the generator
    states equal a run that started at cap 12, to 1e-12."""
    _, ts, _ = _cell_build()
    spec = (MethodSpec(kind="bussi", group="molecular", kT=KT, tau=TAU),
            MethodSpec(kind="langevin", group="cavity", kT=KT, gamma=GAMMA))
    sims = []
    for cap in (2, 12):
        ff = ForceField.create(ts, coupling=1e-3, pair_mode="cell",
                               r_cut=10.0, pppm_mesh=(8, 8, 8),
                               cell_cap=cap)
        sim = Simulation(ts, ff, spec, dt=DT, seed=4, chunk_size=15)
        keep = _Keep()
        sim.trackers.append(keep)
        sim.run(n_steps=30)
        sims.append((sim, keep.chunks))
    (small, obs_s), (large, obs_l) = sims
    assert small.ff.cell_cfg.cap == 12 and large.ff.cell_cfg.cap == 12
    assert len(obs_s) == len(obs_l) == 2
    for name in ("position", "velocity", "forces"):
        np.testing.assert_allclose(getattr(small.state, name).numpy(),
                                   getattr(large.state, name).numpy(),
                                   rtol=0, atol=1e-12)
    for a, b in zip(obs_s, obs_l):
        assert not b["cell_overflow"].any() and not a["cell_overflow"].any()
        for k in OBS_KEYS:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-12,
                                       err_msg=k)
    gens_s, gens_l = small.state.generators, large.state.generators
    assert set(gens_s) == set(gens_l)
    for key in gens_s:
        assert torch.equal(gens_s[key].get_state(), gens_l[key].get_state())


def test_build_large_n_runs_small():
    """The large-N builder at 100 molecules (N = 201, 2^3 cells): 50 f32
    steps through Simulation.run with no overflow, universe energy within
    the f32 band of tests/test_driver.py:322."""
    from cavmd_tpu_torch.drivers.workloads import build_large_n

    sim, snap, ff = build_large_n(100, device="cpu")
    assert snap.N == 201 and ff.pair_mode == "cell"
    assert ff.cell_cfg.ncells == (2, 2, 2)
    assert sim.run(n_steps=50) == 50
    obs = sim.last_obs
    assert not obs["cell_overflow"].any()
    assert sim.state.time_au.dtype == torch.float32
    assert float(sim.state.time_au) > 0
    eu = universe_energy(obs)
    assert eu.shape == (50,) and np.ptp(eu) < 5e-3
