"""Atom sharding by rows (``cavmd_tpu_torch/parallel/shard.py``, the
counterpart of the JAX package's GSPMD fallback), its mesh and ghost
padding (``parallel/mesh.py``), float64 on the CPU:

- the row path against JAX's own ``make_sharded_runner`` on the 8-device
  CPU mesh, on the scenes and tolerances of tests/test_parallel.py: 25 ->
  32 atoms in dense mode over 1 x 8 ranks, 20 steps; the 2 x 4 replica
  mesh, 10 steps; cell mode at 60 diatomics over 1 x 8 ranks, 10 steps;
  each to 1e-10, the port drawing JAX's noise from a table, over 8 gloo
  ranks (``parallel/launch.py:run_ranks``); and the port's zcol mode on
  the cell scene over 1 x 8 ranks, held to JAX's cell-mode run (JAX's
  float64 zcol pass runs in float32, ROADMAP.md Queue 3);
- on 2 of those ranks, molecular Langevin, a Brownian photon and a custom
  force through ``Simulation(shard_atoms=2)``, draw for draw the
  unsharded run;
- the row step's S blocks in one process (S thread ranks,
  tests/thread_ranks.py) against the unsharded port step to 1e-12;
- the JAX ghost tests (tests/test_parallel.py) and ``pad_snapshot_to``,
  ``Snapshot.strip_tail``, ``Simulation.get_snapshot(strip_ghosts=)``,
  ``group_mask(ghost_typeid=)`` and ``state_shardings`` against JAX's
  outputs; a padded f64 run against the unpadded one;
- ``Simulation(shard_atoms=1)`` with a custom force (the slab path
  refuses it) runs unsharded, as the JAX facade's does.

The spawned ranks run functions of this module, which imports JAX only
inside its fixtures and tests: JAX's draws reach them as a table.
"""

import numpy as np
import pytest
import torch

import cavmd_tpu_torch as pt
from cavmd_tpu_torch.core import PhysicalConstants as PC
from cavmd_tpu_torch.integrate import make_step_fn
from cavmd_tpu_torch.integrate.integrator import group_mask
from cavmd_tpu_torch.interop import state_from_numpy
from cavmd_tpu_torch.parallel import (
    Communicator,
    make_mesh,
    make_sharded_runner,
    pad_snapshot_to,
    shard_state,
    state_shardings,
)
from cavmd_tpu_torch.parallel.launch import run_ranks
from thread_ranks import run_threads

KT = PC.kT_from_kelvin(100.0)
TAU = PC.ps_to_atomic_units(5.0)
GAMMA = PC.gamma_from_tau_ps(5.0)
DT = PC.fs_to_atomic_units(0.5)
LEAVES = ("position", "image", "velocity", "mass", "charge", "typeid",
          "box_L", "forces", "dt", "time_au", "time_comp", "timestep",
          "bussi_reservoir", "bussi_instantaneous", "langevin_reservoir",
          "error_tolerance")
# tests/test_parallel.py's scenes: (molecules, box, seeds, force field)
SCENES = {
    "dense": (12, 20.0, (51, 52), dict(pppm_mesh=(16, 16, 16), r_cut=9.0)),
    "batch": (12, 20.0, (51, 52), dict(pppm_mesh=(16, 16, 16), r_cut=9.0)),
    "cell": (60, 48.0, (61, 62), dict(pair_mode="cell", r_cut=12.0,
                                      pppm_mesh=(16, 16, 16))),
}
# the port's zcol row path on the cell scene; its reference is JAX's
# cell-mode run (JAX_REF), with no JAX run of its own
SCENES["zcol"] = SCENES["cell"][:3] + (dict(SCENES["cell"][3],
                                            pair_mode="zcol"),)
JAX_REF = {"zcol": "cell"}
STEPS = {"dense": 20, "batch": 10, "cell": 10, "zcol": 10}
MESHES = {"dense": (1, 8), "batch": (2, 4), "cell": (1, 8), "zcol": (1, 8)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: its tensors are small, and the
    suite runs six workers on the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _scene(kind):
    """The port's copy of a tests/test_parallel.py scene, ghost-padded to
    a multiple of 8: (snapshot, force field, Bussi + Langevin methods)."""
    n_mol, box, (s1, s2), kw = SCENES[kind]
    snap = pt.add_cavity_particle(pt.make_diatomic_system(
        n_mol, box_L=box, temperature_K=100.0, seed=s1, dtype=torch.float64,
        device="cpu"), coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0,
        seed=s2)
    snap, _ = pad_snapshot_to(snap, 8)
    ff = pt.ForceField.create(snap, coupling=1e-3, **kw)
    methods = pt.resolve_methods(snap, (
        pt.MethodSpec("bussi", "molecular", kT=KT, tau=TAU),
        pt.MethodSpec("langevin", "cavity", kT=KT, gamma=GAMMA)),
        ff.l_typeid)
    return snap, ff, methods


class TableDraws:
    """JAX's draws at each host step from a table made in the test process
    (``table["bussi"]``: (steps, B, 2), ``table["langevin"]``: (steps, B,
    1, 3)), rows ``rows`` of a batch (None: one replica, row 0 squeezed),
    so that the spawned ranks need no JAX."""

    def __init__(self, table, rows=None):
        self.table, self.rows = table, rows

    def _t(self, x, state):
        x = x[state.step]
        x = x[0] if self.rows is None else x[self.rows]
        return torch.tensor(x, dtype=state.position.dtype)

    def bussi(self, state, i, m):
        b = self._t(self.table["bussi"], state)
        return b[..., 0], b[..., 1]

    def langevin(self, state, i, m, shape):
        return self._t(self.table["langevin"], state).reshape(shape)


def _rows_job(kind, start, table):
    """A run_ranks job on 8 ranks: ``kind``'s scene from JAX's start
    leaves through ``make_sharded_runner`` on its mesh, drawing JAX's
    noise. Returns NumPy: the rank's final positions, its replica rows
    and the cavity coupling energy (steps, ...)."""
    import torch.distributed as dist

    R, S = MESHES[kind]
    batched = kind == "batch"
    snap, ff, methods = _scene(kind)
    state = state_from_numpy(**start, forcefield=ff, device="cpu")
    rows = None
    if batched:
        r = dist.get_rank() // S
        B = start["position"].shape[0]
        rows = slice(r * B // R, (r + 1) * B // R)
    mesh = make_mesh(R, S)
    step = make_step_fn(ff, methods, noise=TableDraws(table, rows))
    run = make_sharded_runner(step, mesh, state, batched=batched)
    final, obs = run(shard_state(state, mesh, batched=batched),
                     STEPS[kind])
    return dict(position=final.position.numpy(),
                rows=None if rows is None else (rows.start, rows.stop),
                cavity_coupling=obs["cavity_coupling"])


def custom_pull(position, image, box_L, charge, typeid):
    """A harmonic pull of every row towards a tenth of the box."""
    d = position - 0.1 * box_L
    return -1e-4 * d, 0.5e-4 * torch.sum(d * d)


def _langevin_custom_run(comm=None):
    """The 25 -> 26-row dense scene with molecular Langevin (tau 0.5 ps),
    a Brownian photon and ``custom_pull``, thermalized at seed 3, 12 steps
    in chunks of 5: over ``comm``'s 2 ranks, or unsharded without one.
    Returns NumPy: final positions, velocities, every observable."""
    snap = pt.add_cavity_particle(pt.make_diatomic_system(
        12, box_L=20.0, temperature_K=100.0, seed=51, dtype=torch.float64,
        device="cpu"), coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0,
        seed=52)
    snap, _ = pad_snapshot_to(snap, 2)
    ff = pt.ForceField.create(snap, coupling=1e-3, pppm_mesh=(16, 16, 16),
                              r_cut=9.0, custom_forces=(custom_pull,))
    methods = (pt.MethodSpec("langevin", "molecular", kT=KT,
                             gamma=PC.gamma_from_tau_ps(0.5)),
               pt.MethodSpec("brownian", "cavity", kT=KT,
                             gamma=PC.gamma_from_tau_ps(0.001)))
    sim = pt.Simulation(snap, ff, methods, dt=DT, seed=3, chunk_size=5,
                        shard_atoms=0 if comm is None else 2, comm=comm)
    sim.thermalize(KT)
    chunks = []

    class Keep:
        def consume(self, obs):
            chunks.append(obs)

    sim.trackers.append(Keep())
    sim.run(n_steps=12)
    return dict(position=sim.state.position.numpy(),
                velocity=sim.state.velocity.numpy(),
                routed=sim.ff.row_comm is comm and sim._domain_plan is None,
                obs={k: np.concatenate([c[k] for c in chunks])
                     for k in chunks[0]})


def _pair_of_ranks_job():
    """On ranks 0 and 1 of the world (a gloo subgroup that every rank
    makes): ``_langevin_custom_run`` over them; None elsewhere."""
    import torch.distributed as dist

    group = dist.new_group([0, 1])
    rank = dist.get_rank()
    if rank > 1:
        return None
    return _langevin_custom_run(Communicator(rank, 2, group))


# ------------------------------------------------------------- JAX side
def _jax_world(kind):
    """tests/test_parallel.py's sharded run of ``kind`` in the JAX
    package: the start leaves, each step's draws, and JAX's
    ``make_sharded_runner`` result on its 8-device mesh."""
    import jax
    import jax.numpy as jnp

    from cavmd_tpu.core import add_cavity_particle, make_diatomic_system
    from cavmd_tpu.integrate import (
        ForceField,
        MethodSpec,
        init_state,
        make_step_fn,
        resolve_methods,
    )
    from cavmd_tpu.integrate.rng import (
        STREAM_BUSSI,
        STREAM_LANGEVIN,
        stream_key,
    )
    from cavmd_tpu.integrate.thermostats import bussi_noise
    from cavmd_tpu.parallel import (
        init_replica_states,
        make_mesh as j_make_mesh,
        make_sharded_runner as j_runner,
        pad_snapshot_to as j_pad,
        shard_state as j_shard_state,
    )
    from cavmd_tpu.parallel.replicas import make_replica_step

    n_mol, box, (s1, s2), kw = SCENES[kind]
    snap = add_cavity_particle(make_diatomic_system(
        n_mol, box_L=box, temperature_K=100.0, seed=s1),
        coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=s2)
    snap, _ = j_pad(snap, 8)
    ff = ForceField.create(snap, coupling=1e-3, **kw)
    methods = resolve_methods(snap, (
        MethodSpec(kind="bussi", group="molecular", kT=KT, tau=TAU),
        MethodSpec(kind="langevin", group="cavity", kT=KT, gamma=GAMMA)),
        ff.l_typeid)
    step = make_step_fn(ff, methods)
    batched = kind == "batch"
    if batched:
        state = init_replica_states(snap, ff, n_replicas=2, dt=DT, seed=3,
                                    kT=KT)
        step = make_replica_step(step)
        keys = state.key
    else:
        state = init_state(snap, ff, dt=DT, seed=9 if kind == "dense" else 3)
        keys = state.key[None]
    mesh = j_make_mesh(n_replica=MESHES[kind][0],
                       n_atoms_shards=MESHES[kind][1])

    def sharded_run():
        final, obs = j_runner(step, mesh, state, batched=batched)(
            j_shard_state(state, mesh, batched=batched), STEPS[kind])
        return dict(position=np.asarray(final.position),
                    cavity_coupling=np.asarray(obs["cavity_coupling"]))

    dof = float(methods[0].dof)

    @jax.jit
    def draws(keys, t):
        def one(key):
            r1, rg = bussi_noise(stream_key(key, STREAM_BUSSI, t, 0), dof,
                                 jnp.float64)
            return jnp.stack([r1, rg]), jax.random.normal(
                stream_key(key, STREAM_LANGEVIN, t, 1), (1, 3),
                dtype=jnp.float64)
        return jax.vmap(one)(keys)

    per_step = [draws(keys, t) for t in range(STEPS[kind])]
    table = {"bussi": np.stack([np.asarray(b) for b, _ in per_step]),
             "langevin": np.stack([np.asarray(g) for _, g in per_step])}
    return dict(start={k: np.asarray(getattr(state, k)) for k in LEAVES},
                table=table), sharded_run


@pytest.fixture(scope="module")
def worlds():
    """JAX's three sharded runs, the port's row path on each (and in zcol
    mode on the cell scene) and the 2-rank Langevin/custom-force run:
    JAX's set up and run in threads, the port's in one spawn of 8 gloo
    ranks while JAX compiles its own."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(4) as pool:
        preps = {kind: pool.submit(_jax_world, kind) for kind in SCENES
                 if kind not in JAX_REF}
        jax_runs = {kind: f.result()[0] for kind, f in preps.items()}
        sharded = {kind: pool.submit(f.result()[1])
                   for kind, f in preps.items()}
        refs = {kind: JAX_REF.get(kind, kind) for kind in SCENES}
        jobs = [(_rows_job, (kind, jax_runs[refs[kind]]["start"],
                             jax_runs[refs[kind]]["table"]))
                for kind in SCENES]
        results = run_ranks(jobs + [(_pair_of_ranks_job, ())], 8, 400)
        for kind, f in sharded.items():
            jax_runs[kind].update(f.result())
    for kind, ref in JAX_REF.items():
        jax_runs[kind] = jax_runs[ref]
    port = dict(zip(SCENES, results))
    return jax_runs, port, results[-1]


@pytest.mark.parametrize("kind", list(SCENES))
def test_row_path_matches_jax_sharded_runner(worlds, kind):
    """Every rank's final positions within 1e-10 (relative and absolute)
    of JAX's ``make_sharded_runner`` (its replica rows on the 2 x 4
    mesh; in zcol mode its cell-mode run), and the cavity coupling energy
    within 1e-8 (tests/test_parallel.py's tolerances); the ranks of a
    replica agree bit for bit."""
    jax_runs, port, _ = worlds
    want = jax_runs[kind]
    for got in port[kind]:
        pos, cc = want["position"], want["cavity_coupling"]
        if got["rows"] is not None:
            lo, hi = got["rows"]
            pos, cc = pos[lo:hi], cc[:, lo:hi]
        np.testing.assert_allclose(got["position"], pos, rtol=1e-10,
                                   atol=1e-10)
        np.testing.assert_allclose(got["cavity_coupling"], cc, rtol=1e-8,
                                   atol=1e-12)
    firsts = {}
    for got in port[kind]:
        key = got["rows"]
        if key in firsts:
            assert np.array_equal(got["position"], firsts[key])
        firsts.setdefault(key, got["position"])
    assert not np.allclose(want["position"], want["start"]["position"])


def test_two_ranks_langevin_brownian_custom_force_draw_for_draw(worlds):
    """``Simulation(shard_atoms=2)`` on 2 gloo ranks (dense mode: the row
    path) with molecular Langevin, a Brownian photon and a custom force:
    the same draws as the unsharded run, so positions, velocities and
    every observable within 1e-10 of it, on both ranks."""
    _, _, pair = worlds
    ref = _langevin_custom_run()
    assert pair[2:] == [None] * 6
    for got in pair[:2]:
        assert got["routed"]
        for key in ("position", "velocity"):
            np.testing.assert_allclose(got[key], ref[key], rtol=0,
                                       atol=1e-10 * np.abs(ref[key]).max())
        assert sorted(got["obs"]) == sorted(ref["obs"])
        for k, want in ref["obs"].items():
            np.testing.assert_allclose(
                got["obs"][k], want, rtol=1e-10,
                atol=1e-10 * max(np.abs(want).max(), 1e-30), err_msg=k)
    assert np.abs(ref["obs"]["langevin_reservoir_molecular"]).max() > 0
    assert np.abs(ref["obs"]["custom_0"]).max() > 0


# ------------------------------------------------- S blocks, one process
@pytest.mark.parametrize("kind, S", [("dense", 2), ("dense", 4),
                                     ("cell", 2), ("cell", 8),
                                     ("zcol", 2), ("zcol", 4)])
def test_row_blocks_in_one_process_match_the_unsharded_step(kind, S):
    """The force field bound to rows on S thread ranks, and one step of
    each rank's row-split step: the forces, every energy and the stepped
    state within 1e-12 of the unsharded port's, the same bits on every
    rank."""
    snap, ff, methods = _scene(kind)
    state = pt.init_state(snap, ff, dt=DT, seed=3)
    args = (snap.position, snap.image, snap.box_L, snap.charge, snap.typeid)
    f0, e0 = ff(*args)
    ref, ref_obs = make_step_fn(ff, methods)(state.replace(generators={}))

    def rank(comm):
        bound = ff.bind_rows(comm)
        f, e = bound(*args)
        st, obs = make_step_fn(bound, methods)(state.replace(generators={}))
        return f, e, st, obs

    ranks = run_threads(S, rank)
    scale = f0.abs().max()
    for f, e, st, obs in ranks:
        assert torch.equal(f, ranks[0][0])
        assert (f - f0).abs().max() <= 1e-12 * scale
        assert sorted(e) == sorted(e0)
        for k in e0:
            assert abs(float(e[k] - e0[k])) <= 1e-12 * max(
                abs(float(e0[k])), 1.0), k
        for k in ("position", "velocity", "forces"):
            a, b = getattr(st, k), getattr(ref, k)
            assert (a - b).abs().max() <= 1e-12 * b.abs().max(), k
        for k in ref_obs:
            assert abs(float(obs[k] - ref_obs[k])) <= 1e-12 * max(
                abs(float(ref_obs[k])), 1.0), k


def test_row_split_refuses_an_indivisible_n():
    snap = pt.add_cavity_particle(pt.make_diatomic_system(
        300, box_L=60.0, temperature_K=100.0, seed=2, dtype=torch.float64,
        device="cpu"), coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0,
        seed=3)
    _, ff, _ = _scene("dense")
    bound = ff.bind_rows(Communicator(0, 5))  # 32 rows
    with pytest.raises(ValueError, match="pad the snapshot first"):
        bound(snap.position[:32], snap.image[:32], snap.box_L,
              snap.charge[:32], snap.typeid[:32])
    assert bound.bind_rows(None).row_comm is None
    assert bound.lj_eps is ff.lj_eps  # buffers shared, not copied


# ---------------------------------------------------------------- ghosts
@pytest.fixture(scope="module")
def jax_ghost_scene():
    """tests/test_parallel.py:test_ghost_padding_excluded_from_groups's
    scene (10 diatomics + photon, 21 -> 24 rows) in both packages."""
    from cavmd_tpu.core import add_cavity_particle, make_diatomic_system
    from cavmd_tpu.integrate import ForceField
    from cavmd_tpu.parallel import pad_snapshot_to as j_pad

    js, jpad = j_pad(add_cavity_particle(
        make_diatomic_system(10, box_L=20.0, seed=71), coupling=1e-3,
        freq_cm1=2000.0, temperature_K=100.0, seed=72), 8)
    ts, tpad = pad_snapshot_to(pt.add_cavity_particle(
        pt.make_diatomic_system(10, box_L=20.0, seed=71, device="cpu"),
        coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=72), 8)
    assert jpad == tpad == 3
    kw = dict(coupling=1e-3, pppm_mesh=(8, 8, 8), r_cut=8.0)
    return js, ts, ForceField.create(js, **kw), pt.ForceField.create(ts,
                                                                    **kw)


@pytest.mark.parametrize("multiple", [8, 3, 1])
def test_pad_snapshot_to_matches_jax(multiple):
    """Every particle field, the types and the pad count equal JAX's
    ``pad_snapshot_to`` (ghost type '__ghost__', mass 1e30, zero charge,
    on the box diagonal)."""
    from cavmd_tpu.core import add_cavity_particle, make_diatomic_system
    from cavmd_tpu.parallel import pad_snapshot_to as j_pad

    js, jn = j_pad(add_cavity_particle(
        make_diatomic_system(10, box_L=20.0, seed=71), coupling=1e-3,
        freq_cm1=2000.0, temperature_K=100.0, seed=72), multiple)
    ts, tn = pad_snapshot_to(pt.add_cavity_particle(
        pt.make_diatomic_system(10, box_L=20.0, seed=71, device="cpu"),
        coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=72),
        multiple)
    assert tn == jn and ts.types == js.types and ts.N == js.N
    for k in ("position", "image", "velocity", "mass", "charge",
              "diameter", "typeid"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), k)


def test_pad_snapshot_to_refuses_a_padded_snapshot(jax_ghost_scene):
    """A snapshot that holds ghosts and needs more raises (a second block
    would be a ghost type of its own, taken for real rows); one that
    needs none comes back as it is."""
    ts = jax_ghost_scene[1]  # 24 rows, 3 of them ghosts
    assert pad_snapshot_to(ts, 8) == (ts, 0)
    with pytest.raises(ValueError, match="ghost-padded already"):
        pad_snapshot_to(ts, 16)


def test_ghost_padding_inert(jax_ghost_scene):
    """tests/test_parallel.py:test_ghost_padding_inert on the port: the
    ghosts feel no force (exactly zero), in dense and cell mode, and the
    force field finds their type where JAX's does."""
    js, ts, jff, tff = jax_ghost_scene
    ghost = ts.typeid.numpy() == len(ts.types) - 1
    assert ghost.sum() == 3 and tff.ghost_typeid == jff.ghost_typeid == 3
    cell = pt.ForceField.create(ts, coupling=1e-3, pppm_mesh=(8, 8, 8),
                                r_cut=6.0, pair_mode="cell")
    for ff in (tff, cell):
        ft, _ = ff(ts.position, ts.image, ts.box_L, ts.charge, ts.typeid)
        assert np.all(ft.numpy()[ghost] == 0.0)
        assert np.abs(ft.numpy()[~ghost]).max() > 0
        assert bool(ff.pair_inert[ghost].all()) if ff is cell else True


def test_ghost_padding_excluded_from_groups(jax_ghost_scene):
    """tests/test_parallel.py's regression on the port: the ghosts count
    toward no thermostat DOF (3 x 20) and no group mask (20 molecular,
    21 in 'all')."""
    js, ts, jff, tff = jax_ghost_scene
    methods = pt.resolve_methods(
        ts, (pt.MethodSpec("bussi", "molecular", kT=1e-4, tau=1.0),),
        tff.l_typeid)
    assert methods[0].dof == 3.0 * 20
    mask = group_mask(ts.typeid, tff.l_typeid, "molecular",
                      tff.ghost_typeid)
    assert int(mask.sum()) == 20
    mask_all = group_mask(ts.typeid, tff.l_typeid, "all", tff.ghost_typeid)
    assert int(mask_all.sum()) == 21


@pytest.mark.parametrize("group", ["molecular", "cavity", "all"])
def test_group_mask_matches_jax(jax_ghost_scene, group):
    from cavmd_tpu.integrate.integrator import group_mask as j_group_mask

    js, ts, jff, tff = jax_ghost_scene
    for gid in (-1, tff.ghost_typeid):
        np.testing.assert_array_equal(
            group_mask(ts.typeid, tff.l_typeid, group, gid).numpy(),
            np.asarray(j_group_mask(js.typeid, jff.l_typeid, group, gid)))


def test_strip_tail_matches_jax(jax_ghost_scene):
    js, ts, _, _ = jax_ghost_scene
    for n in (21, 24, 30):
        a, b = ts.strip_tail(n), js.strip_tail(n)
        assert a.types == b.types and a.N == b.N
        for k in ("position", "velocity", "mass", "typeid", "diameter"):
            np.testing.assert_array_equal(getattr(a, k).numpy(),
                                          np.asarray(getattr(b, k)))
    assert ts.strip_tail(24) is ts


@pytest.mark.parametrize("strip", [True, False])
def test_get_snapshot_strip_ghosts_matches_jax(jax_ghost_scene, strip):
    """``Simulation.get_snapshot(strip_ghosts=)`` of a fresh padded
    Simulation in both packages (NVE): the same rows and types."""
    from cavmd_tpu.integrate import MethodSpec as JMethodSpec
    from cavmd_tpu.simulation import Simulation as JSimulation

    js, ts, jff, tff = jax_ghost_scene
    j = JSimulation(js, jff, (JMethodSpec(kind="nve", group="all"),),
                    dt=DT).get_snapshot(strip_ghosts=strip)
    t = pt.Simulation(ts, tff, (pt.MethodSpec("nve", "all"),),
                      dt=DT).get_snapshot(strip_ghosts=strip)
    assert t.N == j.N == (21 if strip else 24) and t.types == j.types
    np.testing.assert_array_equal(t.position.numpy(), np.asarray(j.position))
    np.testing.assert_array_equal(t.typeid.numpy(), np.asarray(j.typeid))


@pytest.mark.parametrize("batched", [False, True])
def test_state_shardings_match_jax(jax_ghost_scene, batched):
    """The partition spec of every field both states have equals the
    PartitionSpec of JAX's ``state_shardings``, axis for axis (a JAX
    batch stacks the topology B times, where the port's shares it: there
    the port's spec is JAX's without its 'replica' axis)."""
    from cavmd_tpu_torch.parallel.replicas import PER_REPLICA

    import jax

    from cavmd_tpu.integrate import init_state as j_init_state
    from cavmd_tpu.parallel import init_replica_states as j_replicas
    from cavmd_tpu.parallel import make_mesh as j_make_mesh
    from cavmd_tpu.parallel import state_shardings as j_shardings

    js, ts, jff, tff = jax_ghost_scene
    if batched:
        jstate = j_replicas(js, jff, n_replicas=2, dt=DT, seed=1, kT=KT)
        tstate = pt.parallel.init_replica_states(ts, tff, n_replicas=2,
                                                 dt=DT, seed=1, kT=KT)
    else:
        jstate = j_init_state(js, jff, dt=DT)
        tstate = pt.init_state(ts, tff, dt=DT)
    jspec = {path[-1].name: tuple(s.spec) for path, s in
             jax.tree_util.tree_flatten_with_path(j_shardings(
                 j_make_mesh(n_replica=2 if batched else 1,
                             n_atoms_shards=4), jstate,
                 batched=batched))[0]}
    tspec = state_shardings(make_mesh(), tstate, batched=batched)
    shared = [k for k in tspec if k in jspec]
    assert {"position", "velocity", "mass", "typeid", "dt"} <= set(shared)
    for k in shared:
        want = jspec[k]
        if batched and k not in PER_REPLICA:
            assert want[0] == "replica", k
            want = want[1:]
        want = want + (None,) * (len(tspec[k]) - len(want))
        assert tspec[k] == want, k


def test_padded_run_follows_the_unpadded_one():
    """In float64, a Simulation of the ghost-padded scene (Bussi + photon
    Langevin, thermalized) follows the unpadded one to 1e-10 over 20
    steps: the ghosts stay at rest, take no draw and exert no force."""
    snap = pt.add_cavity_particle(pt.make_diatomic_system(
        20, box_L=16.0, temperature_K=100.0, seed=5, dtype=torch.float64,
        device="cpu"), coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0,
        seed=6)
    methods = (pt.MethodSpec("bussi", "molecular", kT=KT, tau=TAU),
               pt.MethodSpec("langevin", "cavity", kT=KT, gamma=GAMMA))
    runs = []
    for s in (snap, pad_snapshot_to(snap, 8)[0]):
        sim = pt.Simulation(s, pt.ForceField.create(s), methods, dt=DT,
                            seed=3)
        sim.thermalize(KT)
        sim.run(n_steps=20)
        runs.append(sim)
    a, b = (r.state for r in runs)
    n = snap.N
    assert b.position.shape[0] == 48
    for k in ("position", "velocity"):
        np.testing.assert_allclose(getattr(b, k)[:n].numpy(),
                                   getattr(a, k).numpy(), rtol=0,
                                   atol=1e-10)
    assert torch.all(b.velocity[n:] == 0)
    for k, want in runs[0].last_obs.items():
        np.testing.assert_allclose(runs[1].last_obs[k], want, rtol=1e-10,
                                   atol=1e-12, err_msg=k)
    assert runs[1].get_snapshot().N == n


def test_shard_atoms_1_with_a_custom_force_matches_jax():
    """Custom forces: the slab path refuses them, and
    ``Simulation(shard_atoms=1)`` runs unsharded in both packages; 20 NVE
    steps of the tests/test_torch_ops.py scene with a harmonic pull agree
    to 1e-10."""
    import jax.numpy as jnp

    from cavmd_tpu.integrate import MethodSpec as JMethodSpec
    from cavmd_tpu.simulation import Simulation as JSimulation
    from test_torch_ops import scene

    def j_pull(position, image, box_L, charge, typeid):
        d = position - 0.1 * box_L
        return -1e-4 * d, 0.5e-4 * jnp.sum(d * d)

    from cavmd_tpu.integrate import ForceField as JForceField

    js, ts = scene()
    kw = dict(coupling=1e-3, pppm_mesh=(16, 16, 16), r_cut=10.0,
              pair_mode="cell")
    j = JSimulation(js, JForceField.create(js, custom_forces=(j_pull,),
                                           **kw),
                    (JMethodSpec(kind="nve", group="all"),), dt=DT,
                    shard_atoms=1)
    t = pt.Simulation(ts, pt.ForceField.create(
        ts, custom_forces=(custom_pull,), **kw),
        (pt.MethodSpec("nve", "all"),), dt=DT, shard_atoms=1)
    assert t._domain_plan is None and t._comm is None
    j.run(n_steps=20)
    t.run(n_steps=20)
    pos = np.asarray(j.state.position)
    np.testing.assert_allclose(t.state.position.numpy(), pos, rtol=0,
                               atol=1e-10 * np.abs(pos).max())
    assert not np.allclose(pos, np.asarray(js.position))
