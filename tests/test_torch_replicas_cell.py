"""Replica batches in cell and zcol mode (cavmd_tpu_torch, float64, CPU)
against cavmd_tpu.parallel.replicas and against one-replica port runs: the
batched list builds against each replica's own build and ``jax.vmap`` of
the JAX builds, bit for bit (a batch where one replica overflows
included); the batched forces against ``jax.vmap`` of the JAX
``ForceField.compute``; 20 batched steps, each replica's carried list
rebuilt inside the window, against JAX's ``run_replica_steps`` with its
draws injected and against B one-replica port runs with the same draws;
``init_replica_states`` and ``state_from_numpy`` carrying the batched list.

The scene: 58 O2/N2 + photon at the reference density in a 28.2-bohr box,
r_cut 7 with a 0.05-bohr skin (4^3 cells, 4 x 4 columns of cap 128), an
8^3 mesh, B = 3 replicas whose positions carry their own seeded jitter.
The JAX package's zcol pass runs in float32 even in a float64 run
(ROADMAP.md Queue 3), so the port's zcol batch is held to JAX's cell mode.
The JAX references run under one ``jax.jit`` each, in module fixtures."""

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
from cavmd_tpu.ops import neighbor as jn
from cavmd_tpu.parallel import init_replica_states as j_init_replicas
from cavmd_tpu.parallel import run_replica_steps as j_run_replica_steps
from cavmd_tpu_torch.integrate import (
    OBS_KEYS,
    ForceField,
    MethodSpec,
    init_state,
    make_step_fn,
    resolve_methods,
    run_steps,
)
from cavmd_tpu_torch.interop import state_from_numpy
from cavmd_tpu_torch.ops import neighbor as tn
from cavmd_tpu_torch.parallel import init_replica_states, run_replica_steps
from cavmd_tpu_torch.parallel.replicas import PER_REPLICA

from test_torch_cell_kernel import port_cell_forcefield
from test_torch_ops import scene
from test_torch_replicas import ReplicaJaxNoise

B = 3
R_CUT, SKIN = 7.0, 0.05
DT = PC.fs_to_atomic_units(0.5)
KT = PC.kT_from_kelvin(100.0)
TAU = PC.ps_to_atomic_units(5.0)
GAMMA = PC.gamma_from_tau_ps(5.0)
TOL_OP = 1e-10    # forces and energies against jax.vmap of the JAX call
TOL_TRAJ = {"cell": 1e-9, "zcol": 1e-10}  # 20 steps against JAX, of scale
TOL_SELF = 1e-12  # the batch against one-replica port runs
LEAVES = ("position", "image", "velocity", "mass", "charge", "typeid",
          "box_L", "forces", "dt", "time_au", "time_comp", "timestep",
          "bussi_reservoir", "bussi_instantaneous", "langevin_reservoir")


def _close(t, j, tol, what=""):
    j = np.asarray(j, dtype=np.float64)
    t = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
    scale = max(float(np.abs(j).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(t, np.float64), j, rtol=0,
                               atol=tol * scale, err_msg=what)


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
    """The scene in both packages, the JAX cell-mode ForceField and the
    port's cell (from the JAX leaves) and zcol ForceFields, and B jittered
    copies of the positions."""
    js, ts = scene(n_mol=58, box_L=28.2, seed=5, jitter=0.0)
    jff = JForceField.create(js, coupling=1e-3, pair_mode="cell", r_cut=R_CUT,
                             pppm_mesh=(8, 8, 8), cell_skin=SKIN)
    tffs = {"cell": port_cell_forcefield(jff, js),
            "zcol": ForceField.create(ts, coupling=1e-3, pair_mode="zcol",
                                      r_cut=R_CUT, pppm_mesh=(8, 8, 8),
                                      cell_skin=SKIN)}
    assert tffs["cell"].cell_cfg.ncells == (4, 4, 4)
    assert tffs["zcol"].cell_cfg.ncells == (4, 4, 1)
    assert tffs["cell"].cell_cfg.skin < 0.1
    rng = np.random.default_rng(21)
    pos = np.asarray(js.position)[None] + rng.normal(
        scale=0.05, size=(B,) + tuple(js.position.shape))
    snaps = [js.replace(position=jnp.asarray(p)) for p in pos]
    return dict(js=js, ts=ts, jff=jff, tffs=tffs, pos=pos, snaps=snaps)


def _same_list(tl, jl, what=""):
    for k in ("bucket_idx", "slot_of"):
        np.testing.assert_array_equal(getattr(tl, k).numpy(),
                                      np.asarray(getattr(jl, k)),
                                      err_msg=f"{what} {k}")
    np.testing.assert_array_equal(tl.overflow.numpy(),
                                  np.asarray(jl.overflow), err_msg=what)


# ----------------------------------------------------- 1. the list builds
@pytest.mark.parametrize("mode", ["cell", "zcol"])
def test_batched_build_equals_one_replica_builds_and_jax_vmap(world, mode):
    """A batch whose replica 1 has 30 particles crammed into one cell
    (column): its flag alone is set, every replica's fields equal its
    one-replica build bit for bit (overflowed buckets included), and
    bucket_idx, slot_of (and the merged halo) equal ``jax.vmap`` of the
    JAX build."""
    ts = world["ts"]
    pos = world["pos"].copy()
    pos[1, :30] = np.random.default_rng(4).uniform(0.3, 3.0, (30, 3))
    P = torch.as_tensor(pos)
    box = ts.box_L
    if mode == "cell":
        cfg = tn.plan_cells(box.numpy(), R_CUT, skin=SKIN, n=ts.N, cap=12)
        table = tn.neighbor_cell_table(cfg.ncells)
        tl = tn.build_cell_list(P, box, cfg, torch.as_tensor(table))
        one = [tn.build_cell_list(P[r], box, cfg, torch.as_tensor(table))
               for r in range(B)]
        jl = jax.jit(jax.vmap(lambda p: jn.build_cell_list(
            p, jnp.asarray(box.numpy()), cfg, table)))(jnp.asarray(pos))
        fields = ("bucket_idx", "slot_of")
    else:
        cfg = tn.plan_zcolumns(box.numpy(), R_CUT, skin=SKIN, n=ts.N)
        cfg = cfg._replace(cap=16)  # small, so that 30 in a column overflow
        table = torch.as_tensor(tn.xy_neighbor_table(*cfg.ncells[:2]))
        tl = tn.build_zcol_list(P, box, cfg, table)
        one = [tn.build_zcol_list(P[r], box, cfg, table) for r in range(B)]
        jl = jax.jit(jax.vmap(lambda p: jn.build_zcol_list(
            p, jnp.asarray(box.numpy()), cfg)))(jnp.asarray(pos))
        fields = ("bucket_idx", "slot_of", "halo_idx", "anchor",
                  "local_anchor")
        assert torch.equal(tl.anchor, P)
        np.testing.assert_array_equal(tl.halo_idx.numpy(),
                                      np.asarray(jl.halo_idx))
        _close(tl.local_anchor, jl.local_anchor, 1e-12, "local_anchor")
    assert tl.bucket_idx.shape == (B, cfg.total_cells, cfg.cap)
    assert tl.slot_of.shape == (B, ts.N) and tl.overflow.shape == (B,)
    assert tl.overflow.tolist() == [False, True, False]
    for r in range(B):
        for k in fields:
            assert torch.equal(getattr(tl, k)[r], getattr(one[r], k)), (r, k)
        assert bool(tl.overflow[r]) == bool(one[r].overflow)
    _same_list(tl, jl, mode)


# ---------------------------------------------------------- 2. the forces
@pytest.fixture(scope="module")
def jax_forces(world):
    """``jax.vmap`` of the JAX cell-mode ForceField.compute over the
    replicas, one jit."""
    js, jff = world["js"], world["jff"]

    def one(p, i):
        return jff.compute(p, i, js.box_L, js.charge, js.typeid,
                           js.bond_group, js.bond_typeid)

    image = np.zeros(world["pos"].shape, np.int32)
    image[2, :4, 1] = -1
    return jax.jit(jax.vmap(one))(jnp.asarray(world["pos"]),
                                  jnp.asarray(image)), image


@pytest.mark.parametrize("mode", ["cell", "zcol"])
def test_batched_forces_match_jax_vmap(world, jax_forces, mode):
    """Batched cell- and zcol-mode forces and every energy at B = 3
    against ``jax.vmap`` of the JAX cell-mode ``ForceField.compute``, to
    1e-10 in f64; the overflow flag is one a replica; a replica of the
    batch is the one-replica call to 1e-12."""
    (jf, je), image = jax_forces
    ts, tff = world["ts"], world["tffs"][mode]
    P, I = torch.as_tensor(world["pos"]), torch.as_tensor(image)
    f, e = tff(P, I, ts.box_L, ts.charge, ts.typeid)
    assert f.shape == (B, ts.N, 3)
    _close(f, jf, TOL_OP, f"{mode} F")
    for k, v in je.items():
        assert e[k].shape == (B,), k
        _close(e[k], v, TOL_OP, f"{mode} {k}")
    assert e["cell_overflow"].shape == (B,)
    assert not e["cell_overflow"].any()
    f1, e1 = tff(P[2], I[2], ts.box_L, ts.charge, ts.typeid)
    _close(f[2], f1.numpy(), TOL_SELF, f"{mode} replica 2 F")
    for k, v in e1.items():
        _close(e[k][2], v.numpy(), TOL_SELF, f"{mode} replica 2 {k}")


# ------------------------------------------------ 3. the batched steps
def _methods(kind):
    spec = (("bussi", "molecular", dict(kT=KT, tau=TAU)),
            ("langevin", "cavity", dict(kT=KT, gamma=GAMMA)))
    cls = MethodSpec if kind == "port" else JMethodSpec
    return tuple(cls(kind=k, group=g, **kw) for k, g, kw in spec)


@pytest.fixture(scope="module")
def jax_traj(world):
    """JAX's 20 batched cell-mode steps (Bussi + Langevin, dt 0.5 fs) from
    the B jittered snapshots, each replica's list carried."""
    jff = world["jff"]
    jm = j_resolve_methods(world["js"], _methods("jax"), jff.l_typeid)
    jstate = j_init_replicas(world["snaps"], jff, dt=DT, seed=3)
    assert jstate.cell_list is not None
    step = j_make_step_fn(jff, jm)
    final, obs = jax.jit(lambda s: j_run_replica_steps(step, s, 20))(jstate)
    return jstate, final, obs


def _start(world, jstate, mode):
    return state_from_numpy(**{k: np.asarray(getattr(jstate, k))
                               for k in LEAVES}, seed=3,
                            forcefield=world["tffs"][mode], device="cpu")


def _step(world, mode, noise):
    tff = world["tffs"][mode]
    return make_step_fn(tff, resolve_methods(world["ts"], _methods("port"),
                                             tff.l_typeid), noise=noise)


@pytest.mark.parametrize("mode", ["cell", "zcol"])
def test_batched_trajectory_matches_jax_run_replica_steps(world, jax_traj,
                                                          mode):
    """20 batched steps with JAX's per-replica draws, against JAX's cell
    mode: positions, velocities, images and every observable to 1e-9 of
    scale in cell mode (the bar of the dense batch) and 1e-10 in zcol
    mode (the bar of the one-replica zcol run); ``state_from_numpy``
    builds the batched list JAX carries; every replica's list is rebuilt
    inside the window, and in cell mode the final lists equal JAX's."""
    jstate, jfinal, jobs = jax_traj
    start = _start(world, jstate, mode)
    assert start.cell_list.bucket_idx.shape[0] == B
    assert torch.equal(start.cell_anchor, start.position)
    if mode == "cell":
        _same_list(start.cell_list, jstate.cell_list, "start")
    else:
        assert start.cell_list.halo_idx.shape[0] == B
    final, obs = run_replica_steps(_step(world, mode,
                                         ReplicaJaxNoise(jstate.key)),
                                   start, 20)
    moved = (final.cell_anchor != start.position).flatten(1).any(dim=1)
    assert moved.all(), "a replica's list was never rebuilt"
    tol = TOL_TRAJ[mode]
    for k in ("position", "velocity"):
        _close(getattr(final, k), getattr(jfinal, k), tol, k)
    np.testing.assert_array_equal(final.image.numpy(),
                                  np.asarray(jfinal.image))
    for k in OBS_KEYS + ("cell_overflow",):
        assert obs[k].shape == (20, B), k
        _close(obs[k], jobs[k], tol, k)
    if mode == "cell":
        _same_list(final.cell_list, jfinal.cell_list, "final")


@pytest.mark.parametrize("mode", ["cell", "zcol"])
def test_batch_matches_one_replica_runs(world, jax_traj, mode):
    """The batch against B one-replica port runs from each replica's
    start, same draws, to 1e-12 of scale; each run's carried list equals
    its replica's slice of the batch's."""
    jstate = jax_traj[0]
    start = _start(world, jstate, mode)
    final, obs = run_replica_steps(_step(world, mode,
                                         ReplicaJaxNoise(jstate.key)),
                                   start, 20)
    tff = world["tffs"][mode]
    for r in range(B):
        one = start.replace(**{k: getattr(start, k)[r] for k in PER_REPLICA})
        one = one.replace(cell_list=tff.build_cells(one.position, one.box_L),
                          cell_anchor=one.position)
        fr, obs_r = run_steps(_step(world, mode,
                                    ReplicaJaxNoise(jstate.key, replica=r)),
                              one, 20)
        _close(final.position[r], fr.position.numpy(), TOL_SELF,
               f"{r} position")
        _close(final.velocity[r], fr.velocity.numpy(), TOL_SELF,
               f"{r} velocity")
        assert torch.equal(final.image[r], fr.image)
        assert torch.equal(final.cell_anchor[r], fr.cell_anchor)
        assert torch.equal(final.cell_list.bucket_idx[r],
                           fr.cell_list.bucket_idx)
        for k in OBS_KEYS + ("cell_overflow",):
            _close(obs[k][:, r], obs_r[k], TOL_SELF, f"{r} {k}")


# ----------------------------------------------- 4. init_replica_states
@pytest.mark.parametrize("mode", ["cell", "zcol"])
def test_init_replica_states_carries_the_batched_list(world, mode):
    """``init_replica_states`` in cell and zcol mode: the batched list and
    its anchor, each replica's equal to its own ``init_state``'s, and the
    forces those of the one-replica states (and of the JAX package's
    ``init_replica_states``)."""
    ts, tff = world["ts"], world["tffs"][mode]
    tsnaps = [ts.replace(position=torch.as_tensor(p)) for p in world["pos"]]
    state = init_replica_states(tsnaps, tff, dt=DT, seed=3)
    clist = state.cell_list
    assert clist.bucket_idx.shape[0] == B and clist.overflow.shape == (B,)
    assert torch.equal(state.cell_anchor, state.position)
    for r, snap in enumerate(tsnaps):
        one = init_state(snap, tff, dt=DT, seed=3 + r)
        for k in ("bucket_idx", "slot_of", "overflow", "anchor",
                  "local_anchor", "halo_idx"):
            a, b = getattr(clist, k), getattr(one.cell_list, k)
            assert (a is None) == (b is None), k
            if a is not None:
                assert torch.equal(a[r], b), (r, k)
        assert torch.equal(state.forces[r], one.forces)
    if mode == "cell":
        jstate = j_init_replicas(world["snaps"], world["jff"], dt=DT, seed=3)
        _close(state.forces, jstate.forces, TOL_OP, "forces")
        _same_list(clist, jstate.cell_list, "init")
