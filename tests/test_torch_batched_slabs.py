"""A replica batch over slabs (float64, CPU, gloo): the slab pipeline of
``cavmd_tpu_torch/parallel/domain.py`` with a replica axis, the plain
twins of its kernels on per-replica tables, and the CLI's
``--vmap-replicas --shard-atoms S`` and ``--shard-replicas R
--shard-atoms S``.

- the batched rebuild gives each replica ``_rebuild_one``'s tables of its
  positions, and K7's twin (``cell_pair_force_slab`` on the CPU) on a
  batch with each replica's own tables, and K2's and K3's twins with a
  charge row a replica, give each replica the one-replica twin's result:
  bit for bit;
- the batched slab runner (adaptive dt, the dipole and rho(k) inside the
  slab step) at R = 1, S = 1 with B = 4 in this process and at S = 2 on
  2 gloo ranks, against the port's ``run_replica_steps`` in cell mode:
  positions to 1e-10, observables to 1e-8; at S = 1 also with the MTTK
  and Berendsen baths;
- R = 2 x S = 2 with B = 4 (two replicas a rank) on JAX's
  ``init_replica_states`` batch with JAX's own draws against JAX's
  ``run_replica_steps``, the protocol of
  tests/test_torch_shard_replicas.py::test_replicas_x_slabs_match_jax:
  positions and dt to 1e-10 relative, the shared observables to 1e-8;
- the CLI's batch over slabs on 2 and on 4 ranks writes the one-rank
  ``--vmap-replicas`` batch's files (``dryrun.hold_run_files``) to 1e-10,
  inside JAX's bound for its padded runs (rtol 1e-8, atol 1e-10,
  tests/test_driver.py:209); a world of another size exits 2 before any
  work;
- an overflow of the slab plan in one replica of the CLI's batch grows
  the plan and reruns the chunk for the whole batch: the run equals one
  that planned the grown capacities from the start.

The spawned ranks run functions of the port and of this module, which
imports JAX only inside its JAX fixture: JAX's draws reach them as a
table.
"""

import os

import numpy as np
import pytest
import torch

import cavmd_tpu_torch as pt
from cavmd_tpu_torch.core import PhysicalConstants as PC
from cavmd_tpu_torch.drivers import advanced_run
from cavmd_tpu_torch.dryrun import cli_in, hold_run_files
from cavmd_tpu_torch.integrate import make_adaptive_step, make_step_fn
from cavmd_tpu_torch.interop import state_from_numpy
from cavmd_tpu_torch.io import HOOMDTrajectory
from cavmd_tpu_torch.observe import generate_fibonacci_sphere, make_extra_obs
from cavmd_tpu_torch.ops import cell_kernels as ck
from cavmd_tpu_torch.ops.pppm_kernels import (
    interpolate_grad_plain,
    spread_grid_plain,
)
from cavmd_tpu_torch.parallel import (
    Communicator,
    init_replica_states,
    make_domain_runner,
    plan_domain,
    run_replica_steps,
)
from cavmd_tpu_torch.parallel import domain as td
from cavmd_tpu_torch.parallel.launch import (
    XS_ADAPTIVE,
    _dryrun_scene,
    run_ranks,
)
from cavmd_tpu_torch.parallel.replicas import replica_rows

# 120 diatomics + the photon in a 36-bohr box (the reference density),
# r_cut 8 and PPPM 16^3, cell mode: 4 cells of 8.5 bohr an axis, 2 x-layers
# a slab at S = 2
SCENE = (120, 36.0, 8.0, (16, 16, 16))
B, STEPS, REBUILD = 4, 12, 5
DT = PC.fs_to_atomic_units(0.5)
WV = generate_fibonacci_sphere(8) * 1.0
TOL, OBS_TOL = 1e-10, 1e-8
OBS_KEYS = ("dipole", "rho_k_re", "rho_k_im", "error_tolerance", "dt", "lj",
            "ewald_short", "ewald_long", "harmonic", "kinetic_molecular",
            "cavity_coupling", "bussi_reservoir_molecular",
            "langevin_reservoir_cavity")
# the slab CLI test's scene (tests/test_torch_domain_dist.py), 4 replicas
CLI_ARGS = ["--device", "CPU", "--n-molecules", "40", "--box-L", "64",
            "--runtime", "0.0015", "--enable-energy-tracker", "--enable-fkt",
            "--fkt-wavevectors", "8", "--seed", "0",
            "--energy-output-period-ps", "0.0005", "--replicas", "1-4"]
CLI_DIR = "cavity_coupling_1eneg03"
# the overflow case: replica 1 starts from a frame whose every molecule
# straddles a slab boundary (its singles outgrow the plan's ns_cap)
OVERFLOW_ARGS = ["--device", "CPU", "--runtime", "0.0005",
                 "--input-gsd", "../../straddle.gsd", "--replicas", "0-1",
                 "--energy-output-period-ps", "0.0005",
                 "--enable-energy-tracker", "--coupling", "2e-3",
                 "--pppm-resolution", "16",
                 "--vmap-replicas", "--shard-atoms", "2"]
OVERFLOW_DIR = "cavity_coupling_2eneg03"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: its tensors are small, and the
    suite runs six workers on the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batch():
    """The scene and its B-replica batch (thermalized at seed 11 + r,
    initial tolerance 5e-9): (snapshot, force field, methods, batch)."""
    snap, ff, methods, kT = _dryrun_scene(*SCENE)
    batch = init_replica_states(snap, ff, n_replicas=B, dt=DT, seed=11,
                                kT=kT, error_tolerance=5e-9)
    return snap, ff, methods, batch


def _jittered(batch, scale=0.7):
    """The batch with each replica's positions moved apart (seeded, about
    ``scale`` bohr) and re-wrapped: the replicas of ``init_replica_states``
    start from one scene, so their layouts would agree."""
    rng = np.random.default_rng(3)
    p = batch.position + torch.from_numpy(
        scale * rng.standard_normal(tuple(batch.position.shape)))
    return batch.replace(position=p - batch.box_L * torch.round(
        p / batch.box_L))


def _host(final, obs, S):
    return dict(position=final.position.numpy(), dt=final.dt.numpy(),
                image=final.image.numpy(), obs=obs, S=S)


def _slab_job(n_replicas=1, start=None, table=None):
    """The batch through ``make_domain_runner`` for STEPS steps rebuilt
    every REBUILD (adaptive dt, dipole and rho(k)): in this process at one
    slab, or as a ``run_ranks`` job on R x S ranks (S = world / R). With
    ``start`` (JAX's leaves) and ``table`` (JAX's draws) the batch and the
    draws are JAX's. Returns NumPy."""
    import torch.distributed as dist

    S = dist.get_world_size() // n_replicas if dist.is_initialized() else 1
    comm = None
    if dist.is_initialized() and n_replicas == 1:
        comm = Communicator.from_process_group()
    noise = None
    if start is None:
        snap, ff, methods, batch = _batch()
    else:
        snap, ff, methods, _ = _dryrun_scene(*SCENE)
        b = start["position"].shape[0] // n_replicas
        lo = dist.get_rank() // S * b
        noise = JaxRowsDraws(table, lo, lo + b)
        batch = state_from_numpy(**start, dtype=torch.float64, device="cpu")
    run = make_domain_runner(ff, methods, plan_domain(snap, ff, S), comm,
                             rebuild_every=REBUILD, adaptive=XS_ADAPTIVE,
                             obs_spec=(True, WV), noise=noise,
                             n_replicas=n_replicas)
    final, obs = run(batch, STEPS)
    return _host(final, obs, S)


class JaxRowsDraws:
    """Rows ``[lo, hi)`` of the JAX batch's draws at each host step, from
    a table made in the test process (``table[kind, i]``: (steps, B, ...)
    arrays), so that the spawned ranks need no JAX."""

    def __init__(self, table, lo, hi):
        self.table, self.lo, self.hi = table, lo, hi

    def _t(self, x, state):
        return torch.tensor(x[state.step, self.lo:self.hi],
                            dtype=state.position.dtype)

    def bussi(self, state, i, m):
        return tuple(self._t(x, state) for x in self.table["bussi", i])

    def langevin(self, state, i, m, shape):
        return self._t(self.table["langevin", i], state).reshape(shape)


def _straddling_input(path):
    """A 2-frame input GSD of the CLI's 40-molecule scene in the 64-bohr
    box: frame 0 as generated (molecules on a 16-bohr lattice, none
    across x = 0 or the x face), frame 1 with every molecule across one of
    those two slab boundaries of S = 2 (its bond along x, every other one
    reversed so that the dipoles cancel; centres 12 bohr apart in y and
    z)."""
    snap = pt.make_diatomic_system(40, box_L=64.0, seed=0,
                                   dtype=torch.float64, device="cpu")
    pos = snap.position.clone().reshape(40, 2, 3)
    half = 0.5 * torch.linalg.norm(pos[:, 1] - pos[:, 0], dim=-1)
    k = torch.arange(40)
    centre = torch.stack([torch.where(k < 20, 0.0, 32.0),
                          -24.0 + 12.0 * (k % 20 % 5),
                          -24.0 + 12.0 * (k % 20 // 5)], dim=-1).double()
    half = torch.where(k % 2 == 0, half, -half)
    pos[:, 0], pos[:, 1] = centre, centre.clone()
    pos[:, 0, 0] -= half
    pos[:, 1, 0] += half
    pos = pos.reshape(80, 3)
    pos = pos - 64.0 * torch.round(pos / 64.0)
    with HOOMDTrajectory(path, "w") as t:
        t.append(snap, step=0, dtype=np.float64)
        t.append(snap.replace(position=pos), step=1, dtype=np.float64)
    return snap, pos


def _cli_planned(directory, argv, grow):
    """``advanced_run.main(argv)`` in ``directory`` (a ``run_ranks``
    job), its slab plan grown once up front when ``grow``; returns the
    exit code and the CLI's warnings."""
    import logging

    from cavmd_tpu_torch.parallel import domain

    real = domain.plan_domain
    if grow:
        domain.plan_domain = lambda *a, **k: real(*a, **k).grow_cap()
    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    log = logging.getLogger(advanced_run.__name__)
    keep = Keep()
    log.addHandler(keep)
    try:
        return cli_in(directory, argv), seen
    finally:
        log.removeHandler(keep)
        domain.plan_domain = real


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every spawned job: on 2 ranks the S = 2 runner, the CLI's
    ``--vmap-replicas --shard-atoms 2``, a world of 2 for 2 x 2 and the
    overflow pair; on 4 ranks the CLI's ``--shard-replicas 2 --shard-atoms
    2`` and the 2 x 2 runner on JAX's batch; in this process the one-rank
    batch's files. Returns the root directory and every result."""
    jax_case = _jax_batch()
    root = tmp_path_factory.mktemp("batched_slabs")
    dirs = {k: root / k for k in ("one", "two", "four", "mismatch",
                                  "grown", "retried")}
    for d in dirs.values():
        d.mkdir()
    _straddling_input(str(root / "straddle.gsd"))
    two = run_ranks([
        (_slab_job, ()),
        (cli_in, (str(dirs["two"]), CLI_ARGS + ["--vmap-replicas",
                                                "--shard-atoms", "2"])),
        (cli_in, (str(dirs["mismatch"]), CLI_ARGS + [
            "--shard-replicas", "2", "--shard-atoms", "2"])),
        (_cli_planned, (str(dirs["retried"]), OVERFLOW_ARGS, False)),
        (_cli_planned, (str(dirs["grown"]), OVERFLOW_ARGS, True))], 2)
    four = run_ranks([
        (cli_in, (str(dirs["four"]), CLI_ARGS + [
            "--shard-replicas", "2", "--shard-atoms", "2"])),
        (_slab_job, (2, jax_case["start"], jax_case["table"]))], 4)
    one = cli_in(str(dirs["one"]), CLI_ARGS + ["--vmap-replicas"])
    return dict(root=root, dirs=dirs, one=one, jax=jax_case,
                s2=two[0], cli2=two[1], mismatch=two[2],
                overflow=(two[3], two[4]), cli4=four[0], jax_ranks=four[1])


def _jax_batch():
    """The JAX package on SCENE: B replicas (seed 11, tolerance 5e-9), the
    adaptive step with the dipole and rho(k) observables under
    ``jax.vmap``, STEPS steps; the batch's leaves (for
    ``state_from_numpy``), the final positions and dt, the observables,
    and each step's Bussi and Langevin draws of every replica's key."""
    import jax
    import jax.numpy as jnp

    from cavmd_tpu.core import add_cavity_particle, make_diatomic_system
    from cavmd_tpu.integrate import (
        ForceField,
        MethodSpec,
        resolve_methods,
        run_steps,
    )
    from cavmd_tpu.integrate import make_step_fn as j_make_step_fn
    from cavmd_tpu.integrate.adaptive import (
        make_adaptive_step as j_adaptive,
    )
    from cavmd_tpu.integrate.rng import (
        STREAM_BUSSI,
        STREAM_LANGEVIN,
        stream_key,
    )
    from cavmd_tpu.integrate.thermostats import bussi_noise
    from cavmd_tpu.observe import make_extra_obs as j_extra_obs
    from cavmd_tpu.parallel.replicas import (
        init_replica_states as j_init_replicas,
    )
    from cavmd_tpu.parallel.replicas import make_replica_step

    n_mol, box, r_cut, mesh = SCENE
    kT = PC.kT_from_kelvin(100.0)
    snap = add_cavity_particle(make_diatomic_system(
        n_mol, box_L=box, temperature_K=100.0, seed=0, dtype=np.float64),
        coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1)
    ff = ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                           r_cut=r_cut, pair_mode="cell", pppm_mesh=mesh)
    methods = resolve_methods(snap, (
        MethodSpec(kind="bussi", group="molecular", kT=kT,
                   tau=PC.ps_to_atomic_units(5.0)),
        MethodSpec(kind="langevin", group="cavity", kT=kT,
                   gamma=PC.gamma_from_tau_ps(5.0))), ff.l_typeid)
    batch = j_init_replicas(snap, ff, n_replicas=B, dt=DT, seed=11, kT=kT,
                            error_tolerance=5e-9)
    step = j_adaptive(j_make_step_fn(
        ff, methods, extra_obs=j_extra_obs(dipole=True, wavevectors=WV)),
        **XS_ADAPTIVE)
    final, obs = jax.jit(lambda s: run_steps(make_replica_step(step), s,
                                             STEPS))(batch)

    @jax.jit
    def draws(keys, t):
        def one(key):
            r1, rg = bussi_noise(stream_key(key, STREAM_BUSSI, t, 0),
                                 float(methods[0].dof), jnp.float64)
            return r1, rg, jax.random.normal(
                stream_key(key, STREAM_LANGEVIN, t, 1), (1, 3),
                dtype=jnp.float64)
        return jax.vmap(one)(keys)

    per_step = [[np.asarray(x) for x in draws(batch.key, t)]
                for t in range(STEPS)]
    table = {("bussi", 0): tuple(np.stack([d[j] for d in per_step])
                                 for j in (0, 1)),
             ("langevin", 1): np.stack([d[2] for d in per_step])}
    leaves = ("position", "image", "velocity", "mass", "charge", "typeid",
              "box_L", "forces", "dt", "time_au", "time_comp", "timestep",
              "bussi_reservoir", "bussi_instantaneous", "langevin_reservoir",
              "error_tolerance")
    return dict(start={k: np.asarray(getattr(batch, k)) for k in leaves},
                table=table, typeid=np.asarray(snap.typeid),
                position=np.asarray(final.position),
                dt=np.asarray(final.dt),
                obs={k: np.asarray(v) for k, v in obs.items()})


@pytest.fixture(scope="module")
def reference():
    """The port's ``run_replica_steps`` on the batch in cell mode, the
    adaptive step with the dipole and rho(k) observables."""
    _, ff, methods, batch = _batch()
    step = make_adaptive_step(make_step_fn(
        ff, methods, extra_obs=make_extra_obs(dipole=True, wavevectors=WV)),
        **XS_ADAPTIVE)
    final, obs = run_replica_steps(step, batch, STEPS)
    return _host(final, obs, 0)


def _hold(got, want, tol=TOL):
    """Positions within ``tol`` (relative and absolute), dt within ``tol``
    relative, image flags equal, the observables of OBS_KEYS in (steps,
    B, ...) within OBS_TOL of their own, no overflow."""
    np.testing.assert_allclose(got["position"], want["position"], rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got["dt"], want["dt"], rtol=tol)
    np.testing.assert_array_equal(got["image"], want["image"])
    for k in OBS_KEYS:
        w = want["obs"][k]
        assert got["obs"][k].shape == w.shape and w.shape[:2] == (STEPS, B), k
        np.testing.assert_allclose(got["obs"][k], w, rtol=OBS_TOL,
                                   atol=1e-12, err_msg=k)
    assert not got["obs"]["cell_overflow"].any()


@pytest.mark.parametrize("S", [1, 2])
def test_rebuild_is_each_replicas_own(S):
    """``_rebuild`` of the batch's (B, N, 3) positions, each replica's
    moved apart: each replica's every table equal to ``_rebuild_one`` of
    its positions, bit for bit (integers and floats), and the batch's
    flags their OR."""
    snap, ff, _, batch = _batch()
    batch = _jittered(batch)
    plan = plan_domain(snap, ff, S)
    args = (plan, batch.box_L, ff.bond_k_per, ff.bond_r0_per, ff.pair_inert,
            batch.charge)
    data = td._rebuild(batch.position, *args)
    flags = [False, False]
    for r in range(B):
        one = td._rebuild_one(batch.position[r], *args)
        for name in td.DomainData._fields:
            got = getattr(data, name)
            if name.endswith("overflow"):
                flags[name == "bucket_overflow"] |= bool(getattr(one, name))
                continue
            assert got.dtype == getattr(one, name).dtype, name
            assert torch.equal(got[r], getattr(one, name)), (name, r)
    assert [bool(data.slab_overflow), bool(data.bucket_overflow)] == flags
    assert not torch.equal(data.buckets[0], data.buckets[1])


def test_batched_twins_are_each_replicas_one_replica_twin():
    """At S = 2, slab 0 of the batch (each replica's positions moved
    apart): the tile pass's inputs (``tile_pass_inputs`` of the batch)
    hold each replica's own tables,
    equal to the one-replica inputs of its rows; the batched K7 twin,
    and the K2 and K3 twins with a charge row a replica, give each
    replica the one-replica twin's forces, energies, grid and gradient
    bit for bit."""
    snap, ff, _, batch = _batch()
    batch = _jittered(batch)
    plan = plan_domain(snap, ff, 2)
    args, cells, key = td.tile_pass_inputs(ff, plan, batch)
    assert args[4].shape == (B, plan.Mtot) and key.shape == (B, plan.Mtot)
    assert args[10].shape == (B, plan.Mtot + 1, plan.B)
    f, e_lj, e_ew = ck.cell_pair_force_slab(*args, cells, key)
    pos, charge = args[0][:, :plan.Mrow], args[5][:, :plan.Mrow]
    assert not torch.equal(charge[0], charge[1])
    mesh, order = tuple(ff.pppm_mesh), ff.pppm_order
    grid = spread_grid_plain(pos, charge, batch.box_L, order, mesh)
    ct = torch.sin(torch.arange(grid.numel(), dtype=grid.dtype)).reshape(
        grid.shape)
    grad = interpolate_grad_plain(ct, pos, charge, batch.box_L, order, mesh)
    for r in range(B):
        a1, c1, k1 = td.tile_pass_inputs(ff, plan, replica_rows(batch, r))
        assert c1 == cells and torch.equal(k1, key[r])
        for i in (0, 4, 5, 10):
            assert torch.equal(args[i][r], a1[i]), i
        assert torch.equal(args[2].bucket_idx[r], a1[2].bucket_idx)
        f1, lj1, ew1 = ck.cell_pair_force_slab(*a1, cells, k1)
        assert torch.equal(f[r], f1)
        assert torch.equal(e_lj[r], lj1) and torch.equal(e_ew[r], ew1)
        assert torch.equal(grid[r], spread_grid_plain(
            pos[r], charge[r], batch.box_L, order, mesh))
        assert torch.equal(grad[r], interpolate_grad_plain(
            ct[r], pos[r], charge[r], batch.box_L, order, mesh))
    # a batch of one table for all (the unsharded batch) is unchanged
    shared = spread_grid_plain(pos, charge[0], batch.box_L, order, mesh)
    assert torch.equal(shared[0], grid[0])


def test_one_slab_batch_matches_run_replica_steps(reference):
    """R = 1, S = 1, B = 4 in this process (the form the card's smoke run
    drives): every replica as ``run_replica_steps`` of the batch."""
    got = _slab_job()
    assert got["S"] == 1
    _hold(got, reference)
    assert not np.allclose(reference["position"][0],
                           reference["position"][1])
    assert np.ptp(reference["obs"]["dt"]) > 0


@pytest.mark.parametrize("bath", ["mttk", "berendsen"])
def test_one_slab_batch_with_baths_matches_run_replica_steps(bath):
    """MTTK or Berendsen (tau 0.05 ps) on the molecules and Langevin on
    the photon: the batched slab runner at one slab (each replica's group
    kinetic energies, factors and (xi, eta)) against ``run_replica_steps``
    of the batch, whose step runs the unfused tail: positions, velocities
    and (xi, eta) to 1e-10 of their scale, every observable to 1e-8 of
    its own."""
    snap, ff, _, batch = _batch()
    kT = PC.kT_from_kelvin(100.0)
    methods = pt.resolve_methods(snap, (
        pt.MethodSpec(bath, "molecular", kT=kT,
                      tau=PC.ps_to_atomic_units(0.05)),
        pt.MethodSpec("langevin", "cavity", kT=kT,
                      gamma=PC.gamma_from_tau_ps(5.0))), ff.l_typeid)
    want, wobs = run_replica_steps(make_step_fn(ff, methods),
                                   batch.replace(generators={}), STEPS)
    run = make_domain_runner(ff, methods, plan_domain(snap, ff, 1),
                             rebuild_every=REBUILD)
    got, gobs = run(batch.replace(generators={}), STEPS)
    for name in ("position", "velocity", "mttk_xi", "mttk_eta"):
        w = getattr(want, name).numpy()
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=0,
                                   atol=TOL * max(np.abs(w).max(), 1e-300),
                                   err_msg=name)
    for k, w in wobs.items():
        assert gobs[k].shape == w.shape, k
        np.testing.assert_allclose(gobs[k], w, rtol=0,
                                   atol=OBS_TOL * max(np.abs(w).max(),
                                                      1e-12), err_msg=k)
    if bath == "mttk":
        assert np.ptp(got.mttk_xi[:, 0].numpy()) > 0


def test_two_slab_batch_matches_run_replica_steps(ranks, reference):
    """S = 2 on 2 gloo ranks, every rank holding slab s of all 4
    replicas: each rank returns the whole batch, as ``run_replica_steps``
    of it."""
    for got in ranks["s2"]:
        assert got["S"] == 2
        _hold(got, reference)


def test_replicas_x_slabs_two_a_rank_match_jax(ranks):
    """R = 2 x S = 2 over 4 gloo ranks with two replicas a rank, on JAX's
    batch with JAX's draws (rank (r, s) takes rows [2 r, 2 r + 2) of the
    table), against JAX's ``run_replica_steps``: every rank's positions
    and dt within 1e-10 (relative; positions 1e-12 absolute), every
    observable the two packages share within 1e-8."""
    want = ranks["jax"]
    snap, _, _, _ = _batch()
    np.testing.assert_array_equal(snap.typeid.numpy(), want["typeid"])
    assert not np.allclose(want["position"][0], want["position"][3])
    for got in ranks["jax_ranks"]:
        assert got["S"] == 2
        np.testing.assert_allclose(got["position"], want["position"],
                                   rtol=TOL, atol=1e-12)
        np.testing.assert_allclose(got["dt"], want["dt"], rtol=TOL)
        shared = sorted(set(want["obs"]) & set(got["obs"]))
        assert set(OBS_KEYS) <= set(shared)
        for k in shared:
            assert got["obs"][k].shape == want["obs"][k].shape, k
            np.testing.assert_allclose(got["obs"][k], want["obs"][k],
                                       rtol=OBS_TOL, atol=1e-12, err_msg=k)
        assert not got["obs"]["domain_capacity_overflow"].any()


@pytest.mark.parametrize("case", ["cli2", "cli4"])
def test_cli_batch_over_slabs_writes_the_one_rank_batch(ranks, case):
    """``--vmap-replicas --shard-atoms 2`` on 2 ranks and
    ``--shard-replicas 2 --shard-atoms 2`` on 4: every rank exits 0, and
    the files of the 4 replicas (energy, cavity mode, F(k,t), dipole, GSD
    frames and their log chunks) are the one-rank ``--vmap-replicas``
    batch's to 1e-10, written by the slab-0 ranks alone."""
    rcs = ranks[case]
    assert rcs == [0] * (2 if case == "cli2" else 4) and ranks["one"] == 0
    got, want = (ranks["dirs"][k] / CLI_DIR
                 for k in ("two" if case == "cli2" else "four", "one"))
    names = hold_run_files(got, want, TOL)
    for r in range(1, 5):
        assert {f"prod-{r}.gsd", f"prod-{r}_energy_tracker.txt",
                f"prod-{r}_cavity_mode.txt", f"prod-{r}_ref0.txt",
                f"prod-{r}_dipole_autocorr_0.txt"} <= set(names)


def test_cli_world_of_another_size_exits_2(ranks):
    """``--shard-replicas 2 --shard-atoms 2`` in a world of 2 ranks: exit
    2 on each, before any work."""
    assert ranks["mismatch"] == [2, 2]
    assert os.listdir(ranks["dirs"]["mismatch"]) == []


def test_overflow_in_one_replica_grows_the_plan_for_the_batch(ranks):
    """Replica 1's frame puts every molecule across a slab boundary, so
    its singles outgrow the plan's ns_cap while replica 0 fits: the first
    chunk flags the whole batch, the plan grows once and the chunk runs
    again from its start on both slab ranks; every file then equals a run
    that planned the grown capacities from the start (1e-12), which never
    retried."""
    root = ranks["root"]
    retried, grown = ranks["overflow"]
    assert [rc for rc, _ in retried] == [0, 0]
    assert [rc for rc, _ in grown] == [0, 0]
    for _, warnings in retried:
        assert sum("re-planned" in w for w in warnings) == 1, warnings
    assert not any(w for _, w in grown)
    # the natural plan: replica 1's frame overflows it, replica 0's fits
    from cavmd_tpu_torch.io import open_gsd

    frames = []
    with open_gsd(str(root / "straddle.gsd")) as t:
        for f in range(2):
            frames.append(pt.add_cavity_particle(
                t.read_frame(f, dtype=torch.float64, device="cpu"),
                coupling=2e-3,
                freq_cm1=2000.0, temperature_K=100.0, seed=f + 1))
    ff = pt.ForceField.create(frames[0], coupling=2e-3, pair_mode="cell")
    plan = plan_domain(frames[0], ff, 2)
    over = [bool(td._rebuild_one(
        s.position, plan, s.box_L, ff.bond_k_per, ff.bond_r0_per,
        ff.pair_inert, s.charge).slab_overflow) for s in frames]
    assert over == [False, True]
    hold_run_files(ranks["dirs"]["retried"] / OVERFLOW_DIR,
                   ranks["dirs"]["grown"] / OVERFLOW_DIR, 1e-12)
