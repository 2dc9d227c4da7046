"""Replicas over ranks (float64, CPU, gloo): a slice of a replica batch,
the ``--shard-replicas`` CLI and ``make_domain_runner(n_replicas=)``.

- ``init_replica_states(first_replica=k)`` is rows ``k:k+B`` of the full
  batch bit for bit, and ``StreamNoise(full_batch, rows)`` draws the rows
  of the full batch's draws, on every step path (Bussi, Langevin,
  Brownian, the fused tail and the slab step);
- the CLI with ``--shard-replicas 2`` on 2 ranks writes, replica by
  replica, the files of the one-rank ``--vmap-replicas`` batch: a
  generated 10-molecule scene with adaptive dt and ``--enable-fkt``, and
  the multi-frame ``--input-gsd`` case of tests/test_driver.py:209;
- what cannot run exits non-zero before any work, and a rank whose setup
  fails ends every rank with exit 1;
- the R x S runner at 2 x 2 over 4 ranks follows tests/test_domain.py:333
  (adaptive dt, dipole and rho(k) inside the slab step): on JAX's batch
  with JAX's draws, each replica within 1e-10 of JAX's
  ``run_replica_steps`` and the obs in (steps, R, ...) within 1e-8; on
  the port's batch, within 1e-10 of the port's ``run_replica_steps``
  through ``dryrun_multichip(4)``, which also runs ``--shard-replicas 4``
  against the one-process batch.

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
from cavmd_tpu_torch.dryrun import (
    dryrun_multichip,
    hold_run_files,
    text_rows,
)
from cavmd_tpu_torch.integrate import StreamNoise
from cavmd_tpu_torch.integrate.integrator import MDState
from cavmd_tpu_torch.interop import state_from_numpy
from cavmd_tpu_torch.io import HOOMDTrajectory, open_gsd
from cavmd_tpu_torch.observe import generate_fibonacci_sphere
from cavmd_tpu_torch.parallel import Communicator, make_domain_runner
from cavmd_tpu_torch.parallel.domain import plan_domain
from cavmd_tpu_torch.parallel.launch import (
    XS_ADAPTIVE,
    _dryrun_scene,
    run_ranks,
)
from cavmd_tpu_torch.parallel.replicas import (
    PER_REPLICA,
    init_replica_states,
    replica_rows,
    run_replica_steps,
)
from cavmd_tpu_torch.utils import fire_minimize

KT = PC.kT_from_kelvin(100.0)
DT = PC.fs_to_atomic_units(0.25)
# the generated scene: 10 molecules, adaptive dt, F(k,t) and dipole files
GEN_ARGS = ["--device", "CPU", "--n-molecules", "10", "--runtime", "0.004",
            "--enable-energy-tracker", "--enable-fkt", "--fkt-wavevectors",
            "8", "--fkt-output-period-ps", "0.0005", "--fkt-ref-interval",
            "0.002", "--energy-output-period-ps", "0.001",
            "--gsd-output-period-ps", "0.002", "--replicas", "0-3",
            "--seed", "5"]
# tests/test_driver.py:209's multi-frame input (replica r starts from
# frame r), in its own coupling directory
FRAME_ARGS = ["--device", "CPU", "--runtime", "0.008", "--input-gsd",
              "../../multi.gsd", "--energy-output-period-ps", "0.001",
              "--gsd-output-period-ps", "0.004", "--replicas", "0-3",
              "--enable-energy-tracker", "--coupling", "2e-3"]
DIRS = {"gen": "cavity_coupling_1eneg03", "frames": "cavity_coupling_2eneg03"}
# a world of 2 ranks for --shard-replicas 3: refused before any work
MISMATCH_ARGS = ["--device", "CPU", "--replicas", "0-2", "--shard-replicas",
                 "3", "--coupling", "3e-3"]
# rank 1's setup raises (_fail_on_rank1): every rank exits 1
FAIL_ARGS = ["--device", "CPU", "--n-molecules", "10", "--runtime", "0.004",
             "--replicas", "0-1", "--shard-replicas", "2", "--coupling",
             "4e-3"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: its tensors are small, and the
    suite runs six workers on the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _multiframe_input(path, n_frames=4, n_molecules=10, seed=3):
    """The port's copy of tests/test_driver.py's ``_make_multiframe_input``:
    an n-frame input GSD of one FIRE-minimised scene with a seeded jitter
    a frame."""
    snap = pt.make_diatomic_system(n_molecules, box_L=16.0, seed=seed,
                                   dtype=torch.float64, device="cpu")
    ff0 = pt.ForceField.create(snap, enable_cavity=False)
    snap = fire_minimize(snap, ff0, n_steps=200)
    rng = np.random.default_rng(seed)
    with HOOMDTrajectory(path, "w") as t:
        for f in range(n_frames):
            p = snap.position + torch.from_numpy(
                1e-3 * rng.standard_normal(tuple(snap.position.shape)))
            t.append(snap.replace(position=p), step=f, dtype=np.float64)


def _fail_on_rank1(argv):
    """``advanced_run.main(argv)`` with rank 1's scene generation raising:
    its setup fails before rank 0's scene is broadcast (a run_ranks
    job)."""
    import torch.distributed as dist

    from cavmd_tpu_torch.core import system

    if dist.get_rank() == 1:
        def broken(*args, **kwargs):
            raise RuntimeError("setup failure on rank 1")
        system.make_diatomic_system = broken
    return advanced_run.main(argv)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both CLI cases on 2 ranks and in one process, the mismatched world
    and a failing setup, in one 2-rank spawn."""
    root = tmp_path_factory.mktemp("shard_replicas")
    for side in ("one", "two"):
        (root / side).mkdir()
    _multiframe_input(str(root / "multi.gsd"))
    cwd = os.getcwd()
    try:
        os.chdir(root / "two")
        rcs = run_ranks([(advanced_run.main, (args + ["--shard-replicas",
                                                      "2"],))
                         for args in (GEN_ARGS, FRAME_ARGS)]
                        + [(advanced_run.main, (MISMATCH_ARGS,)),
                           (_fail_on_rank1, (FAIL_ARGS,))], 2, timeout=300)
        os.chdir(root / "one")
        one = [advanced_run.main(args + ["--vmap-replicas"])
               for args in (GEN_ARGS, FRAME_ARGS)]
    finally:
        os.chdir(cwd)
    return root, rcs, one


@pytest.mark.parametrize("case", ["gen", "frames"])
def test_cli_on_two_ranks_writes_the_one_rank_batch(cli_runs, case):
    """Every replica's files of the 2-rank run against the one-rank
    batch's (``dryrun.hold_run_files``): the same names; text headers
    equal and rows within 1e-12; GSD files of the same frame count, steps
    and log/* chunks, positions within 1e-12. Replica r of the
    multi-frame case starts from input frame r, and the replicas
    decorrelate."""
    root, rcs, one = cli_runs
    k = ["gen", "frames"].index(case)
    assert rcs[k] == [0, 0] and one[k] == 0
    got_dir, want_dir = (root / side / DIRS[case] for side in ("two", "one"))
    names = hold_run_files(got_dir, want_dir, 1e-12)
    texts = [n for n in names if n.endswith(".txt")]
    assert len(texts) >= 4 * (4 if case == "gen" else 2)
    for name in texts:
        if name.endswith(("_tracker.txt", "_mode.txt", "ref0.txt")):
            assert len(text_rows(want_dir / name)[1]) >= 3, name
    finals = []
    for r in range(4):
        with open_gsd(str(got_dir / f"prod-{r}.gsd")) as g:
            assert len(g) >= 3
            assert any(n.startswith("log/") for n in g.file._names)
            finals.append(g.read_frame(len(g) - 1, device="cpu").position)
            if case == "frames":
                with open_gsd(str(root / "multi.gsd")) as src:
                    start = src.read_frame(r, device="cpu").position
                first = g.read_frame(0, device="cpu").position
                np.testing.assert_allclose(first[:start.shape[0]].numpy(),
                                           start.numpy(), atol=1e-6)
    assert not torch.allclose(finals[0], finals[1])


def test_world_size_other_than_r_exits_before_any_work(cli_runs):
    root, rcs, _ = cli_runs
    assert rcs[2] == [2, 2]
    assert not (root / "two" / "cavity_coupling_3eneg03").exists()


def test_setup_failure_on_one_rank_ends_every_rank(cli_runs):
    """Rank 1 raises while it generates the scene, before rank 0's
    minimum is broadcast: the ranks meet in one soundness gather instead
    of two different collectives, and both exit 1."""
    root, rcs, _ = cli_runs
    assert rcs[3] == [1, 1]
    assert not list((root / "two" / "cavity_coupling_4eneg03").glob(
        "*.gsd"))


def test_indivisible_batch_exits_before_any_work(tmp_path, monkeypatch,
                                                 capsys):
    """--replicas 1-3 over --shard-replicas 2 is refused, with the JAX
    driver's message, before a process group is asked for."""
    monkeypatch.chdir(tmp_path)
    rc = advanced_run.main(["--device", "CPU", "--replicas", "1-3",
                            "--shard-replicas", "2"])
    assert rc == 2
    assert "3 replicas not divisible by --shard-replicas 2" in \
        capsys.readouterr().err
    assert os.listdir(tmp_path) == []


def test_without_ranks_exits_before_any_work(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    rc = advanced_run.main(["--device", "CPU", "--replicas", "1-4",
                            "--shard-replicas", "2"])
    assert rc == 2
    assert "torch.distributed.run" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []


# ------------------------------------------------------------ the slice
def _dense_scene(dtype):
    """20 diatomics + the photon in a 20-bohr box, dense mode."""
    snap = pt.add_cavity_particle(pt.make_diatomic_system(
        20, box_L=20.0, temperature_K=100.0, seed=2, dtype=dtype,
        device="cpu"), coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0,
        seed=3)
    return snap, pt.ForceField.create(snap, r_cut=8.0, pppm_mesh=(8, 8, 8))


@pytest.fixture(scope="module")
def dense_scene():
    return _dense_scene(torch.float64)


@pytest.mark.parametrize("first, B", [(0, 2), (1, 2), (3, 1)])
def test_first_replica_is_rows_of_the_full_batch(dense_scene, first, B):
    """Thermal velocities, forces, clocks and every other per-replica leaf
    of ``init_replica_states(first_replica=k)`` equal rows ``k:k+B`` of
    the 4-replica batch bit for bit; the generators' seed is the batch's."""
    snap, ff = dense_scene
    kw = dict(dt=DT, seed=9, kT=KT, error_tolerance=1e-3)
    full = init_replica_states(snap, ff, n_replicas=4, **kw)
    part = init_replica_states(snap, ff, n_replicas=B, first_replica=first,
                               **kw)
    assert part.seed == full.seed and part.batch_shape == (B,)
    for k in PER_REPLICA:
        assert torch.equal(getattr(part, k),
                           getattr(full, k)[first:first + B]), k
    assert not torch.equal(full.velocity[0], full.velocity[1])


def _fresh(state: MDState) -> MDState:
    return state.replace(generators={})


def test_sliced_noise_is_the_rows_of_the_full_draw(dense_scene):
    """Each of ``StreamNoise``'s draws on the 4-replica batch, its rows
    1:3 from ``StreamNoise(4, 1:3)`` on the 2-replica slice and row 2
    from a one-row slice on one replica squeezed: Bussi above and below
    the Wilson-Hilferty shape, Langevin, Brownian, several calls a
    stream."""
    snap, ff = dense_scene
    full = init_replica_states(snap, ff, n_replicas=4, dt=DT, seed=4)
    part = replica_rows(full, slice(1, 3))
    one = replica_rows(full, 2)
    assert one.batch_shape == () and part.batch_shape == (2,)
    for dof in (9.0, 120.0):
        m = pt.MethodSpec("bussi", "molecular", kT=KT, tau=1.0, dof=dof)
        states = [_fresh(s) for s in (full, part, one)]
        for _ in range(2):
            want = StreamNoise().bussi(states[0], 0, m)
            got = StreamNoise(4, slice(1, 3)).bussi(states[1], 0, m)
            got1 = StreamNoise(4, slice(2, 3)).bussi(states[2], 0, m)
            for w, g, g1 in zip(want, got, got1):
                assert torch.equal(g, w[1:3]) and torch.equal(g1, w[2])
    m = pt.MethodSpec("langevin", "cavity", kT=KT, gamma=1e-3)
    states = [_fresh(s) for s in (full, part, one)]
    want = StreamNoise().langevin(states[0], 1, m, (4, 1, 3))
    assert torch.equal(StreamNoise(4, slice(1, 3)).langevin(
        states[1], 1, m, (2, 1, 3)), want[1:3])
    assert torch.equal(StreamNoise(4, slice(2, 3)).langevin(
        states[2], 1, m, (1, 3)), want[2])
    m = pt.MethodSpec("brownian", "molecular", kT=KT, gamma=1e-3)
    states = [_fresh(s) for s in (full, part)]
    want = StreamNoise().brownian(states[0], 0, m)
    got = StreamNoise(4, slice(1, 3)).brownian(states[1], 0, m)
    for w, g in zip(want, got):
        assert torch.equal(g, w[1:3])
    with pytest.raises(ValueError, match="rows"):
        StreamNoise(4, slice(1, 3)).bussi(_fresh(one), 0, m)
    with pytest.raises(ValueError, match="together"):
        StreamNoise(4)


BATHS = {
    "bussi_langevin": (("bussi", "molecular"), ("langevin", "cavity")),
    "langevin_brownian": (("langevin", "molecular"), ("brownian", "cavity")),
    "brownian_bussi": (("brownian", "molecular"), ("bussi", "cavity")),
}


@pytest.mark.parametrize("baths, dtype, fuse", [
    ("bussi_langevin", torch.float64, False),
    ("langevin_brownian", torch.float64, False),
    ("brownian_bussi", torch.float64, False),
    ("bussi_langevin", torch.float32, True)])
def test_slice_steps_as_its_rows_of_the_batch(baths, dtype, fuse):
    """15 steps of rows 1:3 of a 4-replica batch, stepped alone with the
    sliced noise, against those rows of the batch stepped whole: every
    draw of the unfused tail and of the fused tail (K4/K5's plain twins in
    float32) goes through the noise object. float64 to 1e-12 of the box;
    float32 to 1e-4 (reordered float32 reductions over 4 or 2 replicas)."""
    snap, ff = _dense_scene(dtype)
    methods = pt.resolve_methods(snap, tuple(
        pt.MethodSpec(kind, group, kT=KT, tau=PC.ps_to_atomic_units(0.1),
                      gamma=PC.gamma_from_tau_ps(0.1))
        for kind, group in BATHS[baths]), ff.l_typeid)
    kw = dict(dt=DT, seed=6, kT=KT)
    full = init_replica_states(snap, ff, n_replicas=4, **kw)
    part = init_replica_states(snap, ff, n_replicas=2, first_replica=1, **kw)
    want, wobs = run_replica_steps(pt.make_step_fn(
        ff, methods, fuse_integrator=fuse), full, 15)
    got, gobs = run_replica_steps(pt.make_step_fn(
        ff, methods, fuse_integrator=fuse,
        noise=StreamNoise(4, slice(1, 3))), part, 15)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    np.testing.assert_allclose(got.position.numpy(),
                               want.position[1:3].numpy(), rtol=0,
                               atol=tol * 20.0)
    for k, w in wobs.items():
        np.testing.assert_allclose(gobs[k], w[:, 1:3], rtol=tol,
                                   atol=tol * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)
    assert not np.allclose(want.position[1].numpy(),
                           want.position[2].numpy())


# ------------------------------------------------- the R x S runner
class JaxRowDraws:
    """Replica ``row``'s draws of the JAX package's batch at each host
    step, from a table made in the test process (``table[kind, i]``:
    (steps, R, ...) arrays), so that the spawned ranks need no JAX."""

    def __init__(self, table, row):
        self.table, self.row = table, row

    def _t(self, x, state):
        return torch.tensor(x[state.step, self.row],
                            dtype=state.position.dtype)

    def bussi(self, state, i, m):
        return tuple(self._t(x, state) for x in self.table["bussi", i])

    def langevin(self, state, i, m, shape):
        return self._t(self.table["langevin", i], state).reshape(shape)


XS_STEPS = 12  # tests/test_domain.py:333


def _jax_batch_on_grid(start, table):
    """A run_ranks job on R x S ranks: the batch ``start`` (JAX's leaves)
    through ``make_domain_runner(n_replicas=R)`` with the protocol of
    ``replicas_x_slabs_dryrun``, rank (r, s) drawing row r of ``table``.
    Returns NumPy: the final positions and dt, every observable."""
    import torch.distributed as dist

    R = start["position"].shape[0]
    S = dist.get_world_size() // R
    snap, ff, methods, _ = _dryrun_scene(550, 65.0, 8.0, (16, 16, 16))
    run = make_domain_runner(
        ff, methods, plan_domain(snap, ff, S), rebuild_every=5,
        adaptive=XS_ADAPTIVE,
        obs_spec=(True, generate_fibonacci_sphere(8) * 1.0), n_replicas=R,
        noise=JaxRowDraws(table, dist.get_rank() // S))
    final, obs = run(state_from_numpy(**start, dtype=torch.float64,
                                      device="cpu"), XS_STEPS)
    return dict(position=final.position.numpy(), dt=final.dt.numpy(),
                obs=obs, S=S)


@pytest.fixture(scope="module")
def jax_xs():
    """tests/test_domain.py:333 in the JAX package: 2 replicas of its
    scene (seed 11, kT, tolerance 5e-9), the adaptive step with the
    dipole and rho(k) observables under ``jax.vmap``, 12 steps; the
    batch's leaves (NumPy, for ``state_from_numpy``), the final batch,
    the observables, and each step's Bussi and Langevin draws of every
    replica's key."""
    import jax
    import jax.numpy as jnp

    from cavmd_tpu.core import add_cavity_particle, make_diatomic_system
    from cavmd_tpu.integrate import (
        ForceField,
        MethodSpec,
        make_step_fn,
        resolve_methods,
        run_steps,
    )
    from cavmd_tpu.integrate.adaptive import make_adaptive_step
    from cavmd_tpu.integrate.rng import (
        STREAM_BUSSI,
        STREAM_LANGEVIN,
        stream_key,
    )
    from cavmd_tpu.integrate.thermostats import bussi_noise
    from cavmd_tpu.observe import generate_fibonacci_sphere, make_extra_obs
    from cavmd_tpu.parallel.replicas import (
        init_replica_states as j_init_replicas,
    )
    from cavmd_tpu.parallel.replicas import make_replica_step

    snap = add_cavity_particle(make_diatomic_system(
        550, box_L=65.0, temperature_K=100.0, seed=0, dtype=np.float64),
        coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1)
    ff = ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0, r_cut=8.0,
                           pair_mode="cell", pppm_mesh=(16, 16, 16))
    methods = resolve_methods(snap, (
        MethodSpec(kind="bussi", group="molecular", kT=KT,
                   tau=PC.ps_to_atomic_units(5.0)),
        MethodSpec(kind="langevin", group="cavity", kT=KT,
                   gamma=PC.gamma_from_tau_ps(5.0))), ff.l_typeid)
    wv = generate_fibonacci_sphere(8) * 1.0
    batch = j_init_replicas(snap, ff, n_replicas=2,
                            dt=PC.fs_to_atomic_units(0.5), seed=11, kT=KT,
                            error_tolerance=5e-9)
    step = make_adaptive_step(make_step_fn(
        ff, methods, extra_obs=make_extra_obs(dipole=True, wavevectors=wv)),
        **XS_ADAPTIVE)
    final, obs = jax.jit(lambda s: run_steps(make_replica_step(step), s,
                                             XS_STEPS))(batch)

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
                for t in range(XS_STEPS)]
    table = {("bussi", 0): tuple(np.stack([d[j] for d in per_step])
                                 for j in (0, 1)),
             ("langevin", 1): np.stack([d[2] for d in per_step])}
    leaves = ("position", "image", "velocity", "mass", "charge", "typeid",
              "box_L", "forces", "dt", "time_au", "time_comp", "timestep",
              "bussi_reservoir", "bussi_instantaneous", "langevin_reservoir",
              "error_tolerance")
    start = {k: np.asarray(getattr(batch, k)) for k in leaves}
    return dict(start=start, table=table, typeid=np.asarray(snap.typeid),
                position=np.asarray(final.position),
                dt=np.asarray(final.dt),
                obs={k: np.asarray(v) for k, v in obs.items()})


def test_replicas_x_slabs_match_jax(jax_xs):
    """The 2 x 2 runner over 4 gloo ranks on JAX's batch with JAX's draws
    (rank (r, s) takes row r of the table; the protocol of
    ``replicas_x_slabs_dryrun``) against JAX's
    ``run_replica_steps`` of the adaptive step: every rank's positions
    and dt within 1e-10 (relative; positions 1e-12 absolute, as the JAX
    test holds its own runner), every observable the two
    packages share in (steps, R, ...) within 1e-8; the replicas
    decorrelated, dt moved, and no capacity overflow."""
    snap, _, _, _ = _dryrun_scene(550, 65.0, 8.0, (16, 16, 16))
    np.testing.assert_array_equal(snap.typeid.numpy(), jax_xs["typeid"])
    (ranks,) = run_ranks([(_jax_batch_on_grid, (jax_xs["start"],
                                                 jax_xs["table"]))], 4)
    want = jax_xs["obs"]
    assert not np.allclose(jax_xs["position"][0], jax_xs["position"][1])
    assert np.ptp(want["dt"]) > 0
    shared = sorted(set(want) & set(ranks[0]["obs"]))
    assert {"dipole", "rho_k_re", "rho_k_im", "error_tolerance", "dt",
            "lj", "ewald_long", "kinetic_molecular",
            "bussi_reservoir_molecular",
            "langevin_reservoir_cavity"} <= set(shared)
    for got in ranks:
        assert got["S"] == 2
        np.testing.assert_allclose(got["position"], jax_xs["position"],
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(got["dt"], jax_xs["dt"], rtol=1e-10)
        for k in shared:
            w = want[k]
            assert got["obs"][k].shape == w.shape, k
            np.testing.assert_allclose(got["obs"][k], w, rtol=1e-8,
                                       atol=1e-12, err_msg=k)
        assert not got["obs"]["domain_capacity_overflow"].any()


@pytest.fixture(scope="module")
def four_ranks():
    """dryrun_multichip(4): its three cases on 4 gloo ranks (R = 2,
    S = 2), held there to 1e-10; returns the references and every rank's
    results."""
    return dryrun_multichip(4)


def test_replicas_x_slabs_match_run_replica_steps(four_ranks):
    """The 2 x 2 runner on the port's batch: every rank returns the whole
    batch; each replica within 1e-10 of ``run_replica_steps`` on the same
    batch, dt to 1e-12, the observables (dipole, rho(k), the tolerance
    ramp, the energy audit) in (steps, R, ...) within 1e-8; the replicas
    decorrelated and dt moved."""
    assert (four_ranks["R"], four_ranks["S"]) == (2, 2)
    ref, ranks = four_ranks["replicas_x_slabs"]
    assert len(ranks) == 4 and ref["S"] == 0
    assert not np.allclose(ref["position"][0], ref["position"][1])
    assert np.ptp(ref["obs"]["dt"]) > 0
    for got in ranks:
        assert got["S"] == 2 and got["position"].shape == (2, 1101, 3)
        np.testing.assert_allclose(got["position"], ref["position"],
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(got["dt"], ref["dt"], rtol=1e-12)
        for k in ("dipole", "rho_k_re", "rho_k_im", "error_tolerance",
                  "dt", "lj", "ewald_long", "kinetic_molecular",
                  "bussi_reservoir_molecular", "langevin_reservoir_cavity"):
            assert got["obs"][k].shape[:2] == (12, 2), k
            np.testing.assert_allclose(got["obs"][k], ref["obs"][k],
                                       rtol=1e-8, atol=1e-12, err_msg=k)
        assert not got["obs"]["domain_capacity_overflow"].any()


def test_dry_run_shards_the_cli_batch_over_four_ranks(four_ranks):
    """The dry run's CLI case: ``--shard-replicas 4`` on 4 ranks exits 0
    on each and writes the one-process batch's files (held there to
    1e-10): the energy, cavity-mode, F(k,t) and dipole files and a GSD
    file of each of the 4 replicas."""
    assert four_ranks["cli_rcs"] == [0, 0, 0, 0]
    files = four_ranks["cli_files"]
    for r in range(4):
        assert {f"prod-{r}.gsd", f"prod-{r}_energy_tracker.txt",
                f"prod-{r}_cavity_mode.txt", f"prod-{r}_ref0.txt",
                f"prod-{r}_dipole_autocorr_0.txt"} <= set(files)


def test_dry_run_rows_match_the_unsharded_batch(four_ranks):
    """The dry run's third case, atom sharding by rows on the 2 x 2 mesh
    (``rows_dryrun``, the JAX dry run's GSPMD case): the reference scene
    ghost-padded to 502 rows, dense; rank (r, s) holds replica r (held
    there to 1e-10 of ``run_replica_steps``); the two atom shards of a
    replica agree bit for bit, and the replicas decorrelate."""
    ref, ranks = four_ranks["rows"]
    assert ref["N"] == 502 and ref["rows"] == (0, 2)
    assert [got["rows"] for got in ranks] == [(0, 1), (0, 1), (1, 2),
                                              (1, 2)]
    for r in (0, 2):
        assert np.array_equal(ranks[r]["position"],
                              ranks[r + 1]["position"])
        np.testing.assert_allclose(ranks[r]["position"],
                                   ref["position"][r // 2:r // 2 + 1],
                                   rtol=1e-10, atol=1e-10)
    assert not np.allclose(ref["position"][0], ref["position"][1])
    assert ref["obs"]["lj"].shape == (20, 2)


@pytest.fixture(scope="module")
def cell_scene():
    return _dryrun_scene(250, 46.0, 8.0, (16, 16, 16))


def test_grid_and_plan_mismatches_raise(cell_scene):
    """As the JAX runner raises for its mesh: a slab communicator of
    another size than the plan's S, a replica communicator of another
    size than n_replicas, a batch that R ranks cannot split evenly
    (checked before any collective), and R > 1 with no communicator
    outside a process group."""
    snap, ff, methods, kT = cell_scene
    plan1, plan2 = plan_domain(snap, ff, 1), plan_domain(snap, ff, 2)
    with pytest.raises(ValueError, match="the plan 2 slabs"):
        make_domain_runner(ff, methods, plan2, Communicator(), n_replicas=2,
                           replica_comm=Communicator())
    with pytest.raises(ValueError, match="n_replicas=2"):
        make_domain_runner(ff, methods, plan1, Communicator(), n_replicas=2,
                           replica_comm=Communicator())
    with pytest.raises(RuntimeError, match="not initialised"):
        make_domain_runner(ff, methods, plan1, n_replicas=2)
    batch = init_replica_states(snap, ff, n_replicas=3, dt=DT, seed=1)
    run = make_domain_runner(ff, methods, plan1, Communicator(),
                             n_replicas=2, replica_comm=Communicator(0, 2))
    with pytest.raises(ValueError, match="a multiple of 2 replicas"):
        run(batch, 2)


def test_one_replica_batch_at_r1_matches_the_one_replica_runner(cell_scene):
    """At R = 1 a batch of one replica goes through the replica path
    (squeezed, run, stacked) and equals the one-replica runner on that
    replica, observables gaining their replica axis."""
    snap, ff, methods, kT = cell_scene
    batch = init_replica_states(snap, ff, n_replicas=1, dt=DT, seed=1,
                                kT=kT)
    run = make_domain_runner(ff, methods, plan_domain(snap, ff, 1),
                             rebuild_every=3)
    got, gobs = run(_fresh(batch), 4)
    want, wobs = run(_fresh(replica_rows(batch, 0)), 4)
    assert torch.equal(got.position[0], want.position)
    assert got.batch_shape == (1,) and got.step == want.step == 4
    for k, w in wobs.items():
        np.testing.assert_array_equal(gobs[k][:, 0], w, err_msg=k)
