"""Zcol mode on the row path (atom sharding by rows,
``cavmd_tpu_torch/parallel/shard.py``), float64 on the CPU:

- the plain twin of the zcol pass (``ops/zcol_kernels.py``) with a row
  range: the row blocks of a partition summed equal the full twin, each
  zero outside its range, for one replica and for a batch of 2;
- a replica batch of the zcol scene through ``make_sharded_runner`` on a
  1 x 2 mesh of thread ranks against ``run_replica_steps`` unsharded;
- the overflow retry in lockstep: a zcol window planned too narrow on 2
  thread ranks through ``Simulation(shard_atoms=2)`` flags on every rank,
  grows the window and the capacity alike and matches the run planned
  wide.

The row split against JAX and the thread-rank blocks of one step are in
tests/test_torch_shard.py; the card's kernel is held in
tests/test_torch_cuda.py.
"""

import logging

import numpy as np
import pytest
import torch

import cavmd_tpu_torch as pt
from cavmd_tpu_torch.core import PhysicalConstants as PC
from cavmd_tpu_torch.core.system import reference_box_for
from cavmd_tpu_torch.integrate import make_step_fn
from cavmd_tpu_torch.ops import zcol_kernels as zk
from cavmd_tpu_torch.parallel import (
    Communicator,
    init_replica_states,
    make_sharded_runner,
    pad_snapshot_to,
    run_replica_steps,
    shard_state,
)
from cavmd_tpu_torch.parallel.mesh import Mesh
from thread_ranks import run_threads

KT = PC.kT_from_kelvin(100.0)
TAU = PC.ps_to_atomic_units(5.0)
GAMMA = PC.gamma_from_tau_ps(5.0)
DT = PC.fs_to_atomic_units(0.5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: its tensors are small, and the
    suite runs six workers on the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _snapshot(n_mol, box_L, seed):
    return pt.add_cavity_particle(pt.make_diatomic_system(
        n_mol, box_L=box_L, temperature_K=100.0, seed=seed,
        dtype=torch.float64, device="cpu"), coupling=1e-3, freq_cm1=2000.0,
        temperature_K=100.0, seed=seed + 1)


def _zcol_scene():
    """tests/test_torch_shard.py's cell scene (60 diatomics in 48 bohr,
    r_cut 12, 128 rows after ghost padding) in zcol mode: 3 x 3 columns,
    Bussi on the molecules and Langevin on the photon."""
    snap, _ = pad_snapshot_to(_snapshot(60, 48.0, 61), 8)
    ff = pt.ForceField.create(snap, coupling=1e-3, pair_mode="zcol",
                              r_cut=12.0, pppm_mesh=(16, 16, 16))
    methods = pt.resolve_methods(snap, (
        pt.MethodSpec("bussi", "molecular", kT=KT, tau=TAU),
        pt.MethodSpec("langevin", "cavity", kT=KT, gamma=GAMMA)),
        ff.l_typeid)
    return snap, ff, methods


def _pair_args(ff, position, box_L, clist, snap):
    return (position, box_L, clist, ff.cell_cfg, snap.typeid, snap.charge,
            ff.lj_eps, ff.lj_sig2, ff.lj_rcut2, ff.lj_vshift,
            ff.cell_exclusions, ff.kappa_value, ff.zcol_W)


@pytest.mark.parametrize("batch", [None, 2])
def test_twin_row_blocks_sum_to_the_full_twin(batch):
    """Three uneven row blocks of the plain twin: each block's forces are
    zero outside its rows and the full twin's bits on them, the blocks'
    forces and energy shares summed equal the full twin's to 1e-12, and
    the window flag is the full twin's.
    With ``batch`` 2 the positions are two jittered replicas over a
    batched column list."""
    snap, ff, _ = _zcol_scene()
    pos, n = snap.position, snap.N
    if batch:
        rng = np.random.default_rng(5)
        pos = torch.stack([pos + torch.as_tensor(
            rng.normal(scale=0.3, size=(n, 3))) for _ in range(batch)])
        pos = torch.remainder(pos, snap.box_L)
    clist = ff.build_cells(pos, snap.box_L)
    assert not bool(clist.overflow.any())
    args = _pair_args(ff, pos, snap.box_L, clist, snap)
    f0, lj0, ew0, flag0 = zk.zcol_pair_force_plain(*args)
    cuts = (0, 37, 90, n)
    f_sum, lj_sum, ew_sum = torch.zeros_like(f0), 0.0, 0.0
    for r0, r1 in zip(cuts[:-1], cuts[1:]):
        f, lj, ew, flag = zk.zcol_pair_force(*args, rows=(r0, r1 - r0))
        outside = torch.ones(n, dtype=torch.bool)
        outside[r0:r1] = False
        assert torch.all(f[..., outside, :] == 0)
        assert torch.equal(f[..., r0:r1, :], f0[..., r0:r1, :])
        assert torch.equal(flag, flag0)
        f_sum, lj_sum, ew_sum = f_sum + f, lj_sum + lj, ew_sum + ew
    scale = float(f0.abs().max())
    assert float((f_sum - f0).abs().max()) <= 1e-12 * scale
    for got, want in ((lj_sum, lj0), (ew_sum, ew0)):
        assert float((got - want).abs().max()) <= 1e-12 * float(
            want.abs().max())
    with pytest.raises(ValueError, match="outside"):
        zk.zcol_pair_force(*args, rows=(n - 4, 8))


def test_batch_on_a_row_split_matches_run_replica_steps():
    """Two thermalized replicas of the zcol scene through
    ``make_sharded_runner(batched=True)`` on a 1 x 2 mesh of thread ranks,
    8 steps with Bussi + Langevin: each rank's batch within 1e-12 of
    ``run_replica_steps`` on the whole batch, unsharded, and the ranks'
    states the same bits."""
    snap, ff, methods = _zcol_scene()
    state = init_replica_states(snap, ff, n_replicas=2, dt=DT, seed=3, kT=KT)
    ref, ref_obs = run_replica_steps(make_step_fn(ff, methods),
                                     state.replace(generators={}), 8)

    def rank(comm):
        mesh = Mesh(Communicator(), comm)
        step = make_step_fn(ff, methods)
        run = make_sharded_runner(step, mesh, state, batched=True)
        return run(shard_state(state.replace(generators={}), mesh,
                               batched=True), 8)

    ranks = run_threads(2, rank)
    assert ref.cell_list.bucket_idx.dim() == 3  # a batched column list
    for st, obs in ranks:
        assert torch.equal(st.position, ranks[0][0].position)
        for k in ("position", "velocity", "forces"):
            a, b = getattr(st, k), getattr(ref, k)
            assert (a - b).abs().max() <= 1e-12 * b.abs().max(), k
        for k in ref_obs:
            want = np.asarray(ref_obs[k])
            np.testing.assert_allclose(
                np.asarray(obs[k]), want, rtol=0,
                atol=1e-12 * max(np.abs(want).max(), 1.0), err_msg=k)
    assert not np.allclose(ref.position.numpy(), state.position.numpy())


class _Keep:
    def __init__(self):
        self.chunks = []

    def consume(self, obs):
        self.chunks.append(obs)


def _retry_run(window, comm=None):
    """tests/test_torch_zcol.py's retry scene (500 diatomics at reference
    density, seed 3, r_cut 12, PPPM 8^3), ghost-padded to 1002 rows, in
    zcol mode with the visit window ``window`` (None: as planned), 6 steps
    of 0.25 fs in chunks of 3: over ``comm``'s 2 ranks, or unsharded.
    Returns the Simulation and its chunks' observables."""
    snap, _ = pad_snapshot_to(_snapshot(500, reference_box_for(500), 3), 2)
    ff = pt.ForceField.create(snap, coupling=1e-3, pair_mode="zcol",
                              r_cut=12.0, pppm_mesh=(8, 8, 8))
    if window is not None:
        ff.zcol_W = window
    methods = (pt.MethodSpec("bussi", "molecular", kT=KT, tau=TAU),
               pt.MethodSpec("langevin", "cavity", kT=KT, gamma=GAMMA))
    sim = pt.Simulation(snap, ff, methods, dt=PC.fs_to_atomic_units(0.25),
                        seed=4, chunk_size=3,
                        shard_atoms=0 if comm is None else 2, comm=comm)
    keep = _Keep()
    sim.trackers.append(keep)
    sim.run(n_steps=6)
    return sim, keep.chunks


def test_window_overflow_retry_runs_in_lockstep_on_the_row_path(caplog):
    """A zcol ``Simulation(shard_atoms=2)`` on 2 thread ranks started at
    W = 1 takes the row path (with the facade's warning), flags the
    window overflow on both ranks (the hull is built replicated), grows
    the capacity and the window alike (1 -> 3 -> 5) and reruns the chunk;
    positions, velocities, forces and every observable equal the
    unsharded run planned with the default window to 1e-12, and the two
    ranks' states the same bits."""
    wide, wide_obs = _retry_run(None)
    with caplog.at_level(logging.WARNING, logger="cavmd_tpu_torch.simulation"):
        ranks = run_threads(2, lambda comm: _retry_run(1, comm))
    assert "falling back to atom sharding by rows" in caplog.text
    assert "pair_mode='cell'" in caplog.text
    for sim, obs in ranks:
        assert sim.ff.row_comm is not None and sim._domain_plan is None
        assert sim.ff.zcol_W == 5 and sim.ff.cell_cfg.cap == 512
        assert torch.equal(sim.state.position, ranks[0][0].state.position)
        for k in ("position", "velocity", "forces"):
            a, b = getattr(sim.state, k), getattr(wide.state, k)
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-12, err_msg=k)
        assert len(obs) == len(wide_obs) == 2
        for a, b in zip(obs, wide_obs):
            assert not a["cell_overflow"].any()
            assert not b["cell_overflow"].any()
            for k in b:
                np.testing.assert_allclose(
                    a[k], b[k], rtol=0,
                    atol=1e-12 * max(np.abs(b[k]).max(), 1.0), err_msg=k)
    assert wide.ff.zcol_W > 1 and wide.ff.cell_cfg.cap == 128
