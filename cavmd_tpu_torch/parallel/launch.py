"""Run an S-rank program on one host, and the slab pipeline's dry run.

``run_ranks`` starts S processes (``spawn``), joins them in a gloo process
group through a file in a fresh temporary directory (no network port), and
runs a list of jobs ``(fn, args)`` in order on every rank; it returns each
job's result on each rank. A job is a module-level function of an
importable module (the spawned ranks import it): for example
``drivers.advanced_run.main`` with ``--shard-atoms S``, or
``slab_dryrun``. Results must pickle; keep them NumPy.

``slab_dryrun`` runs a seeded diatomic scene through ``Simulation``: with
``shard_atoms`` equal to the world size under a process group, and
unsharded without one, so the same call gives both sides of a
comparison. It is the CPU dry run of an S-slab program::

    from cavmd_tpu_torch.parallel.launch import run_ranks, slab_dryrun
    runs = run_ranks([(slab_dryrun, {})], 2)

``replicas_x_slabs_dryrun`` runs a batch of R replicas through
``make_domain_runner(n_replicas=R)`` on R x S ranks, and without a
process group through ``run_replica_steps`` (its reference). The
multi-process dry run (``cavmd_tpu_torch/dryrun.py``) holds it against
its reference. ``rows_dryrun`` does the same for atom sharding by rows
(``parallel/shard.py``): R replicas of the ghost-padded reference scene
in dense mode through ``make_sharded_runner`` on an R x S mesh, and
without a process group through ``run_replica_steps``.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time


def _rank_main(rank, world_size, init_file, out_dir, jobs, timeout):
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # S ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        results = [fn(**args) if isinstance(args, dict) else fn(*args)
                   for fn, args in jobs]
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def run_ranks(jobs, world_size: int, timeout: float = 600.0):
    """Run ``jobs`` (a list of ``(fn, args)``, ``args`` a tuple or a dict
    of keywords) on ``world_size`` local gloo ranks, one torch thread
    each; returns ``results[job][rank]``. A failing rank raises here. The
    ranks get ``timeout`` seconds in all (and their collectives as much
    each): past it they are killed and ``TimeoutError`` is raised, so a
    rank that hangs cannot hold the caller forever."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="cavmd_ranks_") as tmp:
        init_file = os.path.join(tmp, "pg_init")
        ctx = mp.start_processes(
            _rank_main, args=(world_size, init_file, tmp, list(jobs),
                              timeout),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for proc in ctx.processes:
                    if proc.is_alive():
                        proc.kill()
                    proc.join()
                raise TimeoutError(
                    f"run_ranks: {world_size} ranks still running after "
                    f"{timeout} s")
        per_rank = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                per_rank.append(pickle.load(f))
    return [[per_rank[r][j] for r in range(world_size)]
            for j in range(len(per_rank[0]))]


def slab_dryrun(*, cap=None, error_tolerance=0.0, wavevectors=None,
                bath="bussi"):
    """The tests/test_domain.py scene (550 O2/N2 diatomics + the photon in
    a 65-bohr box, float64, cell mode with r_cut 8 and PPPM 16^3, Bussi
    100 K on the molecules and Langevin on the photon, thermalised with
    seed 3, dt 0.5 fs) through ``Simulation.run`` for 12 steps in chunks
    of 6 (a rebuild at the start of each): on ``shard_atoms`` = the world
    size when a process group is up, unsharded otherwise. ``cap``
    cripples the slab plan's bucket capacity (the retry must grow it);
    ``error_tolerance`` > 0 turns on the adaptive dt (period 2);
    ``wavevectors`` adds the dipole and rho(k) observables; ``bath``
    'mttk' or 'berendsen' replaces the molecules' Bussi bath (tau
    0.05 ps). Returns NumPy: the final position, velocity, image and MTTK
    (xi, eta), every observable over the run, and the slab plan's final
    capacity and cadence (None unsharded)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import cavmd_tpu_torch as pt
    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.observe import make_extra_obs

    S = dist.get_world_size() if dist.is_initialized() else 0
    snap = pt.make_diatomic_system(550, box_L=65.0, temperature_K=100.0,
                                   seed=0, dtype=torch.float64, device="cpu")
    snap = pt.add_cavity_particle(snap, coupling=1e-3, freq_cm1=2000.0,
                                  temperature_K=100.0, seed=1)
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                              r_cut=8.0, pair_mode="cell",
                              pppm_mesh=(16, 16, 16))
    kT = PC.kT_from_kelvin(100.0)
    methods = (pt.MethodSpec(bath, "molecular", kT=kT,
                             tau=PC.ps_to_atomic_units(
                                 5.0 if bath == "bussi" else 0.05)),
               pt.MethodSpec("langevin", "cavity", kT=kT,
                             gamma=PC.gamma_from_tau_ps(5.0)))
    extra = (None if wavevectors is None
             else make_extra_obs(dipole=True, wavevectors=wavevectors))
    sim = pt.Simulation(snap, ff, methods, dt=PC.fs_to_atomic_units(0.5),
                        seed=3, chunk_size=6,
                        error_tolerance=error_tolerance, adaptive_period=2,
                        extra_obs=extra, shard_atoms=S)
    if cap is not None and sim._domain_plan is not None:
        sim._domain_plan = sim._domain_plan._replace(cap=cap)
        sim._build_step()
    sim.thermalize(kT)

    chunks = []

    class Keep:
        def consume(self, obs):
            chunks.append(obs)

    sim.trackers.append(Keep())
    sim.run(n_steps=12)
    plan = sim._domain_plan
    st = sim.state
    return dict(
        position=st.position.numpy(), velocity=st.velocity.numpy(),
        image=st.image.numpy(), mttk_xi=st.mttk_xi.numpy(),
        mttk_eta=st.mttk_eta.numpy(),
        obs={k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]},
        cap=None if plan is None else plan.cap,
        rebuild_every=None if plan is None else sim._domain_rebuild_every)


def _dryrun_scene(n_molecules, box_L, r_cut, pppm):
    """The seeded float64 diatomic scene of the dry runs (100 K, the
    photon at 2000 cm^-1 and coupling 1e-3, cell mode) with Bussi 100 K
    tau 5 ps on the molecules and Langevin tau 5 ps on the photon:
    (snapshot, force field, resolved methods, kT)."""
    import torch

    import cavmd_tpu_torch as pt
    from cavmd_tpu_torch.core import PhysicalConstants as PC

    snap = pt.make_diatomic_system(n_molecules, box_L=box_L,
                                   temperature_K=100.0, seed=0,
                                   dtype=torch.float64, device="cpu")
    snap = pt.add_cavity_particle(snap, coupling=1e-3, freq_cm1=2000.0,
                                  temperature_K=100.0, seed=1)
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                              r_cut=r_cut, pair_mode="cell",
                              pppm_mesh=pppm)
    kT = PC.kT_from_kelvin(100.0)
    methods = pt.resolve_methods(snap, (
        pt.MethodSpec("bussi", "molecular", kT=kT,
                      tau=PC.ps_to_atomic_units(5.0)),
        pt.MethodSpec("langevin", "cavity", kT=kT,
                      gamma=PC.gamma_from_tau_ps(5.0))), ff.l_typeid)
    return snap, ff, methods, kT


def _host_state(st):
    return {k: getattr(st, k).detach().cpu().numpy()
            for k in ("position", "velocity", "image", "dt")}


# the protocol of tests/test_domain.py:333 (test_domain_replicas_x_slabs)
XS_ADAPTIVE = dict(error_tolerance=5e-6, initial_fraction=1e-3,
                   time_constant_ps=50.0, period=2)


def replicas_x_slabs_dryrun(*, n_replicas: int = 2, n_steps: int = 12):
    """The JAX test's replicas x slabs protocol on the slab dry run's
    scene (550 diatomics + photon, 65-bohr box, r_cut 8, 16^3 PPPM,
    float64): ``n_replicas`` replicas thermalized at seed 11 (dt 0.5 fs,
    initial tolerance 5e-9), adaptive dt (target 5e-6, period 2) and the
    dipole and rho(k) (8 Fibonacci wavevectors of |k| 1) observables,
    ``n_steps`` steps rebuilt every 5. Under a process group of R x S
    ranks it runs ``make_domain_runner(n_replicas=R)`` (S = world / R);
    without one, ``run_replica_steps`` of the adaptive step on the batch
    (the reference). Returns NumPy: the final batch's position, velocity,
    image and dt, every observable (steps, R, ...), and S (0 for the
    reference)."""
    import torch.distributed as dist

    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.integrate import make_step_fn
    from cavmd_tpu_torch.integrate.adaptive import make_adaptive_step
    from cavmd_tpu_torch.observe import (
        generate_fibonacci_sphere,
        make_extra_obs,
    )
    from cavmd_tpu_torch.parallel.domain import (
        make_domain_runner,
        plan_domain,
    )
    from cavmd_tpu_torch.parallel.replicas import (
        init_replica_states,
        run_replica_steps,
    )

    snap, ff, methods, kT = _dryrun_scene(550, 65.0, 8.0, (16, 16, 16))
    wv = generate_fibonacci_sphere(8) * 1.0
    batch = init_replica_states(snap, ff, n_replicas=n_replicas,
                                dt=PC.fs_to_atomic_units(0.5), seed=11,
                                kT=kT, error_tolerance=5e-9)
    S = dist.get_world_size() // n_replicas if dist.is_initialized() else 0
    if S:
        run = make_domain_runner(ff, methods, plan_domain(snap, ff, S),
                                 rebuild_every=5, adaptive=XS_ADAPTIVE,
                                 obs_spec=(True, wv), n_replicas=n_replicas)
        final, obs = run(batch, n_steps)
    else:
        step = make_adaptive_step(make_step_fn(
            ff, methods, extra_obs=make_extra_obs(dipole=True,
                                                  wavevectors=wv)),
            **XS_ADAPTIVE)
        final, obs = run_replica_steps(step, batch, n_steps)
    return dict(_host_state(final), obs=obs, S=S)


def rows_dryrun(*, n_replicas: int = 2, n_shards: int = 2,
                n_steps: int = 20):
    """The JAX dry run's GSPMD case on the reference scene: 250 O2/N2
    diatomics in a 46-bohr box (seed 0) + the photon, ghost-padded to a
    multiple of ``n_shards``, the default force field (dense, r_cut 15,
    PPPM 32^3 order 6), float64, Bussi 100 K on the molecules and Langevin
    on the photon, ``n_replicas`` replicas thermalized at seed 0, dt 0.25
    fs, ``n_steps`` steps. Under a process group of R x S ranks the batch
    runs through ``make_sharded_runner(..., batched=True)`` on
    ``make_mesh(R, S)`` (rank (r, s): replica rows r B/R .. (r+1) B/R,
    atom rows s N/S ..); without one, ``run_replica_steps`` on the whole
    batch (the reference). Returns NumPy: the rank's (or the whole
    batch's) final position, velocity, image and dt, every observable,
    and its replica rows as (first, stop)."""
    import torch
    import torch.distributed as dist

    import cavmd_tpu_torch as pt
    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.parallel import (
        init_replica_states,
        make_mesh,
        make_sharded_runner,
        pad_snapshot_to,
        run_replica_steps,
        shard_state,
    )

    snap = pt.make_diatomic_system(250, box_L=46.0, temperature_K=100.0,
                                   seed=0, dtype=torch.float64, device="cpu")
    snap = pt.add_cavity_particle(snap, coupling=1e-3, freq_cm1=2000.0,
                                  temperature_K=100.0, seed=1)
    snap, _ = pad_snapshot_to(snap, n_shards)
    ff = pt.ForceField.create(snap, coupling=1e-3)
    kT = PC.kT_from_kelvin(100.0)
    methods = pt.resolve_methods(snap, (
        pt.MethodSpec("bussi", "molecular", kT=kT,
                      tau=PC.ps_to_atomic_units(5.0)),
        pt.MethodSpec("langevin", "cavity", kT=kT,
                      gamma=PC.gamma_from_tau_ps(5.0))), ff.l_typeid)
    batch = init_replica_states(snap, ff, n_replicas=n_replicas,
                                dt=PC.fs_to_atomic_units(0.25), seed=0,
                                kT=kT)
    step = pt.make_step_fn(ff, methods)
    rows = (0, n_replicas)
    if dist.is_initialized():
        mesh = make_mesh(n_replicas, n_shards)
        run = make_sharded_runner(step, mesh, batch, batched=True)
        r = mesh.replica.rank
        rows = (r * n_replicas // mesh.shape[0],
                (r + 1) * n_replicas // mesh.shape[0])
        final, obs = run(shard_state(batch, mesh, batched=True), n_steps)
    else:
        final, obs = run_replica_steps(step, batch, n_steps)
    return dict(_host_state(final), obs=obs, rows=rows, N=snap.N)
